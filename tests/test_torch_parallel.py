"""Torch port vs the JAX package: the data axis of the mesh (CPU, gloo).

`parallel/mesh.py` at world size 1 and in a spawned two-rank gloo group
(tests/torch_dist_worker.py through `tools/dist_probe.launch`, each spawn
with its own timeout); the loader's rank shards against JAX's
`DataLoader._indices`; the two-rank `BatchNorm` against flax's BatchNorm on
the concatenated batch. Bars, each with its reason:
  - loader shards, mesh values, object collectives: equal;
  - BN f32: output, input gradient and running stats 2e-6 absolute, the
    weight gradients 2e-5 of their largest (the per-channel sums add in
    another order than XLA's, and the weight gradients sum over both ranks'
    rows before the group's); bf16 (amp: the map and the weights bf16, as
    flax takes them): output and gradients 1 bf16 ulp of their largest
    (8e-3), the running stats as f32's (the statistics stay f32).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402

from dedark_yolo_tpu.data.loader import DataLoader as JaxLoader  # noqa: E402
from dedark_yolo_tpu.nn.layers import BN_EPS, BN_MOMENTUM  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.data.loader import DataLoader  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.parallel import (  # noqa: E402
    init_from_env, make_mesh, replicate, shard_batch)
from dedark_yolo_tpu_torch.parallel import mesh as M  # noqa: E402
from dedark_yolo_tpu_torch.tools.dist_probe import launch  # noqa: E402

from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
TIMEOUT = 120


def run_ranks(scenario, inp, out, n=2):
    res = launch(n, [scenario, inp, out], timeout=TIMEOUT, target=(WORKER,))
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-3000:]}"


# ------------------------------------------------------------- world 1
def test_mesh_of_one_rank_runs_no_collective():
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world, mesh.shape,
            mesh.axis_names) == (None, 0, 1, (1,), ("data",))
    assert mesh.is_main and M.mesh_group(mesh) is None
    assert make_mesh(shape=[1], axes=["data"], device="cpu").shape == (1,)
    batch = {"img": np.ones((2, 4, 4, 3), np.uint8),
             "cls": np.zeros((2, 5), np.float32)}
    dev = shard_batch(mesh, batch)
    assert dev["img"].dtype == torch.uint8 and dev["img"].shape == (2, 4, 4, 3)
    assert torch.equal(dev["cls"], torch.from_numpy(batch["cls"]))
    w = {"a": torch.arange(3.0)}
    assert replicate(mesh, w) is w and torch.equal(w["a"], torch.arange(3.0))
    t = torch.tensor(2.5)
    assert M.global_sum(None, t) is t
    assert M.global_sum(None, t, 4) == (t, 4)
    assert M.all_reduce_sum([t], None) == [t]
    assert M.broadcast_object(mesh, "x") == "x"
    assert M.gather_objects(mesh, 1) == [1]
    assert M.rank_rows(5, mesh) == (0, 5)
    M.barrier(mesh)


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="does not match the world"):
        make_mesh(shape=(2,), device="cpu")
    # data x spatial (A12i-c): at one rank, (1, sp) is a local mesh, and a
    # data axis of more ranks than the run has names the launch it needs
    m = make_mesh(shape=(1, 1), axes=("data", "spatial"), device="cpu")
    assert (m.group, m.world, m.shape, m.spatial, m.devices) == (
        None, 1, (1, 1), 1, (torch.device("cpu"),))
    tr = DetectionTrainer(
        {"batch": 2, "mesh_axes": ["data", "spatial"], "mesh_shape": [1, 1]},
        model=DetectionModel(model_yaml_load(TINY), nc=3), device="cpu")
    tr._setup_mesh()
    assert tr.mesh.shape == (1, 1) and tr.val_mesh is None
    with pytest.raises(ValueError, match="--nproc_per_node 2"):
        make_mesh(shape=(2, 1), axes=("data", "spatial"), device="cpu")
    with pytest.raises(ValueError, match="takes a shape"):
        make_mesh(axes=("data", "spatial"), device="cpu")
    with pytest.raises(ValueError, match="'data'"):
        make_mesh(axes=("model",), device="cpu")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        init_from_env(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR"):
        init_from_env(device="cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="has no device cuda:3"):
            init_from_env()
    assert not torch.distributed.is_initialized()


def test_local_mesh():
    """A mesh over this process's devices (make_mesh(devices=...), JAX's
    form): its axes and shapes, repeated devices, the refusals."""
    m = make_mesh(devices=["cpu", "cpu"])
    assert (m.group, m.world, m.size, m.axis_names, m.shape, m.device,
            m.devices) == (None, 1, 2, ("data",), (2,), torch.device("cpu"),
                           (torch.device("cpu"),) * 2)
    assert M.mesh_group(m) is None
    m = make_mesh(devices=["cpu"] * 4, shape=(2, 2), axes=("data", "spatial"))
    assert (m.size, m.shape, m.axis_names) == (4, (2, 2), ("data", "spatial"))
    assert make_mesh(devices=["cpu"], axes=("spatial",)).size == 1
    with pytest.raises(ValueError, match="need a shape"):
        make_mesh(devices=["cpu"] * 2, axes=("data", "spatial"))
    with pytest.raises(ValueError, match="does not match 3 device"):
        make_mesh(devices=["cpu"] * 3, shape=(2, 2), axes=("data", "spatial"))
    with pytest.raises(ValueError, match="local mesh takes"):
        make_mesh(devices=["cpu"], axes=("model",))
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(devices=[])
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices=["cuda:0", "cuda:0"])
    # a group mesh's rank tools refuse a mesh of several local devices
    with pytest.raises(ValueError, match="group mesh"):
        shard_batch(make_mesh(devices=["cpu"] * 2), {"img": np.ones(2)})
    with pytest.raises(ValueError, match="group mesh"):
        replicate(make_mesh(devices=["cpu"] * 2), [torch.ones(1)])


# ------------------------------------------------------------ two ranks
def test_mesh_two_ranks(tmp_path):
    out = str(tmp_path / "mesh")
    run_ranks("mesh", "-", out)
    got = [json.loads(Path(f"{out}_rank{r}.json").read_text())
           for r in range(2)]
    for r, g in enumerate(got):
        assert (g["rank"], g["world"], g["device"], g["axis_names"],
                g["shape"]) == (r, 2, "cpu", ["data"], [2])
        assert np.all(np.asarray(g["img"]) == r)           # its own rows
        assert g["cls"] == [10.0 * r, 10.0 * r + 1]
        assert g["w"] == [[1.0, 1.0]] * 3                    # rank 0's
        assert g["n"] == [0, 1, 2, 3]
        assert g["sums"] == [[3.0, 3.0, 3.0], [1]]
        assert (g["tss"], g["b"]) == (4.5, 4.0)
        assert g["broadcast"] == "from 0"
        assert g["rows"] == [[2 * r, 2 * r + 2], [0, 5] if r == 0 else
                             [0, 0], [0, 1] if r == 0 else [0, 0]]
    assert got[0]["gathered"] == [{"rank": 0}, {"rank": 1}]
    assert got[1]["gathered"] is None


# --------------------------------------------------------- loader shards
class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n", [7, 8])
def test_loader_shards_equal_jax(seed, shuffle, n):
    """Each rank's indices: the epoch's shuffle, the wrap-pad to equal
    shards, then every second index from the rank (JAX
    data/loader.py:119-139)."""
    ds = _Items(n)
    tf = lambda d, i, rng: i
    seen = []
    for r in range(2):
        for epoch in (0, 1):
            mine = DataLoader(ds, tf, 2, shuffle=shuffle, seed=seed,
                              process_index=r, process_count=2)
            theirs = JaxLoader(ds, tf, 2, shuffle=shuffle, seed=seed,
                               process_index=r, process_count=2)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert mine._indices() == theirs._indices()
            assert len(mine) == len(theirs) == (-(-n // 2)) // 2
            if epoch == 0:
                seen += mine._indices()
    assert sorted(set(seen)) == list(range(n))


# -------------------------------------------------------------- BatchNorm
def _flax_bn(x_nchw, w, b, rm, rv, g, dtype):
    x = jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1))).astype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM,
                       epsilon=BN_EPS, param_dtype=jnp.float32)
    params = {"scale": jnp.asarray(w).astype(dtype),
              "bias": jnp.asarray(b).astype(dtype)}
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

    def f(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, vjp_fn, new = jax.vjp(f, x, params, has_aux=True)
    gy = jnp.asarray(np.transpose(g, (0, 2, 3, 1))).astype(y.dtype)
    dx, dp = vjp_fn(gy)
    nchw = lambda a: np.transpose(np.asarray(a.astype(jnp.float32)),
                                  (0, 3, 1, 2))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return {"y": nchw(y), "dx": nchw(dx), "dw": f32(dp["scale"]),
            "db": f32(dp["bias"]), "rm": np.asarray(new["mean"]),
            "rv": np.asarray(new["var"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_two_ranks_equals_flax_on_the_whole_batch(dtype, tmp_path):
    rng = np.random.default_rng(1)
    c = 5
    inp = {"x": rng.normal(0.3, 2.0, (4, c, 6, 6)).astype(np.float32),
           "g": rng.normal(0, 1.0, (4, c, 6, 6)).astype(np.float32),
           "w": rng.uniform(0.5, 1.5, c).astype(np.float32),
           "b": rng.normal(0, 0.2, c).astype(np.float32),
           "rm": rng.normal(0, 0.1, c).astype(np.float32),
           "rv": rng.uniform(0.5, 1.5, c).astype(np.float32),
           "dtype": np.asarray(dtype)}
    if dtype == "bfloat16":     # inputs exact in bf16 on both sides
        for k in ("x", "w", "b"):
            inp[k] = torch.from_numpy(inp[k]).to(torch.bfloat16).float().numpy()
    np.savez(tmp_path / "bn.npz", **inp)
    out = str(tmp_path / "bn")
    run_ranks("bn", str(tmp_path / "bn.npz"), out)
    r0, r1 = (np.load(f"{out}_rank{r}.npz") for r in range(2))
    want = _flax_bn(inp["x"], inp["w"], inp["b"], inp["rm"], inp["rv"],
                    inp["g"], jnp.bfloat16 if dtype == "bfloat16"
                    else jnp.float32)
    for k in ("y", "dx"):
        got = np.concatenate([r0[k], r1[k]])
        tol = (8e-3 * float(np.abs(want[k]).max()) if dtype == "bfloat16"
               else 2e-6 * max(1.0, float(np.abs(want[k]).max())))
        np.testing.assert_allclose(got, want[k], rtol=0, atol=tol, err_msg=k)
    for k in ("dw", "db"):       # each rank's share of the weight gradient
        got = r0[k] + r1[k]
        rel = 8e-3 if dtype == "bfloat16" else 2e-5
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=rel * float(np.abs(want[k]).max()),
                                   err_msg=k)
    for k in ("rm", "rv"):       # moved once, with the global moments
        np.testing.assert_array_equal(r0[k], r1[k])
        np.testing.assert_allclose(r0[k], want[k], rtol=0, atol=2e-6,
                                   err_msg=k)
