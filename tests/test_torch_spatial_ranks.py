"""Torch port vs the JAX package: a 'spatial' axis across ranks (CPU).

`make_mesh(shape=(dp, sp), axes=("data", "spatial"))` in a group of dp * sp
gloo ranks, one device a rank (`parallel/mesh.py::rank_spatial_mesh`: rank r
at data index r // sp, spatial index r % sp), spawned through
`tools/dist_probe.launch` (a short run and group timeout each, so a
collective that does not match fails a test instead of hanging the suite).
The tiny model at imgsz 64, JAX's randomized trees and
tests/test_torch_dist_step.py's global batches, two threads pinned:
  - two ranks, mesh (1, 2): one accumulation window (global batch
    indices 37 and 38) against JAX's (1, 2) step at
    tests/test_torch_dist_step.py's bars, and against the port's local
    (1, 2) window (both slabs in one process): within 1e-6 of each norm,
    and bit-equal;
  - four ranks, mesh (2, 2): loss items, totals and BN stats against
    JAX's (2, 2) step (its gradients are ROADMAP C19's);
  - remat=4 against remat=-1 on a local (1, 2) mesh and over the two
    ranks: loss items and BN stats equal, gradients within 1e-6 of each
    norm (ROADMAP A12j-b);
  - `spatial_infer` over the two ranks against JAX's `spatial_infer` on
    two virtual host devices and the port's over a local mesh;
  - the exchanges themselves (tests/torch_dist_worker.py's `ranks`): a
    conv, a max pool whose halo reaches past a one-row slab, reductions
    over H x W and a join, against the whole map.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from dedark_yolo_tpu.parallel import spatial_infer as jax_spatial_infer  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.tools.dist_probe import launch, save_batches  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from test_torch_dist_step import _global_batches  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_spatial_train import (  # noqa: E402
    COMMON, IMGSZ, NB, PER, RANKS, SP, STEPS, TINY, _jax_forward,
    _jax_window, _rank_window, _window, assert_window, local_mesh)
from test_torch_train_slice import close  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

TIMEOUT, GROUP_TIMEOUT = 180, 120
REMAT, INFER_HW = 4, 128


@pytest.fixture(scope="module")
def spanning_runs(tmp_path_factory):
    """The port's spawned runs (in a thread, one launch after the other:
    (1, 2) on two ranks, its window again at remat=4, then spatial_infer;
    (2, 2) on four ranks) and JAX's (1, 2) window, (2, 2) forward and
    spatial_infer on two devices, from the same trees and batches."""
    tmp = tmp_path_factory.mktemp("spatial_ranks")
    jm = JaxModel(jax_yaml_load(TINY), nc=3)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    batches = _global_batches()
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    start = state_dict_from_jax(v, tm)
    np.savez(tmp / "state.npz", **{k: t.numpy() for k, t in start.items()})
    save_batches(tmp / "batches.npz", batches)
    frame = np.random.default_rng(1).uniform(
        0, 1, (1, INFER_HW, INFER_HW, 3)).astype(np.float32)
    np.savez(tmp / "frames.npz", img=frame)
    step = ["step", "--model", TINY, "--imgsz", IMGSZ, "--state",
            tmp / "state.npz", "--batches", tmp / "batches.npz",
            "--steps", ",".join(map(str, STEPS)), "--nb", NB, "--device",
            "cpu", "--group-timeout", GROUP_TIMEOUT, "--spatial-ranks", SP]
    # dp 1 reads the whole global batch; dp 2 each data coordinate half
    runs = [(SP, step + ["--overrides", json.dumps(
        {**COMMON, "batch": RANKS * PER, "nbs": 8}), "--out", tmp / "ranks",
        "--also-remat", REMAT, "--frames", tmp / "frames.npz"]),
        (RANKS * SP, step + ["--overrides", json.dumps(
            {**COMMON, "batch": PER, "nbs": 8}), "--out", tmp / "ranks4"])]
    pool = ThreadPoolExecutor(max_workers=1)
    spawned = pool.submit(lambda: [launch(n, argv, timeout=TIMEOUT)
                                   for n, argv in runs])
    pool.shutdown(wait=False)

    want = {(1, SP): _jax_window(jm, v, batches, (1, SP), tm),
            (RANKS, SP): _jax_forward(jm, v, batches, (RANKS, SP), tm),
            "infer": jax_spatial_infer(
                jm, v, frame, mesh=jax_mesh(devices=jax.devices()[:SP],
                                            axes=("spatial",)))}
    for (n, argv), res in zip(runs, spawned.result()):
        for r, (rc, text) in enumerate(res):
            out = argv[argv.index("--out") + 1]
            assert rc == 0, f"{out} rank {r} ({rc}):\n{text[-3000:]}"
    load = lambda name, n: [dict(np.load(tmp / f"{name}_rank{r}.npz"))
                            for r in range(n)]
    return want, start, {"1x2": load("ranks", SP),
                         "remat": load("ranks_remat", SP),
                         "infer": load("ranks_infer", SP),
                         "2x2": load("ranks4", RANKS * SP)}


def _ranks_equal(runs):
    for x in runs[1:]:
        for k in runs[0]:
            np.testing.assert_array_equal(runs[0][k], x[k], err_msg=k)


def _norm_errors(got, want):
    """Each entry's largest error against the other run, by kind: the
    items and totals, the state and BN stats absolute, each momentum
    buffer (the window's gradient plus decay) relative to its norm."""
    worst = {}
    for k, w in want.items():
        if not k.startswith(("items_", "total_", "state/", "buf/")):
            continue
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        if k.startswith("buf/"):
            n = np.linalg.norm(w)
            err = float(np.linalg.norm(g - w) / n) if n else 0.0
        else:
            err = float(np.abs(g - w).max())
        kind = ("bn_stats" if "running_" in k
                else k.split("/")[0].split("_")[0])
        worst[kind] = max(worst.get(kind, 0.0), err)
    return worst


def test_spatial_ranks_window_matches_jax_1x2_step(spanning_runs):
    """Two ranks, one slab each, mesh (1, 2): the ranks bit-equal, the
    window against JAX's (1, 2) step at test_torch_dist_step.py's bars."""
    want, start, spanning = spanning_runs
    runs = spanning["1x2"]
    _ranks_equal(runs)
    r0 = runs[0]
    assert list(r0["counts"]) == [1, 0, 1]
    w = want[(1, SP)]
    for j, jt in enumerate(w["totals"]):
        np.testing.assert_allclose(float(r0[f"total_{j}"]), jt, rtol=3e-5)
    assert_window(_rank_window(r0), w, start, "(1, 2) over two ranks")


def test_spatial_ranks_window_equals_local_window(spanning_runs):
    """The same window on a local (1, 2) mesh (both slabs in one process):
    within 1e-6 of each norm, and bit-equal (every exchange and join puts
    each row's gradient together in the same order)."""
    _, start, spanning = spanning_runs
    local = _window(local_mesh(), _global_batches(), start,
                    {**COMMON, "batch": RANKS * PER, "nbs": 8})
    want = {**{f"items_{j}": x.numpy() for j, x in enumerate(local["items"])},
            **{f"state/{k}": x.numpy() for k, x in local["state"].items()},
            **{f"buf/{k}": x.numpy() for k, x in local["buf"].items()}}
    got = spanning["1x2"][0]
    worst = _norm_errors(got, want)
    print("ranks vs local (1, 2):", worst)
    assert max(worst.values()) <= 1e-6, worst
    for k, x in want.items():
        np.testing.assert_array_equal(got[k], x, err_msg=k)


@pytest.mark.parametrize("where", ["ranks", "local"])
def test_remat_on_spatial_mesh_matches_no_remat(spanning_runs, where):
    """remat=4 (layer 0 through the P3 C2f recomputed in the backward, its
    halos exchanged again) against remat=-1 on the same mesh: the loss
    items and BN running stats equal, the gradients (the momentum buffers)
    within 1e-6 of each norm."""
    _, start, spanning = spanning_runs
    if where == "ranks":
        got, want = spanning["remat"][0], spanning["1x2"][0]
        _ranks_equal(spanning["remat"])
    else:
        runs = []
        for remat in (REMAT, -1):
            r = _window(local_mesh(), _global_batches(), start,
                        {**COMMON, "batch": RANKS * PER, "nbs": 8,
                         "remat": remat})
            runs.append({**{f"items_{j}": x.numpy()
                            for j, x in enumerate(r["items"])},
                         **{f"state/{k}": x.numpy()
                            for k, x in r["state"].items()},
                         **{f"buf/{k}": x.numpy()
                            for k, x in r["buf"].items()}})
        got, want = runs
    worst = _norm_errors(got, want)
    print(f"remat {REMAT} vs -1 ({where}):", worst)
    for k in want:
        if k.startswith("items_") or "running_" in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert worst["buf"] <= 1e-6, worst


def test_spatial_ranks_2x2_forward_matches_jax(spanning_runs):
    """Four ranks, mesh (2, 2): loss items, totals and BN running stats
    against JAX's (2, 2) step (its gradients are ROADMAP C19's), every
    rank of a data coordinate bit-equal, the four states bit-equal."""
    want, _, spanning = spanning_runs
    runs = spanning["2x2"]
    _ranks_equal(runs)
    r0, w = runs[0], want[(RANKS, SP)]
    for j, jt in enumerate(w["totals"]):
        np.testing.assert_allclose(float(r0[f"total_{j}"]), jt, rtol=3e-5)
    for j, x in enumerate(w["items"]):
        np.testing.assert_allclose(r0[f"items_{j}"], x.numpy(), rtol=3e-5,
                                   err_msg=f"items {j}")
    port = _rank_window(r0)
    for k, x in w["state"].items():
        if "running_" in k:
            close(port["state"][k], x, 2e-6, k)


def test_spatial_infer_over_ranks(spanning_runs):
    """spatial_infer over two ranks (each its slab, the outputs joined on
    every rank) against JAX's spatial_infer on two devices, at the
    unsharded bars, and bit-equal to the port's over a local mesh of two
    slabs."""
    want, _, spanning = spanning_runs
    runs = spanning["infer"]
    for x in runs[1:]:
        for k in ("boxes", "scores"):
            np.testing.assert_array_equal(runs[0][f"ranks/{k}"],
                                          x[f"ranks/{k}"])
    r0 = runs[0]
    jb, js = want["infer"]
    np.testing.assert_allclose(r0["ranks/boxes"], np.asarray(jb), rtol=0,
                               atol=4e-4)
    np.testing.assert_allclose(r0["ranks/scores"], np.asarray(js), rtol=0,
                               atol=1e-6)
    for k in ("boxes", "scores"):
        np.testing.assert_array_equal(r0[f"ranks/{k}"], r0[f"local/{k}"])


WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")


@pytest.mark.parametrize("world,sp,h", [(2, 2, 8), (4, 2, 8), (4, 4, 4)])
def test_exchanges_over_ranks_match_whole(tmp_path, world, sp, h):
    """tests/torch_dist_worker.py's `ranks` scenario: a 3x3 conv, a 5x5
    max pool (at (4, 4, 4) one row a slab, so its halo reaches past the
    neighbouring slab), a mean and an amax over H x W and a join, over a
    (world // sp, sp) mesh of gloo ranks, against the whole map in this
    process: outputs within 1e-6, the gradients to the map and the weight
    (each rank's share summed over its spatial group) within 1e-5; the
    mesh's indices and subgroups as JAX lays the devices out."""
    import torch.nn.functional as F
    rng = np.random.default_rng(world + sp)
    x = rng.normal(0, 1, (2, h, 6, 3)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 3, 3, 3)).astype(np.float32)
    g = rng.normal(0, 1, (2, 4, h, 6)).astype(np.float32)
    gr = rng.normal(0, 1, (2, 4, 1, 1)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, w=w, g=g, gr=gr, sp=sp)
    res = launch(world, ["ranks", tmp_path / "in.npz", tmp_path / "out"],
                 timeout=TIMEOUT, target=(WORKER,))
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-3000:]}"
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = F.max_pool2d(F.conv2d(xt.permute(0, 3, 1, 2), wt, padding=1), 5, 1, 2)
    red = y.mean((2, 3), keepdim=True) + y.amax((2, 3), keepdim=True)
    gx, gw = torch.autograd.grad((y * torch.from_numpy(g)).sum()
                                 + (red * torch.from_numpy(gr)).sum(),
                                 [xt, wt])
    dp = world // sp
    for r in range(world):
        z = dict(np.load(tmp_path / f"out_rank{r}.npz"))
        info = json.loads(str(z["info"]))
        k, j = r // sp, r % sp
        assert info == {"spatial_index": j, "data_index": k,
                        "data_size": dp,
                        "spatial_group": list(range(k * sp, (k + 1) * sp)),
                        "data_group": (list(range(j, world, sp)) if dp > 1
                                       else None)}
        np.testing.assert_allclose(z["y"], y.detach().numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(z["red"], red.detach().numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(z["gx"], gx.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(z["gw"], gw.numpy(), rtol=0, atol=1e-5)
