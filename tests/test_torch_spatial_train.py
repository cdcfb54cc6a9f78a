"""Torch port vs the JAX package: data x spatial training (CPU).

`mesh_shape=[dp, sp], mesh_axes=[data, spatial]`: the data axis over dp
gloo ranks (one process a data coordinate), the spatial axis over each
rank's own devices, here the CPU repeated (`["cpu", "cpu"]`), as JAX's
tests shard over conftest's virtual host devices. The tiny model at imgsz
64, two threads pinned:
  - (a) one accumulation window (two micro-steps at global batch indices
    37 and 38) of two ranks, b2 each, each rank's rows on two slabs,
    against JAX's train step on the same four images a micro-step (its
    image leaves P(data, spatial)) at tests/test_torch_dist_step.py's
    bars: loss items and total 3e-5 relative, BN running stats and their
    EMA 2e-6 absolute, momentum buffers 2e-3 of each tensor's largest
    entry (2e-2 for layer 0's), SGD's updated parameters and EMA 1e-6 plus
    half of that share of the tensor's largest move; both ranks' states
    bit-equal. The whole window against JAX's step under `make_mesh(shape=
    (1, 2), axes=("data", "spatial"))`, its forward (items, totals, BN
    stats) also against `make_mesh(shape=(2, 2), ...)`, whose gradients
    are not JAX's own unsharded step's (ROADMAP C19);
  - (b) the same window at world size 1 on a (1, 2) mesh against the port's
    plain step, at the same bars (BN's moments over the slabs take flax's
    E[x^2] - E[x]^2 form, the plain step `F.batch_norm`'s);
  - (c) one micro-step (nbs = batch: the update applies) of each task's
    tiny graph on (1, 2) against its plain step, at the same bars: classify,
    segment and pose (layer 0 first), tests/tiny_rtdetr.yaml, and a detect
    graph with SCConv and CBAM; with amp=True on the detect graph, the
    slabs' bf16 loss items no farther from the plain bf16 step's than those
    are from the plain f32 step's;
  - layer 0 in training on two slabs with the trainer's priors: output
    and gradients equal to the whole image's (float64);
  - (d) JAX's refusals (imgsz not a multiple of 32 * sp, the batch over the
    data axis) and the port's (a data axis that is neither the world nor
    the world over sp); the setups that work: remat on a spatial mesh, and
    a spatial axis across ranks (its shape, subgroups and indices);
  - (e) `DetectionValidator` over `make_mesh(devices=["cpu"] * 2)`: the
    metrics equal the plain val's (a batch of 4 split in two groups, the
    last batch of 3 whole);
  - (f) `YOLO(...).train(mesh_shape=[1, 2], mesh_axes=[data, spatial],
    val=True)`, the counterpart of JAX's `test_train_2d_mesh_spatial`: a
    finite results.csv, its val run over the trainer's local mesh.
"""

import copy
import csv
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels,
    opt_update as jax_opt_update)
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.parallel import (  # noqa: E402
    make_mesh as jax_mesh, replicate as jax_replicate,
    shard_batch as jax_shard)
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_update as jax_ema_update  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.engine.classify import ClassificationTrainer  # noqa: E402
from dedark_yolo_tpu_torch.engine.pose import PoseTrainer  # noqa: E402
from dedark_yolo_tpu_torch.engine.segment import SegmentationTrainer  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.parallel import make_mesh  # noqa: E402
from dedark_yolo_tpu_torch.parallel import mesh as M  # noqa: E402
from dedark_yolo_tpu_torch.tools.dist_probe import launch, save_batches  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    init_weights, opt_state_from_jax, state_dict_from_jax)

from synth import make_synth_dataset  # noqa: E402
from test_classify import CLS_TINY  # noqa: E402
from test_pose_task import POSE_TINY  # noqa: E402
from test_segment_task import SEG_TINY  # noqa: E402
from test_torch_dist_step import _global_batches  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_segment_model import with_layer0  # noqa: E402
from test_torch_train_slice import _jax_trainer, close  # noqa: E402
from test_torch_val import (RESULT_KEYS, tiny_variables)  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
TINY = str(HERE / "tiny_model.yaml")
IMGSZ, RANKS, PER, SP = 64, 2, 2, 2
NB, STEPS = 20, (37, 38)
TIMEOUT = 180
COMMON = {"epochs": 10, "imgsz": IMGSZ, "optimizer": "SGD",
          "prior_mode": "computed", "lr0": 0.02}
SPATIAL = {"mesh_shape": [1, SP], "mesh_axes": ["data", "spatial"]}
# a detect graph with SCConv's group norms and CBAM's means over H x W
SC_CBAM = {"nc": 3, "backbone": [
    [-1, 1, "lowlight_recovery", [3]], [-1, 1, "Conv", [16, 3, 2]],
    [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
    [-1, 1, "SCConv", [32]], [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "CBAM", [64]], [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[4, 6, 7], 1, "Detect", ["nc"]]]}


def local_mesh(n=SP):
    return make_mesh(shape=(1, n), axes=("data", "spatial"), device="cpu")


def snapshot(tr, items):
    """A run's window: its items, state, EMA and momentum buffers."""
    cp = lambda sd: {k: v.detach().clone() for k, v in sd.items()}
    return {"items": items, "state": cp(tr.model.state_dict()),
            "ema": cp(tr.ema), "buf": cp(tr.opt_state.buf)}


def assert_window(got, want, start, what=""):
    """tests/test_torch_dist_step.py's bars (see the module docstring)."""
    for j, (g, w) in enumerate(zip(got["items"], want["items"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-5,
                                   err_msg=f"{what} items {j}")
    for k, w in want["state"].items():
        if "running_" in k:
            close(got["state"][k], w, 2e-6, k)
            close(got["ema"][k], want["ema"][k], 2e-6, k)
            continue
        rel = 2e-2 if k.startswith("model.0.") else 2e-3
        theirs = want["buf"][k]
        if theirs.abs().max() > 0:
            close(got["buf"][k], theirs, rel * float(theirs.abs().max()), k)
        tol = 1e-6 + rel / 2 * float((w - start[k]).abs().max())
        close(got["state"][k], w, tol, k)
        close(got["ema"][k], want["ema"][k], tol, k)


# ------------------------------------------------ (a) two ranks x two slabs
def _jax_window(jm, v, batches, shape, tm):
    """JAX's window (global batch RANKS * PER) under a data x spatial mesh
    of `shape` on the virtual host devices, in the port's names: its train
    step's parts as `make_train_step` composes them (the loss's
    `value_and_grad`, then `opt_update` and, after an applied update,
    `ema_update`), each jitted apart: `make_train_step`'s one program for
    all three takes about twice as long to compile on the CPU."""
    jt = _jax_trainer({**COMMON, "batch": RANKS * PER, "nbs": 8})
    mesh = jax_mesh(shape=shape, axes=("data", "spatial"))
    grad = jax.jit(jax.value_and_grad(jt.make_loss_fn(jm), has_aux=True))
    labels = jax_labels(v["params"])
    update = jax.jit(lambda p, g, o, lb, lr, m: jax_opt_update(
        p, g, o, labels, kind=jt.opt_name, lr_bias=lb, lr=lr, momentum=m,
        weight_decay=jt.weight_decay, accumulate=jt.accumulate))
    params, stats = v["params"], v["batch_stats"]
    opt = jax_init_opt(v["params"])
    ema = {"params": jax_ema_init(v["params"]),
           "batch_stats": jax_ema_init(v["batch_stats"])}
    updates, out = 0, []
    for i, batch in zip(STEPS, batches):
        sharded = jax_shard(mesh, batch)
        assert sharded["img"].sharding.spec == jax.sharding.PartitionSpec(
            "data", "spatial")
        (total, (items, stats)), grads = grad(
            jax_replicate(mesh, params), jax_replicate(mesh, stats), sharded)
        params, opt, applied = update(
            params, grads, opt, jnp.float32(jt._lr_at(i, "bias")),
            jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        if bool(applied):
            ema, updates = jax.jit(jax_ema_update)(
                ema, {"params": params, "batch_stats": stats}, updates)
        out.append((float(total), np.stack(items)))
    return {"items": [torch.from_numpy(x) for _, x in out],
            "totals": [t for t, _ in out],
            "state": state_dict_from_jax(
                {"params": jax.device_get(params),
                 "batch_stats": jax.device_get(stats)}, tm),
            "ema": state_dict_from_jax(jax.device_get(ema), tm),
            "buf": opt_state_from_jax(jax.device_get(opt), tm).buf,
            "updates": int(opt.step)}


def _jax_forward(jm, v, batches, shape, tm):
    """The window's forward half under a data x spatial mesh of `shape`:
    each micro-step's total and items and the BN stats after both (the
    update applies after the second forward)."""
    jt = _jax_trainer({**COMMON, "batch": RANKS * PER, "nbs": 8})
    mesh = jax_mesh(shape=shape, axes=("data", "spatial"))
    loss = jax.jit(jt.make_loss_fn(jm))
    params = jax_replicate(mesh, v["params"])
    stats = jax_replicate(mesh, v["batch_stats"])
    out = []
    for batch in batches:
        total, (items, stats) = loss(params, stats, jax_shard(mesh, batch))
        out.append((float(total), np.stack(items)))
    return {"items": [torch.from_numpy(x) for _, x in out],
            "totals": [t for t, _ in out],
            "state": state_dict_from_jax(
                {"params": v["params"], "batch_stats": jax.device_get(stats)},
                tm)}


@pytest.fixture(scope="module")
def window_2x2(tmp_path_factory):
    """The port's two ranks x two slabs (spawned first, in a thread) and
    JAX's windows under (1, 2) and (2, 2) data x spatial meshes, each
    computed once from the same trees and global batches."""
    tmp = tmp_path_factory.mktemp("spatial_2x2")
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
    pool = ThreadPoolExecutor(max_workers=1)
    ranks = pool.submit(launch, RANKS, [
        "step", "--model", TINY, "--imgsz", IMGSZ, "--state",
        tmp / "state.npz", "--batches", tmp / "batches.npz",
        "--steps", ",".join(map(str, STEPS)), "--nb", NB, "--device", "cpu",
        "--spatial", SP, "--overrides",
        json.dumps({**COMMON, "batch": PER, "nbs": 4}), "--out",
        tmp / "two"], timeout=TIMEOUT)
    pool.shutdown(wait=False)

    want = {(1, SP): _jax_window(jm, v, batches, (1, SP), tm),
            (RANKS, SP): _jax_forward(jm, v, batches, (RANKS, SP), tm)}
    res = ranks.result()
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-3000:]}"
    got = [dict(np.load(tmp / f"two_rank{r}.npz")) for r in range(RANKS)]
    return got, want, start


def _rank_window(z):
    t = lambda k: torch.from_numpy(np.asarray(z[k]))
    sec = lambda name: {k[len(name) + 1:]: t(k) for k in z
                        if k.startswith(name + "/")}
    return {"items": [t(f"items_{j}") for j in range(len(STEPS))],
            "state": sec("state"), "ema": sec("ema"), "buf": sec("buf")}


def test_two_ranks_by_two_slabs_match_jax_2x2_mesh(window_2x2):
    got, want, start = window_2x2
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    r0, port = got[0], _rank_window(got[0])
    assert list(r0["counts"]) == [1, 0, 1]
    assert want[(1, SP)]["updates"] == 1
    for shape, w in want.items():
        for j, jt in enumerate(w["totals"]):
            np.testing.assert_allclose(float(r0[f"total_{j}"]), jt,
                                       rtol=3e-5)
        for j, (g, x) in enumerate(zip(port["items"], w["items"])):
            np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=3e-5,
                                       err_msg=f"{shape} items {j}")
        for k, x in w["state"].items():
            if "running_" in k:
                close(port["state"][k], x, 2e-6, f"{shape} {k}")
    # the whole window against JAX's (1, 2) step; JAX's (2, 2) backward is
    # ROADMAP C19 (its gradients are not the unsharded step's)
    w = want[(1, SP)]
    assert sum(not torch.equal(x, start[k]) for k, x in w["state"].items()) \
        > 0.9 * len(start)
    assert_window(port, w, start, "2 x 2 ranks x slabs")


# -------------------------------------------- (b) world 1, (1, 2) vs plain
def _window(mesh, batches, start, overrides, trainer=DetectionTrainer,
            graph=TINY):
    """The port's window on `batches` (global batch indices STEPS) from
    `start`, without a mesh or on `mesh`."""
    tm = DetectionModel(model_yaml_load(graph) if isinstance(graph, str)
                        else copy.deepcopy(graph))
    tm.load_state_dict(start)
    tr = trainer(overrides, model=tm, nb=NB, device="cpu")
    tr.mesh = mesh
    items = [tr.step(b, i)[1] for i, b in zip(STEPS, batches)]
    return snapshot(tr, items)


def test_world_one_spatial_window_matches_plain(window_2x2):
    _, _, start = window_2x2
    batches = _global_batches()
    over = {**COMMON, "batch": RANKS * PER, "nbs": 8}
    plain = _window(None, batches, start, over)
    slabs = _window(local_mesh(), batches, start, over)
    assert_window(slabs, plain, start, "(1, 2)")


# ------------------------------------------- (c) every task's graph on slabs
def _task_batch(task, b=2, m=4, seed=3, nk=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, IMGSZ, IMGSZ, 3), np.uint8)
    if task == "classify":
        return {"img": img, "cls": rng.integers(0, 3, (b,)).astype(np.int32)}
    xy = rng.uniform(0.3, 0.7, (b, m, 2))
    wh = rng.uniform(0.15, 0.4, (b, m, 2))
    out = {"img": img, "cls": rng.integers(0, 2, (b, m)).astype(np.float32),
           "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
           "mask_gt": np.concatenate([np.ones((b, m - 1)), np.zeros((b, 1))],
                                     1).astype(np.float32)}
    if task == "segment":
        masks = np.zeros((b, IMGSZ // 4, IMGSZ // 4), np.float32)
        masks[:, 2:7, 3:9] = 1
        masks[:, 8:14, 5:12] = 2
        masks[:, 4:12, 12:15] = 3
        out["masks"] = masks
    if task == "pose":
        out["keypoints"] = np.concatenate([
            xy[:, :, None] + rng.uniform(-0.1, 0.1, (b, m, nk, 2)),
            rng.integers(0, 3, (b, m, nk, 1))], -1).astype(np.float32)
    return out


TASKS = {"classify": (ClassificationTrainer, CLS_TINY),
         "segment": (SegmentationTrainer, with_layer0(SEG_TINY)),
         "pose": (PoseTrainer, with_layer0(POSE_TINY)),
         "rtdetr": (DetectionTrainer, "tests/tiny_rtdetr.yaml"),
         "sc_cbam": (DetectionTrainer, SC_CBAM)}


def _seeded_start(graph, seed=0):
    tm = DetectionModel(model_yaml_load(graph) if isinstance(graph, str)
                        else copy.deepcopy(graph))
    init_weights(tm, seed)
    return {k: v.clone() for k, v in tm.state_dict().items()}


def _one_step(trainer, graph, batch, start, mesh, over):
    tm = DetectionModel(model_yaml_load(graph) if isinstance(graph, str)
                        else copy.deepcopy(graph))
    tm.load_state_dict(start)
    tr = trainer(over, model=tm, nb=NB, device="cpu")
    tr.mesh = mesh
    return snapshot(tr, [tr.step(batch, STEPS[0])[1]])


@pytest.mark.parametrize("task", list(TASKS) + ["detect_amp"])
def test_task_step_on_slabs_matches_plain(task):
    """One micro-step on a (1, 2) mesh against the plain step (see (c))."""
    b = 2
    over = {**COMMON, "batch": b, "nbs": b}
    if task == "detect_amp":
        batch = _global_batches()[0]
        batch = {k: v[:b] for k, v in batch.items()}
        start = _seeded_start(TINY)
        run = lambda mesh, amp: _one_step(DetectionTrainer, TINY, batch,
                                          start, mesh, {**over, "amp": amp})
        f32, bf16, slabs = run(None, False), run(None, True), run(
            local_mesh(), True)
        gap = (bf16["items"][0] - f32["items"][0]).abs()
        err = (slabs["items"][0] - bf16["items"][0]).abs()
        assert bool((err <= gap).all()), (err, gap)
        assert bool(torch.isfinite(slabs["items"][0]).all())
        return
    trainer, graph = TASKS[task]
    batch = _task_batch(task)
    start = _seeded_start(graph)
    plain = _one_step(trainer, graph, batch, start, None, over)
    slabs = _one_step(trainer, graph, batch, start, local_mesh(), over)
    assert sum(not torch.equal(w, start[k])
               for k, w in plain["state"].items()) > 0.5 * len(start)
    assert_window(slabs, plain, start, task)


@pytest.mark.parametrize("mode", ["channel", "reference"])
def test_layer0_slabs_backward_matches_whole(mode):
    """Layer 0 in training on two slabs with the trainer's priors (dedark_A
    whole, IcA cut with each slab's extended rows): the output, the input's
    gradient and the parameter CNN's gradients equal the whole image's
    (the halo rows' outputs are cropped, so they take no gradient; each
    slab's features add up). In float64, so that the sums' order cannot
    hide a term counted twice or lost: the output 1e-12, each gradient
    1e-10 of its largest entry; 'reference''s usm runs in f32
    (`usm_reference`), so there 1e-6 (f32's rounding of each term)."""
    from dedark_yolo_tpu_torch.nn.enhance import LowlightRecovery
    from dedark_yolo_tpu_torch.ops.dark_channel import dark_channel_priors
    from dedark_yolo_tpu_torch.parallel import spatial as S
    torch.manual_seed(0)
    mod = LowlightRecovery(mode).train().double()
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 128, 96, 3)))
    A, IcA = dark_channel_priors(x)
    outs = []
    for slabs in (False, True):
        xg = x.clone().requires_grad_(True)
        inp = S.row_slabs(xg, [torch.device("cpu")] * 2) if slabs else xg
        y = mod(inp, A, IcA)
        y = y.join() if slabs else y
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        params = list(mod.parameters())
        grads = torch.autograd.grad((y * w).sum(), [xg, *params])
        outs.append((y.detach(), grads))
    (y0, g0), (y1, g1) = outs
    out_tol, grad_tol = (1e-12, 1e-10) if mode == "channel" else (1e-6, 1e-6)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=0, atol=out_tol)
    for a, b in zip(g1, g0):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=grad_tol * max(scale, 1e-12))


# ----------------------------------------------------------- (d) refusals
def _setup(monkeypatch=None, **over):
    tr = DetectionTrainer({"batch": 2, "imgsz": IMGSZ, **SPATIAL, **over},
                          model=DetectionModel(model_yaml_load(TINY), nc=3),
                          device="cpu")
    tr._setup_mesh()
    return tr


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match=r"imgsz 96 must divide 32 \* 2 "
                       r"spatial shards \(use imgsz=128\)"):
        _setup(imgsz=96)
    with pytest.raises(ValueError, match="batch 3 must divide evenly over "
                                         "the 2-way data axis"):
        _setup(batch=3, mesh_shape=[2, 2])
    with pytest.raises(ValueError, match="--nproc_per_node 2"):
        _setup(batch=4, mesh_shape=[2, 2])
    # remat on a spatial mesh (ROADMAP A12j-b) builds
    tr = _setup(remat=4)
    assert tr.model.remat_upto == 4 and tr.mesh.spatial == 2
    tr = _setup()
    assert (tr.mesh.shape, tr.mesh.spatial, tr.mesh.size, tr.mesh.world,
            len(tr.mesh.devices)) == ((1, 2), 2, 2, 1, 2)
    assert tr.val_mesh.axis_names == ("data",) and tr.val_mesh.size == 2
    # a spatial axis across ranks (ROADMAP A12i-d), one device a rank, laid
    # out as JAX reshapes devices[:n] to (dp, sp): rank r at data index
    # r // sp and spatial index r % sp, its subgroups made in one order
    made = []
    monkeypatch.setattr(M.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(M.dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(M.dist, "new_group", lambda ranks, **kw: (
        made.append(tuple(ranks)) or tuple(ranks)))
    monkeypatch.setitem(M._STATE, "device", torch.device("cpu"))
    for world, rank, shape, want in (
            (2, 1, (1, 2), ((0, 1), None, 1, 0, 1)),
            (4, 3, (2, 2), ((2, 3), (1, 3), 1, 1, 2)),
            (4, 2, (2, 2), ((2, 3), (0, 2), 0, 1, 2))):
        monkeypatch.setattr(M.dist, "get_world_size", lambda w=world: w)
        monkeypatch.setattr(M.dist, "get_rank", lambda r=rank: r)
        monkeypatch.setitem(M._STATE, "subgroups", {})
        made.clear()
        m = make_mesh(shape=shape, axes=("data", "spatial"), device="cpu")
        assert (m.spatial_group, m.data_group, m.spatial_index,
                m.data_index, m.data_size) == want
        assert (m.shape, m.world, m.rank, m.spatial, m.size, m.devices,
                m.spans_ranks) == (shape, world, rank, 2, world,
                                   (torch.device("cpu"),), True)
        dp = shape[0]
        assert made == ([tuple(range(k * 2, k * 2 + 2)) for k in range(dp)]
                        + ([tuple(range(j, world, 2)) for j in range(2)]
                           if dp > 1 else []))


# ---------------------------------------------- (e) val over a local mesh
def test_val_over_local_mesh_equals_plain(tmp_path):
    data = make_synth_dataset(tmp_path / "ds", n_train=0, n_val=7, imgsz=96)
    _, v = tiny_variables()
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    kw = {"data": str(data), "imgsz": 96, "batch": 4, "workers": 2,
          "plots": False, "verbose": False, "device": "cpu"}
    plain = validator.DetectionValidator(
        args=get_cfg(overrides=kw), save_dir=tmp_path / "one")(model=tm)
    calls = []
    orig = validator.detect_step
    validator.detect_step = lambda m, img, *a, **k: (
        calls.append(img.shape[0]) or orig(m, img, *a, **k))
    try:
        got = validator.DetectionValidator(
            args=get_cfg(overrides=kw), save_dir=tmp_path / "mesh")(
            model=tm, mesh=make_mesh(devices=["cpu"] * 2))
    finally:
        validator.detect_step = orig
    assert calls == [2, 2, 3]
    assert set(got) == set(RESULT_KEYS)
    assert {k: float(x) for k, x in got.items()} == \
        {k: float(x) for k, x in plain.items()}
    assert float(plain["metrics/recall(B)"]) > 0
    with pytest.raises(NotImplementedError, match="several ranks or devices"):
        validator.DetectionValidator(args=get_cfg(overrides=kw))(
            model=tm, mesh=make_mesh(devices=["cpu"] * 2), with_loss=True)


def _cls_folder(root, seed=0):
    """root/val/color{0,1,2}/k.jpg: three images a class."""
    import cv2
    rng = np.random.default_rng(seed)
    for c, color in enumerate([(200, 40, 40), (40, 200, 40), (40, 40, 200)]):
        d = root / "val" / f"color{c}"
        d.mkdir(parents=True)
        for k in range(3):
            img = np.clip(np.full((48, 56, 3), color) + rng.normal(
                0, 20, (48, 56, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(str(d / f"{k}.jpg"), img)
    return str(root)


@pytest.mark.parametrize("task", ["segment", "pose", "classify"])
def test_task_val_over_local_mesh_equals_plain(task, tmp_path):
    """Every task's validator over `make_mesh(devices=["cpu"] * 2)`: the
    results equal the plain val's (segment and pose: 6 images, b4 batches
    padded to 4, each in two groups; classify: 9 images, b4, the last
    batch padded)."""
    from dedark_yolo_tpu_torch.engine import classify as C
    from dedark_yolo_tpu_torch.engine import pose as P
    from dedark_yolo_tpu_torch.engine import segment as G
    from test_torch_pose_data import make_pose_dataset
    from test_torch_segment_data import make_seg_dataset
    kw = {"imgsz": 64, "batch": 4, "conf": 0.001, "max_nms": 256,
          "max_det": 30, "max_boxes": 8, "plots": False, "device": "cpu"}
    if task == "segment":
        data = make_seg_dataset(tmp_path / "ds", n_train=0, n_val=6, seed=3)
        graph = with_layer0(SEG_TINY)
        make = lambda: G.SegmentationValidator(args=get_cfg(overrides=kw), data=data,
                                               save_dir=tmp_path / "v")
    elif task == "pose":
        data = make_pose_dataset(tmp_path / "ds", n_train=0, n_val=6, seed=3)
        graph = with_layer0(POSE_TINY)
        make = lambda: P.PoseValidator(args=get_cfg(overrides=kw), data=data,
                                       save_dir=tmp_path / "v",
                                       kpt_shape=POSE_TINY["kpt_shape"])
    else:
        graph, root = CLS_TINY, _cls_folder(tmp_path / "cls")
        make = lambda: C.ClassificationValidator(
            args=get_cfg(overrides={**kw, "data": root}), save_dir=tmp_path / "v")
    tm = DetectionModel(copy.deepcopy(graph))
    init_weights(tm, 0)
    plain = make()(model=tm)
    got = make()(model=tm, mesh=make_mesh(devices=["cpu"] * 2))
    assert set(got) == set(plain) and len(plain) >= 3
    assert {k: float(x) for k, x in got.items()} == \
        {k: float(x) for k, x in plain.items()}


# ------------------------------------------------ (f) the facade's train
def test_facade_train_data_x_spatial(tmp_path):
    data = make_synth_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=64)
    y = YOLO(TINY, device="cpu", seed=0)
    seen = []
    orig = validator.DetectionValidator.__call__
    validator.DetectionValidator.__call__ = lambda self, **k: (
        seen.append(k.get("mesh")) or orig(self, **k))
    try:
        y.train(data=str(data), epochs=1, imgsz=IMGSZ, batch=2, workers=2,
                device="cpu", plots=False, val=True, mesh_shape=[1, SP],
                mesh_axes=["data", "spatial"], project=str(tmp_path / "runs"),
                name="sp")
    finally:
        validator.DetectionValidator.__call__ = orig
    assert seen and all(m is not None and m.size == SP and m.world == 1
                        for m in seen)
    with open(tmp_path / "runs" / "sp" / "results.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2
    vals = [float(x) for x in rows[1]]
    assert np.isfinite(vals).all() and vals[1] > 0
