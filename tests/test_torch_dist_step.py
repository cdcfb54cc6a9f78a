"""Torch port vs the JAX package: the data-parallel train step over two
gloo ranks (CPU, f32).

One accumulation window (two micro-steps at global batch indices 37 and 38,
inside the warmup) of `DetectionTrainer.step` on tests/tiny_model.yaml at
imgsz 64, b2 a rank over two ranks spawned by `tools/dist_probe.launch`
(batch 2, nbs 4), against JAX's train step under `make_mesh(shape=(2,))`
on conftest's virtual CPU devices with the same four images a micro-step
(batch 4, nbs 8: the same window, accumulation and decay). The bars are
tests/test_torch_train_slice.py's: loss items and total 3e-5 relative, BN
running stats and their EMA 2e-6 absolute, momentum buffers 2e-3 of each
tensor's largest entry (2e-2 for layer 0's), SGD's updated parameters and
EMA 1e-6 plus half of that share of the tensor's largest move. Both ranks'
states are bit-equal.

The RT-DETR, segment and pose losses on two ranks, each rank's rows with the
group's normalisers, against JAX's loss on the global batch: the ranks'
totals and items summed 2e-5 relative, the gradients of the inputs 1e-5 of
their largest (tests/test_torch_{pose_loss,segment_model,rtdetr_task}.py's
bars; the rank's share of the loss differentiates to the global loss's
gradient in its rows, the normalisers being detached).
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
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.losses import rtdetr as JR  # noqa: E402
from dedark_yolo_tpu.losses import segment as JL  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.parallel import (  # noqa: E402
    make_mesh as jax_mesh, replicate as jax_replicate,
    shard_batch as jax_shard)
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.tools.dist_probe import launch, save_batches  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    opt_state_from_jax, state_dict_from_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_train_slice import _jax_trainer, close  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
TINY = str(HERE / "tiny_model.yaml")
WORKER = str(HERE / "torch_dist_worker.py")
IMGSZ, RANKS, PER, M = 64, 2, 2, 5
NB, STEPS = 20, (37, 38)
TIMEOUT = 180


def _global_batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    b = RANKS * PER
    for _ in STEPS:
        xy = rng.uniform(0.25, 0.75, (b, M, 2))
        wh = rng.uniform(0.15, 0.5, (b, M, 2))
        out.append({
            "img": rng.integers(0, 256, (b, IMGSZ, IMGSZ, 3), np.uint8),
            "cls": rng.integers(0, 3, (b, M)).astype(np.float32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask_gt": (rng.uniform(size=(b, M)) > 0.2).astype(np.float32)})
    return out


def _ok(res):
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-3000:]}"


def _spawn(argv, **kw):
    """The ranks' run in a thread, so the JAX side computes meanwhile; the
    future's result is launch's."""
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch, RANKS, argv, timeout=TIMEOUT, **kw)
    pool.shutdown(wait=False)
    return fut


def test_two_rank_window_matches_jax_mesh_step(tmp_path):
    common = {"epochs": 10, "imgsz": IMGSZ, "optimizer": "SGD",
              "prior_mode": "computed", "lr0": 0.02}
    jm = JaxModel(jax_yaml_load(TINY), nc=3)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    batches = _global_batches()

    # the port: two ranks of b2 from the same weights
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    start = state_dict_from_jax(v, tm)
    np.savez(tmp_path / "state.npz", **{k: t.numpy() for k, t in start.items()})
    save_batches(tmp_path / "batches.npz", batches)
    over = {**common, "batch": PER, "nbs": 4}
    ranks = _spawn([
        "step", "--model", TINY, "--imgsz", IMGSZ, "--state",
        tmp_path / "state.npz", "--batches", tmp_path / "batches.npz",
        "--steps", ",".join(map(str, STEPS)), "--nb", NB, "--device", "cpu",
        "--overrides", json.dumps(over), "--out", tmp_path / "two"])

    # JAX: the global step under a two-device mesh, b4 a micro-step
    jt = _jax_trainer({**common, "batch": RANKS * PER, "nbs": 8})
    mesh = jax_mesh(shape=(RANKS,))
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = jax_replicate(mesh, v["params"]), jax_replicate(mesh, v["batch_stats"])
    jopt = jax_replicate(mesh, jax_init_opt(v["params"]))
    jema = jax_replicate(mesh, {"params": jax_ema_init(v["params"]),
                                "batch_stats": jax_ema_init(v["batch_stats"])})
    jeu = jnp.int32(0)
    jout = []
    for i, batch in zip(STEPS, batches):
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu, jax_shard(mesh, batch),
            jnp.float32(jt._lr_at(i, "bias")),
            jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        jout.append((float(jtotal), np.stack(jitems)))

    _ok(ranks.result())
    r0, r1 = (np.load(tmp_path / f"two_rank{r}.npz") for r in range(RANKS))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for j, (jtotal, jitems) in enumerate(jout):
        np.testing.assert_allclose(r0[f"items_{j}"], jitems, rtol=3e-5)
        np.testing.assert_allclose(float(r0[f"total_{j}"]), jtotal,
                                   rtol=3e-5)
    assert list(r0["counts"]) == [1, 0, 1] and int(jopt.step) == 1

    want = state_dict_from_jax({"params": jax.device_get(jp),
                                "batch_stats": jax.device_get(jbs)}, tm)
    want_ema = state_dict_from_jax(jax.device_get(jema), tm)
    jbuf = opt_state_from_jax(jax.device_get(jopt), tm)
    t = lambda key: torch.from_numpy(r0[key])
    assert sum(not torch.equal(w, start[k]) for k, w in want.items()) \
        > 0.9 * len(want)
    for k, w in want.items():
        if "running_" in k:
            close(t(f"state/{k}"), w, 2e-6, k)
            close(t(f"ema/{k}"), want_ema[k], 2e-6, k)
            continue
        rel = 2e-2 if k.startswith("model.0.") else 2e-3
        theirs = jbuf.buf[k]
        if theirs.abs().max() > 0:
            close(t(f"buf/{k}"), theirs, rel * float(theirs.abs().max()), k)
        tol = 1e-6 + rel / 2 * float((w - start[k]).abs().max())
        close(t(f"state/{k}"), w, tol, k)
        close(t(f"ema/{k}"), want_ema[k], tol, k)


# ------------------------------------------------------------------ losses
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 1.0}


def _loss_inputs(b=4, nc=3, nq=16, ndl=2, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(8, 8), (4, 4), (2, 2)]
    m = 4
    z = {"nc": np.asarray(nc)}
    # RT-DETR's outputs and labels, the last image without a box
    z["dec_bboxes"] = rng.uniform(0.1, 0.6, (ndl, b, nq, 4)).astype(np.float32)
    z["dec_logits"] = rng.normal(0, 2, (ndl, b, nq, nc)).astype(np.float32)
    z["enc_bboxes"] = rng.uniform(0.1, 0.6, (b, nq, 4)).astype(np.float32)
    z["enc_logits"] = rng.normal(0, 2, (b, nq, nc)).astype(np.float32)
    z["r_cls"] = rng.integers(0, nc, (b, m)).astype(np.float32)
    z["r_bboxes"] = rng.uniform(0.2, 0.6, (b, m, 4)).astype(np.float32)
    z["r_mask_gt"] = (rng.uniform(size=(b, m)) > 0.3).astype(np.float32)
    z["r_mask_gt"][-1] = 0
    z["r_rec"] = np.asarray(0.25, np.float32)
    for i, (h, w) in enumerate(shapes):
        z[f"raw{i}"] = rng.normal(0, 1.0, (b, h, w, 64 + nc)).astype(np.float32)
        z[f"coef{i}"] = rng.normal(0, 0.5, (b, h, w, 8)).astype(np.float32)
        z[f"kmap{i}"] = rng.normal(0, 0.5, (b, h, w, 9)).astype(np.float32)
    z["protos"] = rng.normal(0, 0.5, (b, 16, 16, 8)).astype(np.float32)
    boxes = rng.uniform(0.3, 0.6, (b, m, 4)).astype(np.float32)
    mask_gt = np.concatenate([np.ones((b, m - 1)), np.zeros((b, 1))],
                             1).astype(np.float32)
    mask_gt[-1] = 0                     # an image without a box
    masks = np.zeros((b, 16, 16), np.float32)
    masks[:, :5] = 1
    masks[:, 5:10, 3:12] = 2
    masks[:, 11:, :7] = 3
    for p in ("s", "p"):
        z[f"{p}_cls"] = rng.integers(0, nc, (b, m)).astype(np.float32)
        z[f"{p}_bboxes"] = boxes
        z[f"{p}_mask_gt"] = mask_gt
    z["s_masks"] = masks
    z["p_keypoints"] = np.concatenate([
        boxes[:, :, None, :2] + rng.uniform(-0.1, 0.1, (b, m, 3, 2)),
        rng.integers(0, 3, (b, m, 3, 1))], -1).astype(np.float32)
    return z


def _jax_losses(z):
    """{name: (total, items, grads)} of JAX's losses on the global batch."""
    j = lambda k: jnp.asarray(z[k])
    nc = int(z["nc"])
    out = {}

    def rt(db, dl, eb, el):
        return JR.rtdetr_loss(
            {"dec_bboxes": db, "dec_logits": dl, "enc_bboxes": eb,
             "enc_logits": el},
            {"cls": j("r_cls"), "bboxes": j("r_bboxes"),
             "mask_gt": j("r_mask_gt"), "recovery_loss": j("r_rec")},
            nc=nc, hyp={"lrl": 0.5})
    (t, items), g = jax.jit(jax.value_and_grad(rt, argnums=(0, 1, 2, 3),
                                               has_aux=True))(
        j("dec_bboxes"), j("dec_logits"), j("enc_bboxes"), j("enc_logits"))
    out["rtdetr"] = (t, np.stack([np.asarray(x) for x in items]), list(g))
    raws = [j(f"raw{i}") for i in range(3)]

    def seg(raw, coefs, protos):
        return JL.segmentation_loss(
            raw, coefs, protos, {k: j(f"s_{k}") for k in
                                 ("cls", "bboxes", "mask_gt", "masks")},
            nc=nc, strides=[8, 16, 32], hyp=HYP, max_fg=16, overlap=True)
    (t, items), g = jax.jit(jax.value_and_grad(seg, argnums=(0, 1, 2),
                                               has_aux=True))(
        raws, [j(f"coef{i}") for i in range(3)], j("protos"))
    out["segment"] = (t, np.asarray([float(items[k]) for k in
                                     ("box", "seg", "cls", "dfl")]),
                      list(g[0]) + list(g[1]) + [g[2]])

    def pose(raw, kmaps):
        return JL.pose_loss(
            raw, kmaps, {k: j(f"p_{k}") for k in
                         ("cls", "bboxes", "mask_gt", "keypoints")},
            nc=nc, strides=[8, 16, 32], hyp=HYP, kpt_shape=(3, 3), max_fg=16)
    (t, items), g = jax.jit(jax.value_and_grad(pose, argnums=(0, 1),
                                               has_aux=True))(
        raws, [j(f"kmap{i}") for i in range(3)])
    out["pose"] = (t, np.asarray([float(items[k]) for k in
                                  ("box", "pose", "kobj", "cls", "dfl")]),
                   list(g[0]) + list(g[1]))
    return out


def test_loss_normalisers_over_two_ranks_match_jax_global_batch(tmp_path):
    z = _loss_inputs()
    np.savez(tmp_path / "loss.npz", **z)
    ranks = _spawn(["loss", tmp_path / "loss.npz", tmp_path / "loss"],
                   target=(WORKER,))
    want = _jax_losses(z)
    _ok(ranks.result())
    r = [np.load(tmp_path / f"loss_rank{i}.npz") for i in range(RANKS)]
    for name, (jt, jitems, jgrads) in want.items():
        np.testing.assert_allclose(sum(float(x[f"{name}/total"]) for x in r),
                                   float(jt), rtol=2e-5, err_msg=name)
        np.testing.assert_allclose(sum(x[f"{name}/items"] for x in r),
                                   jitems, rtol=2e-5, atol=1e-7, err_msg=name)
        for i, w in enumerate(jgrads):
            w = np.asarray(w)
            axis = 1 if name == "rtdetr" and i < 2 else 0   # dec: (ndl, B, ...)
            got = np.concatenate([x[f"{name}/grad{i}"] for x in r], axis)
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(got / scale, w / scale, rtol=0,
                                       atol=1e-5, err_msg=f"{name} grad{i}")
