"""Torch port vs the JAX package: the pose loss and one train window (CPU,
f32), on JAX's `POSE_TINY` and its layer-0 variant with numpy-seeded
weights. Bars, each with its reason:
  - `pose_loss`'s five items (box, pose, kobj, cls, dfl) 2e-5 relative and
    the gradients of the detect and keypoint maps 1e-5 of the largest
    (f32 sums in another order than XLA's; the top-k and the assignment
    are integer choices made equal by the equal inputs), with 3 keypoints
    (sigmas 1/3), with COCO's 17 (OKS_SIGMA) and with no foreground;
  - one accumulation window of `PoseTrainer.step` against JAX's
    tree-path train_step: tests/test_torch_train_slice.py's bar on the
    loss items (3e-5 relative).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine import pose as JPose  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.losses import segment as JL  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch.engine.pose import PoseTrainer  # noqa: E402
from dedark_yolo_tpu_torch.losses import segment as TL  # noqa: E402

from test_torch_pose_model import GRAPHS, pose_pair  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 1.0}
NAMES = ("box", "pose", "kobj", "cls", "dfl")


def _loss_inputs(nk, b=2, nc=2, key=0, fg=True):
    rng = np.random.default_rng(key)
    shapes = [(8, 8), (4, 4), (2, 2)]
    raw = [rng.normal(0, 1.0, (b, h, w, 64 + nc)).astype(np.float32)
           for h, w in shapes]
    kmaps = [rng.normal(0, 0.5, (b, h, w, nk * 3)).astype(np.float32)
             for h, w in shapes]
    m = 4
    boxes = rng.uniform(0.3, 0.6, (b, m, 4)).astype(np.float32)
    kpts = np.concatenate([
        boxes[:, :, None, :2] + rng.uniform(-0.1, 0.1, (b, m, nk, 2)),
        rng.integers(0, 3, (b, m, nk, 1))], -1).astype(np.float32)
    batch = {"cls": rng.integers(0, nc, (b, m)).astype(np.float32),
             "bboxes": boxes, "keypoints": kpts,
             "mask_gt": np.concatenate([np.ones((b, m - 1)),
                                        np.zeros((b, 1))], 1).astype(np.float32)}
    if not fg:
        batch["mask_gt"][:] = 0
    return raw, kmaps, batch


@pytest.mark.parametrize("case", ["nk3", "nk17", "no_fg"])
def test_loss_items_and_grads_match_jax(case):
    nk = 17 if case == "nk17" else 3
    raw, kmaps, batch = _loss_inputs(nk, fg=case != "no_fg")

    def jf(raw, kmaps):
        return JL.pose_loss(raw, kmaps,
                            {k: jnp.asarray(a) for k, a in batch.items()},
                            nc=2, strides=[8, 16, 32], hyp=HYP,
                            kpt_shape=(nk, 3), max_fg=16)

    (jt, jitems), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(r) for r in raw], [jnp.asarray(k) for k in kmaps])
    traw = [torch.tensor(r, requires_grad=True) for r in raw]
    tk = [torch.tensor(k, requires_grad=True) for k in kmaps]
    total, items = TL.pose_loss(
        traw, tk, {k: torch.from_numpy(a) for k, a in batch.items()},
        nc=2, strides=[8, 16, 32], hyp=HYP, kpt_shape=(nk, 3), max_fg=16)
    want = np.asarray([float(jitems[k]) for k in NAMES])
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), want,
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=2e-5)
    if case == "no_fg":
        assert float(items.pose) == float(items.kobj) == 0.0
    else:
        assert float(items.pose) > 0 and float(items.kobj) > 0
    grads = torch.autograd.grad(total, traw + tk, allow_unused=True)
    for g, w in zip(grads, list(jg[0]) + list(jg[1])):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-5)


def _pose_batches(b=2, s=64, m=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        boxes = rng.uniform(0.3, 0.6, (b, m, 4)).astype(np.float32)
        kpts = np.concatenate([
            boxes[:, :, None, :2] + rng.uniform(-0.1, 0.1, (b, m, 3, 2)),
            np.full((b, m, 3, 1), 2.0)], -1).astype(np.float32)
        out.append({"img": rng.integers(0, 256, (b, s, s, 3), np.uint8),
                    "cls": np.zeros((b, m), np.float32), "bboxes": boxes,
                    "keypoints": kpts,
                    "mask_gt": np.concatenate([np.ones((b, m - 1)),
                                               np.zeros((b, 1))], 1
                                              ).astype(np.float32)})
    return out


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_train_window_matches_jax(graph):
    """One accumulation window (two micro-steps of b2, nbs 4) at 64:
    PoseTrainer.step against JAX's tree-path train_step of its
    PoseTrainer, SGD inside the warmup ramp."""
    steps, nb = (37, 38), 20
    overrides = {"batch": 2, "nbs": 4, "epochs": 10, "imgsz": 64,
                 "optimizer": "SGD", "lr0": 0.02, "max_boxes": 4}
    jm, v, tm = pose_pair(GRAPHS[graph])
    jt = JPose.PoseTrainer.__new__(JPose.PoseTrainer)
    jt.args = jax_get_cfg(DEFAULT_CFG_DICT, overrides)
    jt.data = {"nc": 1}
    jt.kpt_shape = jm.kpt_shape
    jt.build_optimizer(nb)
    jt._opt_spec = None
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = v["params"], v["batch_stats"]
    jopt = jax_init_opt(jp)
    jema = {"params": jax_ema_init(jp), "batch_stats": jax_ema_init(jbs)}
    jeu = jnp.int32(0)

    tt = PoseTrainer(overrides, model=tm, nb=nb, device="cpu")
    assert (tt.opt_name, tt.accumulate) == (jt.opt_name, jt.accumulate)
    for i, batch in zip(steps, _pose_batches()):
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu,
            {k: jnp.asarray(a) for k, a in batch.items()},
            jnp.float32(jt._lr_at(i, "bias")),
            jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        total, items = tt.step(batch, i)
        np.testing.assert_allclose(items.numpy(), np.stack(jitems), rtol=3e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=3e-5)
    assert tt.opt_state.step == int(jopt.step) == 1 and tt.ema_updates == 1
