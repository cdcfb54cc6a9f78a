"""Torch port vs the JAX package: the ops of the train step's loss (CPU, f32).

The low-light degrade, the dark-channel priors on images with tied dark
pixels, CIoU, the task-aligned assigner on quantised scores with exact ties,
and the v8 detection loss with the recovery term, on shared numpy-seeded
inputs. Tolerances: 1e-6 absolute where both sides run the same elementwise
f32 ops on values of order 1 (they may differ in a last bit where XLA fuses
differently, and in the order of a mean); the assigner's masks and indices
must be equal; the loss within 1e-5 relative, its sums taken in another
order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.losses.detection import detection_loss as jax_loss  # noqa: E402
from dedark_yolo_tpu.losses.tal import task_aligned_assign as jax_tal  # noqa: E402
from dedark_yolo_tpu.ops.anchors import make_anchors as jax_anchors  # noqa: E402
from dedark_yolo_tpu.ops.boxes import bbox_iou as jax_bbox_iou  # noqa: E402
from dedark_yolo_tpu.ops.dark_channel import (  # noqa: E402
    dark_channel_priors as jax_priors)
from dedark_yolo_tpu.ops.degrade import lowlight_degrade as jax_degrade  # noqa: E402

from dedark_yolo_tpu_torch.losses.detection import detection_loss  # noqa: E402
from dedark_yolo_tpu_torch.losses.tal import task_aligned_assign  # noqa: E402
from dedark_yolo_tpu_torch.ops.boxes import bbox_iou  # noqa: E402
from dedark_yolo_tpu_torch.ops.dark_channel import dark_channel_priors  # noqa: E402
from dedark_yolo_tpu_torch.ops.degrade import lowlight_degrade  # noqa: E402

T = torch.from_numpy
STRIDES = (8, 16, 32)
FEATS = [(8, 8), (4, 4), (2, 2)]          # imgsz 64
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "lrl": 2.0}


@pytest.mark.parametrize("p", [1.0, 3.0, 15.0, 64.0, 2.5, 65.0])
def test_lowlight_degrade_matches_jax(p):
    """Integer exponents 1-64 multiply in integer_pow's order; 2.5 and 65
    go through pow. Inputs outside [0, 1] are clipped first."""
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (2, 9, 7, 3)).astype(np.float32)
    got = lowlight_degrade(T(x), p).numpy()
    want = np.asarray(jax_degrade(jnp.asarray(x), p))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if p == 15.0:
        np.testing.assert_array_equal(got, want)


def test_dark_channel_priors_with_tied_dark_pixels():
    """Values on a 1/4 grid: the brightest dark-channel value is shared by
    far more pixels than the top 0.1% (numpx 4 at 48x96), with different
    colours, so A depends on which tied pixels come first (lower index, as
    jax.lax.top_k; ROADMAP C2)."""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 5, (3, 48, 96, 3)) / 4).astype(np.float32)
    A, ica = dark_channel_priors(T(x))
    jA, jica = jax_priors(jnp.asarray(x))
    dark = x.min(-1).reshape(3, -1)
    assert ((dark == dark.max(1, keepdims=True)).sum(1) > 4).all()
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ica.numpy(), np.asarray(jica), rtol=0, atol=1e-6)
    assert ica.shape == (3, 48, 96, 1)


def _xyxy(rng, shape, lo=0.0, hi=64.0, side=(0.5, 30.0)):
    a = rng.uniform(lo, hi, shape + (2,))
    b = a + rng.uniform(*side, shape + (2,))
    return np.concatenate([a, b], -1).astype(np.float32)


def test_bbox_iou_ciou_and_its_gradient_match_jax():
    """Values and the gradient in box1 (alpha held constant, as the JAX
    stop_gradient does), on broadcast (M, 1) x (1, N) pairs."""
    rng = np.random.default_rng(1)
    b1, b2 = _xyxy(rng, (5, 1)), _xyxy(rng, (1, 40))
    for ciou in (False, True):
        t1 = T(b1).requires_grad_(True)
        got = bbox_iou(t1, T(b2), xywh=False, CIoU=ciou)
        got.sum().backward()

        def f(a):
            return jax_bbox_iou(a, jnp.asarray(b2), xywh=False, CIoU=ciou)
        want = f(jnp.asarray(b1))
        gwant = jax.grad(lambda a: f(a).sum())(jnp.asarray(b1))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t1.grad.numpy(), np.asarray(gwant),
                                   rtol=1e-5, atol=1e-6)


def _assign_inputs(seed=0, b=2, m=5, nc=3):
    """Predictions at imgsz 64 (84 anchors) as a random-weight head gives
    them, then quantised: scores on a 1/4 grid (many exact ties, many 0)
    and small boxes (many miss the GT: metric 0) repeated over pairs of
    anchors, so align metrics tie exactly; GTs with one padding row per
    image."""
    rng = np.random.default_rng(seed)
    anc, st = jax_anchors(FEATS, STRIDES)
    anc_pix = np.asarray(anc * st)
    n = anc_pix.shape[0]
    scores = 1 / (1 + np.exp(-rng.normal(0, 1.5, (b, n, nc))))
    scores = (np.round(scores * 4) / 4).astype(np.float32)
    half = _xyxy(rng, (b, n // 2), 0, 56, side=(0.5, 10.0))
    pd = np.repeat(half, 2, axis=1).astype(np.float32)
    gt = _xyxy(rng, (b, m), 0, 28, side=(12.0, 36.0))
    labels = rng.integers(0, nc, (b, m)).astype(np.float32)
    mask = np.ones((b, m), np.float32)
    mask[:, -1] = 0
    return scores, pd, anc_pix.astype(np.float32), labels, gt, mask


@pytest.mark.parametrize("seed", [0, 1, 3, 4])
def test_task_aligned_assign_matches_jax_on_ties(seed):
    """Seeds whose draw has positives of metric 0: the top-k fills up with
    zero-metric anchors in anchor order, and those inside the GT become
    positives, so a wrong tie order changes fg_mask."""
    scores, pd, anc, labels, gt, mask = _assign_inputs(seed)
    got = task_aligned_assign(T(scores), T(pd), T(anc), T(labels), T(gt),
                              T(mask), num_classes=3)
    want = jax_tal(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc),
                   jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask),
                   num_classes=3)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(),
                                  np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(want.target_labels))
    np.testing.assert_allclose(got.target_scores.numpy(),
                               np.asarray(want.target_scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.target_bboxes.numpy(),
                               np.asarray(want.target_bboxes), rtol=0, atol=1e-6)
    fg = np.asarray(want.fg_mask)
    # the case the tie order decides: positives whose metric is 0
    assert fg.any() and (fg & (np.asarray(want.target_scores).sum(-1) == 0)).any()


def _loss_inputs(seed=0, b=2, m=6, nc=3):
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1.5, (b, h, w, 64 + nc)).astype(np.float32)
           for h, w in FEATS]
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    batch = {"cls": rng.integers(0, nc, (b, m)).astype(np.float32),
             "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
             "mask_gt": (rng.uniform(size=(b, m)) > 0.25).astype(np.float32),
             "recovery_loss": np.float32(rng.uniform(0.01, 0.1))}
    return raw, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_matches_jax(seed):
    """Total and items within 1e-5 relative, and the gradient in the raw
    maps within 1e-5 of its largest entry."""
    raw, batch = _loss_inputs(seed)
    traw = [T(r).requires_grad_(True) for r in raw]
    total, items = detection_loss(traw, {k: T(np.asarray(v)) for k, v in
                                         batch.items()}, 3, STRIDES, HYP)
    total.backward()

    def f(rs):
        return jax_loss(rs, {k: jnp.asarray(v) for k, v in batch.items()},
                        nc=3, strides=STRIDES, hyp=HYP)
    (jt, jitems), jg = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(r) for r in raw])
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=1e-5)
    np.testing.assert_allclose(torch.stack(list(items)).numpy(),
                               np.asarray(jitems), rtol=1e-5)
    assert not any(i.requires_grad for i in items)
    for t, g in zip(traw, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())
