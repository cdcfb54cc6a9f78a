"""Torch port's batched NMS vs the JAX package's (CPU, f32).

Same inputs through both; dets and counts must be EQUAL (the port repeats the
JAX arithmetic op for op), including exact score ties, where both must keep
the lower index first (ROADMAP C2), and a dense scene that fills max_det.
"""

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.ops.nms import non_max_suppression as jax_nms  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402


def _scene(b=3, n=400, nc=4, seed=0, ties=False, dense=False):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 320, (b, n, 2))
    wh = rng.uniform(8, 40 if dense else 120, (b, n, 2))
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, nc)).astype(np.float32)
    if ties:  # quantised scores: many exact ties, also across classes
        scores = np.round(scores * 8) / 8
        boxes[:, n // 2:] = boxes[:, :n // 2]    # duplicate boxes too
    return boxes, scores.astype(np.float32)


def _both(boxes, scores, **kw):
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = non_max_suppression(torch.from_numpy(boxes),
                              torch.from_numpy(scores), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


CASES = {
    "multi_label": dict(multi_label=True),
    "single_label": dict(multi_label=False),
    "agnostic": dict(multi_label=True, agnostic=True),
    "single_agnostic": dict(multi_label=False, agnostic=True),
    "return_idx": dict(multi_label=True, return_idx=True),
    "low_cap": dict(multi_label=True, max_nms=64, max_det=20),
}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_equals_jax(case, ties):
    boxes, scores = _scene(ties=ties, seed=len(case))
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=100, max_nms=512)
    kw.update(CASES[case])
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1].min() > 0


def test_nms_dense_scene_fills_max_det():
    boxes, scores = _scene(b=2, n=3000, nc=3, seed=7, dense=True)
    kw = dict(conf_thres=0.05, iou_thres=0.7, max_det=300, max_nms=2048)
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 300).all()


def test_nms_empty_image_in_batch():
    """An image with nothing above conf ends at once while the others go on."""
    boxes, scores = _scene(b=2, seed=3)
    scores[1] = 0.0
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=50, max_nms=256)
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    dets, counts = got
    assert counts[0] > 0 and counts[1] == 0 and (dets[1, :, 5] == -1).all()
