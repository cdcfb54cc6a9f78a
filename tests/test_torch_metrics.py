"""Torch port vs the JAX package: the detection metrics (host numpy, f32 IoU).

Same seeded numpy inputs through `dedark_yolo_tpu.utils.metrics` and
`dedark_yolo_tpu_torch.utils.metrics`. The metrics are the same numpy code
on the same inputs, so AP, P, R and F1 agree to 1e-12 (in practice bit for
bit); the IoU is f32 in both (jax.numpy there, torch here) in one operation
order, so the TP matrices and the confusion matrices must be equal, also
where an IoU sits exactly on a threshold. Plus the golden values of
tests/test_metrics_golden.py, computed once from the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.utils import metrics as J  # noqa: E402

from dedark_yolo_tpu_torch.ops.boxes import box_iou_matrix, xyxy2xywh  # noqa: E402
from dedark_yolo_tpu_torch.utils import metrics as T  # noqa: E402

import test_metrics_golden as G  # noqa: E402

TOL = 1e-12
IOUV = np.linspace(0.5, 0.95, 10)


def random_tp_inputs(seed, n=400, nc=4):
    rng = np.random.default_rng(seed)
    tp = np.zeros((n, 10), bool)
    # nested TP rows, as the validator makes them: true up to a threshold
    reach = rng.integers(-3, 11, n)
    tp[:] = np.arange(10)[None, :] < reach[:, None]
    conf = rng.uniform(0, 1, n).round(3)          # ties in conf
    pred_cls = rng.integers(0, nc, n).astype(float)
    target_cls = rng.integers(0, nc - 1, 120).astype(float)  # a class with no GT
    return tp, conf, pred_cls, target_cls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_matches_jax(seed):
    args = random_tp_inputs(seed)
    want = J.ap_per_class(*args)
    got = T.ap_per_class(*args)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[-1], want[-1])


def boxes_on_thresholds(rng, n_gt=12):
    """GT boxes and, per GT and threshold, a detection inside it whose area
    is that share of the GT's: IoU exactly on each of the 10 thresholds
    (up to f32 rounding, the same in both packages); plus random boxes."""
    x1 = rng.integers(0, 200, n_gt).astype(np.float32)
    y1 = rng.integers(0, 200, n_gt).astype(np.float32)
    w = np.full(n_gt, 100, np.float32)
    h = rng.integers(20, 120, n_gt).astype(np.float32)
    gt = np.stack([x1, y1, x1 + w, y1 + h], 1)
    dets = [np.stack([x1, y1, x1 + w * t, y1 + h], 1) for t in IOUV]
    dets.append(np.sort(rng.uniform(0, 320, (40, 4)), 1)[:, [0, 1, 2, 3]]
                .astype(np.float32))
    return gt, np.concatenate(dets).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt, det = boxes_on_thresholds(rng)
    gt_cls = rng.integers(0, 3, len(gt)).astype(np.float32)
    det_cls = np.concatenate([np.tile(gt_cls, 10),
                              rng.integers(0, 3, 40).astype(np.float32)])
    flip = rng.uniform(size=len(det_cls)) < 0.1       # some wrong classes
    det_cls[flip] = (det_cls[flip] + 1) % 3
    got = T.match_predictions(det, det_cls, gt, gt_cls)
    want = J.match_predictions(det, det_cls, gt, gt_cls)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    # the f32 IoU itself, in the JAX package's operation order
    import jax.numpy as jnp
    from dedark_yolo_tpu.ops.boxes import box_iou_matrix as jax_iou
    np.testing.assert_array_equal(
        box_iou_matrix(torch.from_numpy(gt), torch.from_numpy(det)).numpy(),
        np.asarray(jax_iou(jnp.asarray(gt), jnp.asarray(det))))
    assert T.match_predictions(det[:0], det_cls[:0], gt, gt_cls).shape == (0, 10)
    assert not T.match_predictions(det, det_cls, gt[:0], gt_cls[:0]).any()


def test_xyxy2xywh_matches_jax():
    import jax.numpy as jnp
    from dedark_yolo_tpu.ops.boxes import xyxy2xywh as jax_xyxy2xywh
    b = np.sort(np.random.default_rng(0).uniform(0, 99, (20, 4)), 1)
    b = b.astype(np.float32)
    np.testing.assert_array_equal(xyxy2xywh(torch.from_numpy(b)).numpy(),
                                  np.asarray(jax_xyxy2xywh(jnp.asarray(b))))


def confusion_cases(rng):
    gt, det = boxes_on_thresholds(rng, n_gt=8)
    gt_cls = rng.integers(0, 3, len(gt)).astype(np.float32)
    dets = np.concatenate([det, rng.uniform(0, 1, (len(det), 1)),
                           rng.integers(0, 3, (len(det), 1))], 1).astype(np.float32)
    none6 = np.zeros((0, 6), np.float32)
    return [("both", dets, gt, gt_cls),
            ("no_gt", dets, gt[:0], gt_cls[:0]),
            ("no_dets", none6, gt, gt_cls),
            ("dets_none", None, gt, gt_cls),
            ("neither", none6, gt[:0], gt_cls[:0]),
            ("one_match", dets[:1], gt[:1], gt_cls[:1])]


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    j, t = J.ConfusionMatrix(nc=3), T.ConfusionMatrix(nc=3)
    for name, dets, gt, gt_cls in confusion_cases(rng):
        j.process_batch(dets, gt, gt_cls)
        t.process_batch(dets, gt, gt_cls)
        np.testing.assert_array_equal(t.matrix, j.matrix, err_msg=name)
    assert t.matrix.sum() > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_det_metrics_matches_jax(seed):
    names = {0: "a", 1: "b", 2: "c", 3: "d", 4: "e"}
    args = random_tp_inputs(seed)
    j, t = J.DetMetrics(names=names), T.DetMetrics(names=names)
    j.process(*args)
    t.process(*args)
    assert t.results_dict.keys() == j.results_dict.keys()
    for k, v in j.results_dict.items():
        assert abs(t.results_dict[k] - v) <= TOL, k
    assert abs(t.fitness - j.fitness) <= TOL
    for a, b in ((t.maps, j.maps), (t.f1s, j.f1s), (t.box.map75, j.box.map75),
                 (t.box.ap50, j.box.ap50)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # the fork's quirk: map75 is the per-class vector
    assert np.ndim(t.box.map75) == 1 and len(t.box.map75) == len(t.ap_class_index)
    assert abs(t.box.mf1 - j.box.mf1) <= TOL
    np.testing.assert_array_equal(t.ap_class_index, j.ap_class_index)
    for i in range(len(t.ap_class_index)):
        np.testing.assert_allclose(t.class_result(i), j.class_result(i),
                                   rtol=0, atol=TOL)
    # nothing processed: the empty container's defaults
    assert T.DetMetrics(names=names).results_dict == \
        J.DetMetrics(names=names).results_dict


def test_metrics_golden_values():
    _, _, p, r, f1, ap, uc = T.ap_per_class(G.TP, G.CONF, G.PRED_CLS,
                                            G.TARGET_CLS)
    np.testing.assert_array_equal(uc, [0, 1, 2])
    for got, gold in ((p, G.GOLD_P), (r, G.GOLD_R), (f1, G.GOLD_F1),
                      (ap, G.GOLD_AP), (p.mean(), G.GOLD_MP),
                      (r.mean(), G.GOLD_MR), (ap[:, 0].mean(), G.GOLD_MAP50),
                      (ap.mean(), G.GOLD_MAP)):
        np.testing.assert_allclose(got, gold, rtol=1e-10)
    tp = T.match_predictions(G.DET[:, :4], G.DET[:, 5], G.GT_BOXES, G.GT_CLS)
    np.testing.assert_array_equal(tp, G.GOLD_TP)
