"""Detection metrics (JAX utils/metrics.py): 101-point interpolated AP, the
per-class P/R/F1 operating point, the TP matrix at 10 IoU thresholds, the
confusion matrix.

Host numpy, as in the JAX package; the pairwise IoU is the port's own
`ops.boxes.box_iou_matrix` in f32 where JAX imports jax.numpy for it. The
fork's quirks stay: `Metric.map75` is the per-class AP@0.75 vector, not its
mean, and `mf1` and `f1s` are there (reference metrics.py:635-696).

`ap_per_class(plot=True)` draws the PR, F1, P and R curves under the JAX
package's file names (`utils/plotting.py`, nothing where matplotlib is
missing); the numbers are the same as with `plot=False`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.boxes import box_iou_matrix

# np.trapz was renamed np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _iou_f32(box1, box2):
    """box_iou_matrix of two numpy xyxy arrays, in f32, as numpy."""
    return box_iou_matrix(torch.as_tensor(np.asarray(box1, np.float32)),
                          torch.as_tensor(np.asarray(box2, np.float32))).numpy()


def smooth(y, f=0.05):
    """Box-filter smoothing (reference metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """101-point interpolated AP (reference metrics.py:418-448)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, plot=False, save_dir=Path("."),
                 names=(), eps=1e-16, prefix=""):
    """Per-class AP at each IoU threshold (reference metrics.py:451-554).

    tp: (N, T) bool TP matrix, conf: (N,), pred_cls: (N,), target_cls: (M,).
    Returns (tp_count, fp_count, p, r, f1, ap, unique_classes). With
    `plot`, the curves go to `save_dir/{prefix}{PR,F1,P,R}_curve.png`,
    labelled by the `names` of the classes that have labels.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px, py = np.linspace(0, 1, 1000), []
    ap = np.zeros((nc, tp.shape[1]))
    p, r = np.zeros((nc, 1000)), np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        m = pred_cls == c
        n_l = nt[ci]
        n_p = m.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[m]).cumsum(0)
        tpc = tp[m].cumsum(0)
        recall = tpc / (n_l + eps)
        r[ci] = np.interp(-px, -conf[m], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[m], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + eps)
    if plot:
        from .plotting import plot_mc_curve, plot_pr_curve
        names_d = {i: v for i, (k, v) in enumerate(
            (k, v) for k, v in dict(names).items() if k in unique_classes)}
        plot_pr_curve(px, py, ap, save_dir / f"{prefix}PR_curve.png", names_d)
        plot_mc_curve(px, f1, save_dir / f"{prefix}F1_curve.png", names_d,
                      ylabel="F1")
        plot_mc_curve(px, p, save_dir / f"{prefix}P_curve.png", names_d,
                      ylabel="Precision")
        plot_mc_curve(px, r, save_dir / f"{prefix}R_curve.png", names_d,
                      ylabel="Recall")
    i = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1 = p[:, i], r[:, i], f1[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int)


def match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls,
                      iouv=np.linspace(0.5, 0.95, 10)):
    """TP matrix: (n_pred, len(iouv)) bool. Mirrors detect/val.py:151-174.

    Boxes xyxy, numpy. For each IoU threshold, greedily match detections to GT
    of the same class, highest-IoU pairs first, each gt/pred used once.
    """
    n_pred = len(pred_cls)
    if n_pred == 0 or len(gt_cls) == 0:
        return np.zeros((n_pred, len(iouv)), dtype=bool)
    iou = _iou_f32(gt_boxes, pred_boxes)
    iou = iou * (gt_cls[:, None] == pred_cls[None, :])
    return match_from_iou(iou, iouv)


def match_from_iou(iou, iouv=np.linspace(0.5, 0.95, 10)):
    """Greedy TP matrix from a class-masked (n_gt, n_pred) IoU matrix.

    Order matters for parity: pairs sort by IoU descending, dedup by
    DETECTION first, then by ground truth — a GT-first dedup gives different
    assignments whenever one GT covers two detections that both also cover
    another GT."""
    n_pred = iou.shape[1]
    correct = np.zeros((n_pred, len(iouv)), dtype=bool)
    for i, t in enumerate(iouv):
        matches = np.array(np.nonzero(iou >= t)).T            # (k, [gt, pred])
        if matches.shape[0]:
            m_iou = iou[matches[:, 0], matches[:, 1]]
            matches = matches[m_iou.argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:177-317)."""

    def __init__(self, nc, conf=0.25, iou_thres=0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections, gt_boxes, gt_cls):
        """detections: (n, 6) [xyxy, conf, cls]; gt_boxes: (m, 4); gt_cls: (m,)."""
        if gt_cls.shape[0] == 0:
            if detections is not None and len(detections):
                det = detections[detections[:, 4] > self.conf]
                for dc in det[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positives
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return

        detections = detections[detections[:, 4] > self.conf]
        gc = gt_cls.astype(int)
        dc = detections[:, 5].astype(int)
        iou = _iou_f32(gt_boxes, detections[:, :4])
        x = np.array(np.nonzero(iou > self.iou_thres)).T
        if x.shape[0]:
            m_iou = iou[x[:, 0], x[:, 1]]
            matches = np.concatenate((x, m_iou[:, None]), 1)
            if x.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, g in enumerate(gc):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[dc[m1[j]][0], g] += 1  # correct
            else:
                self.matrix[self.nc, g] += 1       # background FN
        for i, d in enumerate(dc):
            if not (n and (m1 == i).any()):
                self.matrix[d, self.nc] += 1        # background FP

    def detection_rates(self):
        """Per-class detection rate and miss rate, the true positives of
        each class over its labels (JAX metrics.py:190-195, reference
        perform.py:390-467)."""
        tp = np.diag(self.matrix)[:self.nc]
        total_gt = self.matrix[:, :self.nc].sum(0)
        rate = np.divide(tp, total_gt, out=np.zeros(self.nc),
                         where=total_gt > 0)
        return rate, 1.0 - rate


class Metric:
    """Per-class detection metric container (reference metrics.py:557-708)."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = []
        self.ap_class_index = []
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def mf1(self):
        """Fork extra (metrics.py:635-642)."""
        return self.f1.mean() if len(self.f1) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        """Fork quirk preserved: the *per-class* AP@0.75 array (metrics.py:655-662
        returns all_ap[:, 5] without .mean())."""
        return self.all_ap[:, 5] if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i):
        return self.p[i], self.r[i], self.ap50[i], self.ap[i]

    @property
    def maps(self):
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[c] = self.ap[i]
        return maps

    @property
    def f1s(self):
        """Fork extra: dense per-class F1 (metrics.py:691-696)."""
        f1s = np.zeros(self.nc)
        for i, c in enumerate(self.ap_class_index):
            f1s[c] = self.f1[i] if i < len(self.f1) else 0.0
        return f1s

    def fitness(self):
        """0.1 * mAP50 + 0.9 * mAP50-95 (metrics.py:698-701)."""
        w = [0.0, 0.0, 0.1, 0.9]
        return (np.array(self.mean_results()) * w).sum()

    def update(self, results):
        self.p, self.r, self.f1, self.all_ap, self.ap_class_index = results


class DetMetrics:
    """Aggregate detection metrics (reference metrics.py:711-801)."""

    def __init__(self, save_dir=Path("."), plot=False, names=()):
        self.save_dir = Path(save_dir)
        self.plot = plot
        self.names = dict(names)
        self.box = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0,
                      "postprocess": 0.0}

    def process(self, tp, conf, pred_cls, target_cls):
        results = ap_per_class(tp, conf, pred_cls, target_cls, plot=self.plot,
                               save_dir=self.save_dir, names=self.names)[2:]
        self.box.nc = len(self.names)
        self.box.update(results)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results()

    def class_result(self, i):
        return self.box.class_result(i)

    @property
    def maps(self):
        return self.box.maps

    @property
    def f1s(self):
        return self.box.f1s

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def ap_class_index(self):
        return self.box.ap_class_index

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"],
                        self.mean_results() + [self.fitness]))
