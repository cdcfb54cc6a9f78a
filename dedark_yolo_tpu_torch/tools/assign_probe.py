"""Record the task-aligned assigner's decisions, and how close each came
to going the other way, on every call of the v8 loss.

Within `record()`, each call of the assigner appends one dict: the
foreground mask and each foreground anchor's GT (CPU tensors), and two
margins, relative to the larger value compared:
  - `topk`: over the valid GTs, the least gap between the k-th and the
    (k+1)-th align metric (only where the k-th is positive: zero metrics
    tie and go by anchor index, which no sum order changes);
  - `claim`: over the anchors claimed by several GTs, the least gap between
    the two largest overlaps.
`flips(a, b)` counts the anchors two runs assigned otherwise, call by call.
A margin near float32's rounding error (1e-7 relative) is one that another
summation order of the same forward can cross.

    from dedark_yolo_tpu_torch.tools import assign_probe
    with assign_probe.record() as calls:
        trainer.step(batch, i)
"""

from __future__ import annotations

import contextlib

import torch

from ..losses import detection, tal


def _rel_gap(hi, lo):
    return (hi - lo) / hi.clamp(min=torch.finfo(hi.dtype).tiny)


def margins(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
            num_classes, topk=10, alpha=0.5, beta=6.0, eps=1e-9):
    """(topk margin, claim margin) of one assigner call (inf where no
    decision of that kind was made)."""
    dtype = pd_scores.dtype
    mask_gt_f = mask_gt.to(dtype)
    labels = gt_labels.long().clamp(0, pd_scores.shape[-1] - 1)
    mask_in_gts, overlaps, metric = tal.align_metrics(
        pd_scores, pd_bboxes, anc_points, labels, gt_bboxes, mask_gt_f,
        alpha, beta)
    inf = float("inf")
    k = min(topk, metric.shape[-1] - 1)
    top = metric.sort(dim=-1, descending=True).values[..., :k + 1]
    at = (mask_gt_f > 0) & (top[..., k - 1] > 0)
    topk_margin = (float(_rel_gap(top[..., k - 1], top[..., k])[at].min())
                   if at.any() else inf)
    res = tal.task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels,
                                  gt_bboxes, mask_gt, num_classes, topk,
                                  alpha, beta, eps)
    pos = tal._select_topk(metric, topk, mask_gt_f > 0) * mask_in_gts \
        * mask_gt_f[..., None]
    claimed = pos.sum(dim=1) > 1                                    # (B,N)
    two = overlaps.transpose(1, 2)[claimed].topk(2, dim=-1).values  # (n,2)
    claim_margin = (float(_rel_gap(two[:, 0], two[:, 1]).min())
                    if len(two) else inf)
    return res, topk_margin, claim_margin


@contextlib.contextmanager
def record():
    """Within the block, every assigner call of the v8 loss appends
    {"fg", "gt", "topk", "claim"} to the yielded list."""
    calls = []
    orig = detection.task_aligned_assign

    def recorded(*args, **kwargs):
        with torch.no_grad():
            res, t, c = margins(*args, **kwargs)
        calls.append({"fg": res.fg_mask.cpu(),
                      "gt": res.target_gt_idx.cpu(), "topk": t, "claim": c})
        return res

    detection.task_aligned_assign = recorded
    try:
        yield calls
    finally:
        detection.task_aligned_assign = orig


def flips(a, b):
    """Per call, the anchors that two recordings assigned otherwise: in one
    run's foreground and not the other's, or to another GT."""
    out = []
    for x, y in zip(a, b):
        both = x["fg"] & y["fg"]
        out.append(int((x["fg"] ^ y["fg"]).sum() + (both & (x["gt"] != y["gt"])).sum()))
    return out
