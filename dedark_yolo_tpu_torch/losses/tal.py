"""Task-aligned assigner in fixed shapes (JAX losses/tal.py:42-158).

Reference: ultralytics/utils/tal.py:57-244 (TaskAlignedAssigner, topk=10,
alpha=0.5, beta=6.0 as v8DetectionLoss uses it). Every step is a masked dense
op over the (B, M, N) grid of GT boxes by anchors, as in the JAX package:
anchors inside each GT, the align metric s^alpha * CIoU^beta, its top-k per
GT, anchors claimed by several GTs given to the one of highest overlap, and
the target scores normalised per GT. Where the JAX package contracts one-hot
matrices (cheaper than a gather on a TPU), the port gathers: the same values,
since each one-hot row has one nonzero term.

Ties: the JAX top-k (`jax.lax.top_k`, whole or in chunks) keeps the lower
anchor index first among equal metrics, so `_select_topk` is a stable
descending sort over the anchor axis, sliced (ROADMAP C2). Ties are common:
the metric is 0 wherever the clipped CIoU or the score is 0, and zero-metric
anchors inside a GT are positives whenever fewer than `topk` anchors have a
positive metric.

Everything here runs without gradient, as the reference decorates the
assigner with @torch.no_grad().
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (B, N) int32
    target_bboxes: torch.Tensor   # (B, N, 4) xyxy
    target_scores: torch.Tensor   # (B, N, nc)
    fg_mask: torch.Tensor         # (B, N) bool
    target_gt_idx: torch.Tensor   # (B, N) int32


def select_candidates_in_gts(xy_centers, gt_bboxes, eps=1e-9):
    """(N, 2) anchor centres inside (B, M, 4) xyxy GTs -> (B, M, N) 0/1."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]],
                       dim=-1)
    return (deltas.amin(dim=-1) > eps).to(gt_bboxes.dtype)


def _select_topk(metrics, topk, valid_mask):
    """Top-k anchors of each (b, m), lower index first among equal metrics
    -> (B, M, N) 0/1 mask; rows of invalid GTs (valid_mask (B, M) False) are
    0. An anchor is picked at most once per GT, so the reference's
    picked-twice guard never fires."""
    n = metrics.shape[-1]
    k = min(topk, n)
    _, idx = torch.sort(metrics, dim=-1, descending=True, stable=True)
    mask = torch.zeros_like(metrics)
    mask.scatter_(-1, idx[..., :k], 1.0)
    return mask * valid_mask[..., None].to(metrics.dtype)


def align_metrics(pd_scores, pd_bboxes, anc_points, labels, gt_bboxes,
                  mask_gt_f, alpha=0.5, beta=6.0):
    """(B, M, N) anchors inside each valid GT, their clipped CIoU with it,
    and the align metric s^alpha * CIoU^beta (0 outside)."""
    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
    bbox_scores = torch.gather(
        pd_scores.transpose(1, 2), 1,
        labels[..., None].expand(-1, -1, pd_scores.shape[1]))
    pre_mask = mask_in_gts * mask_gt_f[..., None]
    bbox_scores = bbox_scores * pre_mask
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :],
                        xywh=False, CIoU=True).squeeze(-1)
    overlaps = overlaps.clamp(min=0.0) * pre_mask
    if alpha == 0.5 and beta == 6.0:
        o2 = overlaps * overlaps
        align_metric = torch.sqrt(bbox_scores) * (o2 * o2 * o2)
    else:
        align_metric = bbox_scores.pow(alpha) * overlaps.pow(beta)
    return mask_in_gts, overlaps, align_metric


@torch.no_grad()
def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                        mask_gt, num_classes, topk=10, alpha=0.5, beta=6.0,
                        eps=1e-9):
    """The task-aligned assignment.

    pd_scores (B, N, nc) sigmoid class probabilities; pd_bboxes (B, N, 4)
    xyxy in the units of gt_bboxes; anc_points (N, 2) anchor centres (same
    units); gt_labels (B, M) class ids; gt_bboxes (B, M, 4) xyxy; mask_gt
    (B, M), 1 for real boxes, 0 for padding.
    """
    dtype = pd_scores.dtype
    m = gt_bboxes.shape[1]
    mask_gt_f = mask_gt.to(dtype)
    labels = gt_labels.long().clamp(0, pd_scores.shape[-1] - 1)      # (B,M)
    mask_in_gts, overlaps, align_metric = align_metrics(
        pd_scores, pd_bboxes, anc_points, labels, gt_bboxes, mask_gt_f,
        alpha, beta)

    mask_topk = _select_topk(align_metric, topk, mask_gt_f > 0)
    mask_pos = mask_topk * mask_in_gts * mask_gt_f[..., None]       # (B,M,N)

    # an anchor claimed by several GTs goes to the GT of highest overlap
    fg_counts = mask_pos.sum(dim=1)                                 # (B,N)
    is_max = F.one_hot(overlaps.argmax(dim=1), m).to(dtype).transpose(1, 2)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=1) > 0                               # (B,N)
    target_gt_idx = mask_pos.argmax(dim=1)                          # (B,N)

    target_labels = torch.gather(labels, 1, target_gt_idx)          # (B,N)
    target_bboxes = torch.gather(
        gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, 4))   # (B,N,4)
    target_scores = F.one_hot(target_labels, num_classes).to(dtype)
    target_scores = target_scores * fg_mask[..., None].to(dtype)

    # normalise by each GT's best metric and overlap (tal.py:120-125)
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(dim=-1, keepdim=True)             # (B,M,1)
    pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(dim=1)
    target_scores = target_scores * norm[..., None]

    return AssignResult(target_labels.int(), target_bboxes, target_scores,
                        fg_mask, target_gt_idx.int())
