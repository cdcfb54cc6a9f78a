"""v8 detection loss with the recovery loss folded in (JAX
losses/detection.py:36-144).

Reference: ultralytics/utils/loss.py:103-193 (v8DetectionLoss), 51-84
(BboxLoss, _df_loss), 388-415 (RcoveryDetectionLoss). Targets come padded per
image, (B, M) classes and (B, M, 4) normalised xywh boxes with a (B, M)
validity mask; fg-masked reductions are masked sums. BCE over every class
logit, summed over target_scores_sum; CIoU box loss and DFL on the two
neighbouring bins, both weighted by each anchor's assigned score; gains
box / cls / dfl; total = sum * batch size; the recovery MSE times lrl is
added to the total and to the cls item.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou, xywh2xyxy
from ..parallel.mesh import global_sum
from .tal import task_aligned_assign


class LossItems(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_logits(logits, targets):
    """Elementwise binary cross-entropy with logits, the JAX package's form,
    with jnp's derivatives at a logit of exactly 0 (a bf16 head map has
    them): `maximum` splits the tie (1/2), `abs` takes the positive side
    (clamp and torch's abs would give 1 and 0)."""
    pos = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-pos)))


def _df_loss(pred_dist_logits, target, reg_max):
    """Distribution focal loss (reference loss.py:75-84): (..., 4, reg_max)
    logits and (..., 4) targets in [0, reg_max - 1) -> (...,) the mean over
    the 4 sides of the cross-entropy on the two bins around each target."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist_logits, dim=-1)
    ce_l = -torch.gather(logp, -1, tl[..., None]).squeeze(-1)
    ce_r = -torch.gather(logp, -1, tr.clamp(0, reg_max - 1)[..., None]).squeeze(-1)
    return (ce_l * wl + ce_r * wr).mean(dim=-1)


def detection_loss(raw_maps: Sequence[torch.Tensor], batch: dict, nc: int,
                   strides: Sequence[int], hyp: dict, reg_max: int = 16,
                   tal_topk: int = 10, group=None):
    """(total, LossItems) from the train-mode head maps.

    raw_maps: per-level (B, H, W, 4*reg_max + nc). batch: 'cls' (B, M) class
    ids, 'bboxes' (B, M, 4) xywh in [0, 1], 'mask_gt' (B, M), and optionally
    'recovery_loss', a scalar. hyp: gains 'box', 'cls', 'dfl', 'lrl'. The
    items are detached.

    `group` (a mesh's group of several ranks): this rank's share of the
    global batch's loss, as JAX's sharded step computes it: the target
    score sum and the batch size are summed over the group (detached)
    before the clamp and the division (JAX losses/detection.py:110-136),
    so the ranks' totals and items add up to the global ones.
    """
    b, no = raw_maps[0].shape[0], raw_maps[0].shape[-1]
    feat_shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchor_points, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                           device=raw_maps[0].device)

    x = torch.cat([m.reshape(b, -1, no) for m in raw_maps], 1)
    pred_distri = x[..., :4 * reg_max]                     # (B,N,64) logits
    pred_scores = x[..., 4 * reg_max:]                     # (B,N,nc) logits

    imgsz_h = feat_shapes[0][0] * strides[0]
    imgsz_w = feat_shapes[0][1] * strides[0]
    # xywh times (w, h, w, h), written per coordinate: a scale tensor built
    # from a list would be a host-to-device copy, which waits on the stream
    bx, by, bw, bh = batch["bboxes"].to(x.dtype).unbind(-1)
    pixels = torch.stack([bx * imgsz_w, by * imgsz_h, bw * imgsz_w,
                          bh * imgsz_h], -1)

    mask_gt = batch["mask_gt"].to(x.dtype)
    # padding rows must not pass the in-GT test: zero their boxes, as the
    # reference's zero-padded preprocess output is (loss.py:132-138)
    gt_bboxes = xywh2xyxy(pixels) * mask_gt[..., None]

    pred_bboxes = dist2bbox(dfl_decode(pred_distri, reg_max), anchor_points[None],
                            xywh=False)                    # grid units

    assign = task_aligned_assign(
        torch.sigmoid(pred_scores.detach()),
        pred_bboxes.detach() * stride_t[None], anchor_points * stride_t,
        batch["cls"], gt_bboxes, mask_gt, num_classes=nc, topk=tal_topk,
        alpha=0.5, beta=6.0)
    target_scores = assign.target_scores
    target_scores_sum, gb = global_sum(group, target_scores.sum(), b)
    target_scores_sum = target_scores_sum.clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores, target_scores).sum() / target_scores_sum

    tb = assign.target_bboxes / stride_t[None]             # grid units
    weight = target_scores.sum(-1) * assign.fg_mask.to(x.dtype)   # (B,N)
    iou = bbox_iou(pred_bboxes, tb, xywh=False, CIoU=True).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], tb, reg_max - 1)
    dfl = _df_loss(pred_distri.reshape(b, -1, 4, reg_max), target_ltrb, reg_max)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    loss_box = loss_box * hyp["box"]
    loss_cls = loss_cls * hyp["cls"]
    loss_dfl = loss_dfl * hyp["dfl"]
    total = (loss_box + loss_cls + loss_dfl) * gb

    rec = batch.get("recovery_loss")
    if rec is not None:
        rec = rec.mean()
        lrl = hyp.get("lrl", 0.0)
        total = total + lrl * rec
        loss_cls = loss_cls + lrl * rec

    return total, LossItems(loss_box.detach(), loss_cls.detach(),
                            loss_dfl.detach())
