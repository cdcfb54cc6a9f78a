"""The segment loss in fixed shapes (JAX losses/segment.py:30-141).

Reference: ultralytics/utils/loss.py:196-288 (v8SegmentationLoss,
single_mask_loss) and utils/ops.py:553-570 (crop_mask). The detect part is
the v8 loss of `losses/detection.py` on the same task-aligned assignment
(`_assign`). The mask part, as in JAX: each image contributes a static
`max_fg` foreground anchors, the top ones by their summed target score
(`_topk_fg`, ties to the lower anchor index as `lax.top_k` breaks them);
padding anchors weigh 0. Their mask logits are coefficients @ protos, the
BCE against the assigned instance's mask is cropped to the target box in
mask pixels, averaged over the mask and divided by the box's normalised
area. With max_fg at least the true foreground count the loss is the
reference's; otherwise the strongest assignments are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou, xywh2xyxy, xyxy2xywh
from .detection import _bce_logits, _df_loss
from .tal import task_aligned_assign


class SegLossItems(NamedTuple):
    box: torch.Tensor
    seg: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def crop_mask(masks, boxes_xyxy):
    """Zero the mask pixels outside their box: masks (..., h, w), boxes
    (..., 4) xyxy in mask pixels; a pixel at column c, row r is kept when
    x1 <= c < x2 and y1 <= r < y2."""
    h, w = masks.shape[-2], masks.shape[-1]
    c = torch.arange(w, dtype=masks.dtype, device=masks.device)[None, :]
    r = torch.arange(h, dtype=masks.dtype, device=masks.device)[:, None]
    x1, y1, x2, y2 = (boxes_xyxy[..., k][..., None, None] for k in range(4))
    keep = (c >= x1) & (c < x2) & (r >= y1) & (r < y2)
    return masks * keep.to(masks.dtype)


def _assign(raw_maps, batch, nc, strides, reg_max):
    """The detect assignment of the train-mode maps (JAX :45-70): (assign,
    pred_scores, pred_distri, pred_bboxes in grid units, anchor_points,
    stride_t, (imgsz_h, imgsz_w))."""
    b, no = raw_maps[0].shape[0], raw_maps[0].shape[-1]
    feat_shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchor_points, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                           device=raw_maps[0].device)
    x = torch.cat([m.reshape(b, -1, no) for m in raw_maps], 1)
    pred_distri, pred_scores = x[..., :4 * reg_max], x[..., 4 * reg_max:]
    imgsz_h = feat_shapes[0][0] * strides[0]
    imgsz_w = feat_shapes[0][1] * strides[0]
    bx, by, bw, bh = batch["bboxes"].to(x.dtype).unbind(-1)
    pixels = torch.stack([bx * imgsz_w, by * imgsz_h, bw * imgsz_w,
                          bh * imgsz_h], -1)
    mask_gt = batch["mask_gt"].to(x.dtype)
    gt_bboxes = xywh2xyxy(pixels) * mask_gt[..., None]
    pred_bboxes = dist2bbox(dfl_decode(pred_distri, reg_max),
                            anchor_points[None], xywh=False)
    assign = task_aligned_assign(
        torch.sigmoid(pred_scores.detach()),
        pred_bboxes.detach() * stride_t[None], anchor_points * stride_t,
        batch["cls"], gt_bboxes, mask_gt, num_classes=nc)
    return (assign, pred_scores, pred_distri, pred_bboxes, anchor_points,
            stride_t, (imgsz_h, imgsz_w))


def _topk_fg(assign, max_fg):
    """The static top-`max_fg` foreground anchors of each image by summed
    target score (JAX :73-79): (idx (B, K), weight (B, K) 0/1). A
    foreground anchor's key is its score + 1e-6, a background one's 0; a
    stable descending sort puts the lower index first among equal keys, as
    `lax.top_k` does. K is max_fg, or the anchor count where that is
    smaller."""
    score = assign.target_scores.sum(-1)
    fg = assign.fg_mask.to(score.dtype)
    key = score * fg + fg * 1e-6
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    k = min(int(max_fg), key.shape[-1])
    return idx[:, :k], (vals[:, :k] > 0).to(torch.float32)


def segmentation_loss(raw_maps, coef_maps, protos, batch, nc, strides, hyp,
                      reg_max=16, max_fg=64, overlap=True):
    """(total, SegLossItems) from the Segment head's train-mode outputs.

    raw_maps: per-level (B, H, W, 4*reg_max + nc); coef_maps: per-level (B,
    H, W, nm); protos (B, mh, mw, nm). batch: 'cls' (B, M), 'bboxes' (B, M,
    4) normalised xywh, 'mask_gt' (B, M) and 'masks': with `overlap` (B,
    mh, mw), each pixel the index + 1 of the instance on top (0 none), else
    (B, M, mh, mw) one mask an instance. hyp: gains 'box', 'cls', 'dfl';
    the mask loss takes the box gain, as the reference's does. The items
    are detached.
    """
    (assign, pred_scores, pred_distri, pred_bboxes, anchor_points, stride_t,
     (imgsz_h, imgsz_w)) = _assign(raw_maps, batch, nc, strides, reg_max)
    b = pred_scores.shape[0]
    tss = assign.target_scores.sum().clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / tss
    fg = assign.fg_mask.to(pred_scores.dtype)
    tb = assign.target_bboxes / stride_t[None]
    weight = assign.target_scores.sum(-1) * fg
    iou = bbox_iou(pred_bboxes, tb, CIoU=True).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    target_ltrb = bbox2dist(anchor_points[None], tb, reg_max - 1)
    loss_dfl = (_df_loss(pred_distri.reshape(b, -1, 4, reg_max), target_ltrb,
                         reg_max) * weight).sum() / tss

    nm = protos.shape[-1]
    mh, mw = protos.shape[1], protos.shape[2]
    coefs = torch.cat([m.reshape(b, -1, nm) for m in coef_maps], 1)
    idx, w_fg = _topk_fg(assign, max_fg)                          # (B, K)
    sel_coef = torch.gather(coefs, 1, idx[..., None].expand(-1, -1, nm))
    sel_gt = torch.gather(assign.target_gt_idx.long(), 1, idx)   # (B, K)
    sel_box = torch.gather(assign.target_bboxes, 1,
                           idx[..., None].expand(-1, -1, 4))
    pred_masks = torch.einsum("bkn,bhwn->bkhw", sel_coef, protos)
    masks = batch["masks"].to(torch.float32)
    if overlap:
        gt_masks = (masks[:, None] == (sel_gt[..., None, None].float() + 1.0)
                    ).to(torch.float32)
    else:
        gt_masks = torch.gather(masks, 1, sel_gt[..., None, None].expand(
            -1, -1, mh, mw))
    sx, sy = mw / imgsz_w, mh / imgsz_h
    x1, y1, x2, y2 = sel_box.unbind(-1)
    mxyxy = torch.stack([x1 * sx, y1 * sy, x2 * sx, y2 * sy], -1)
    xyxyn = torch.stack([x1 / imgsz_w, y1 / imgsz_h, x2 / imgsz_w,
                         y2 / imgsz_h], -1)
    wh = xyxy2xywh(xyxyn)
    marea = (wh[..., 2] * wh[..., 3]).clamp(min=1e-4)
    mloss = crop_mask(_bce_logits(pred_masks, gt_masks), mxyxy)
    mloss = mloss.mean((-2, -1)) / marea                          # (B, K)
    denom = w_fg.sum(1).clamp(min=1.0)
    loss_seg = ((mloss * w_fg).sum(1) / denom).sum()

    loss_box = loss_box * hyp["box"]
    loss_seg = loss_seg * hyp["box"] / b
    loss_cls = loss_cls * hyp["cls"]
    loss_dfl = loss_dfl * hyp["dfl"]
    total = (loss_box + loss_seg + loss_cls + loss_dfl) * b
    return total, SegLossItems(loss_box.detach(), loss_seg.detach(),
                               loss_cls.detach(), loss_dfl.detach())
