"""The segment and pose losses in fixed shapes (JAX losses/segment.py:
24-219).

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
reference's; otherwise the strongest assignments are kept. The pose loss
(reference loss.py:291-377, v8PoseLoss and KeypointLoss) takes the same
detect terms and the same top-`max_fg` anchors: the OKS keypoint loss of
their decoded keypoints against the assigned instance's, in grid units of
each anchor's stride, and the visibility BCE (`kobj`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou, xywh2xyxy, xyxy2xywh
from ..parallel.mesh import global_sum
from .detection import _bce_logits, _df_loss
from .tal import task_aligned_assign


# COCO keypoint OKS sigmas (reference metrics.py OKS_SIGMA, JAX :24-25)
OKS_SIGMA = torch.tensor(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07,
     1.07, 0.87, 0.87, 0.89, 0.89], dtype=torch.float32) / 10.0


class SegLossItems(NamedTuple):
    box: torch.Tensor
    seg: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


class PoseLossItems(NamedTuple):
    box: torch.Tensor
    pose: torch.Tensor
    kobj: torch.Tensor
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
                      reg_max=16, max_fg=64, overlap=True, group=None):
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
    loss_box, loss_cls, loss_dfl, gb = _detect_terms(
        assign, pred_scores, pred_distri, pred_bboxes, anchor_points,
        stride_t, reg_max, group)

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
    loss_seg = loss_seg * hyp["box"] / gb
    loss_cls = loss_cls * hyp["cls"]
    loss_dfl = loss_dfl * hyp["dfl"]
    total = (loss_box + loss_seg + loss_cls + loss_dfl) * gb
    return total, SegLossItems(loss_box.detach(), loss_seg.detach(),
                               loss_cls.detach(), loss_dfl.detach())


def _detect_terms(assign, pred_scores, pred_distri, pred_bboxes,
                  anchor_points, stride_t, reg_max, group=None):
    """(loss_box, loss_cls, loss_dfl) of the assignment, each / the target
    score sum (over `group`'s batch), before the gains (JAX :152-167), and
    the batch size (over `group`'s batch)."""
    b = pred_scores.shape[0]
    tss, gb = global_sum(group, assign.target_scores.sum(), b)
    tss = tss.clamp(min=1.0)
    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / tss
    fg = assign.fg_mask.to(pred_scores.dtype)
    tb = assign.target_bboxes / stride_t[None]
    weight = assign.target_scores.sum(-1) * fg
    iou = bbox_iou(pred_bboxes, tb, xywh=False, CIoU=True).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    target_ltrb = bbox2dist(anchor_points[None], tb, reg_max - 1)
    loss_dfl = (_df_loss(pred_distri.reshape(b, -1, 4, reg_max), target_ltrb,
                         reg_max) * weight).sum() / tss
    return loss_box, loss_cls, loss_dfl, gb


def pose_loss(raw_maps, kpt_maps, batch, nc, strides, hyp, kpt_shape=(17, 3),
              reg_max=16, max_fg=64, group=None):
    """(total, PoseLossItems) from the Pose head's train-mode outputs (JAX
    :144-210).

    raw_maps: per-level (B, H, W, 4*reg_max + nc); kpt_maps: per-level (B,
    H, W, nk * kdim). batch: 'cls', 'bboxes', 'mask_gt' as detect's and
    'keypoints' (B, M, nk, 3) normalised x, y and visibility. hyp: gains
    'box', 'cls', 'dfl', 'pose' (12.0 where absent) and 'kobj' (1.0). The
    items are detached.
    """
    (assign, pred_scores, pred_distri, pred_bboxes, anchor_points, stride_t,
     (imgsz_h, imgsz_w)) = _assign(raw_maps, batch, nc, strides, reg_max)
    b = pred_scores.shape[0]
    loss_box, loss_cls, loss_dfl, gb = _detect_terms(
        assign, pred_scores, pred_distri, pred_bboxes, anchor_points,
        stride_t, reg_max, group)

    nk, kdim = kpt_shape
    kpts = torch.cat([m.reshape(b, -1, nk, kdim) for m in kpt_maps], 1)
    xy = kpts[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
    pred_kpts = torch.cat([xy, kpts[..., 2:]], -1) if kdim == 3 else xy

    idx, w_fg = _topk_fg(assign, max_fg)                          # (B, K)
    k = idx.shape[1]
    sel_gt = torch.gather(assign.target_gt_idx.long(), 1, idx)
    sel_kpt = torch.gather(pred_kpts.reshape(b, -1, nk * kdim), 1,
                           idx[..., None].expand(-1, -1, nk * kdim)
                           ).reshape(b, k, nk, kdim)
    sel_stride = torch.gather(stride_t[None, :, 0].expand(b, -1), 1, idx)
    sel_box = torch.gather(assign.target_bboxes, 1,
                           idx[..., None].expand(-1, -1, 4))
    gt_k = batch["keypoints"].to(torch.float32) * torch.tensor(
        [imgsz_w, imgsz_h, 1.0], dtype=torch.float32, device=idx.device)
    sel_gt_k = torch.gather(gt_k.reshape(b, -1, nk * 3), 1,
                            sel_gt[..., None].expand(-1, -1, nk * 3)
                            ).reshape(b, k, nk, 3)
    sel_gt_xy = sel_gt_k[..., :2] / sel_stride[..., None, None]
    kpt_mask = (sel_gt_k[..., 2] != 0).to(torch.float32) * w_fg[..., None]

    wh = xyxy2xywh(sel_box / sel_stride[..., None])
    area = (wh[..., 2] * wh[..., 3]).clamp(min=1e-4)
    sigmas = (OKS_SIGMA.to(idx.device) if nk == 17
              else torch.ones(nk, device=idx.device) / nk)
    d = ((sel_kpt[..., :2] - sel_gt_xy) ** 2).sum(-1)             # (B, K, nk)
    e = d / (2 * sigmas[None, None, :]) ** 2 / (area[..., None] + 1e-9) / 2
    n_valid, slots, n_fg = global_sum(group, kpt_mask.sum(), kpt_mask.numel(),
                                      w_fg.sum())
    n_valid = n_valid.clamp(min=1.0)
    kpt_factor = slots / n_valid
    loss_kpt = kpt_factor * ((1 - torch.exp(-e)) * kpt_mask).sum() / slots
    if kdim == 3:
        vis_bce = _bce_logits(sel_kpt[..., 2], (kpt_mask > 0).to(torch.float32))
        loss_kobj = (vis_bce * w_fg[..., None]).sum() \
            / (n_fg * nk).clamp(min=1.0)
    else:
        loss_kobj = loss_kpt.new_zeros(())

    loss_box = loss_box * hyp["box"]
    loss_kpt = loss_kpt * hyp.get("pose", 12.0) / gb
    loss_kobj = loss_kobj * hyp.get("kobj", 1.0) / gb
    loss_cls = loss_cls * hyp["cls"]
    loss_dfl = loss_dfl * hyp["dfl"]
    total = (loss_box + loss_kpt + loss_kobj + loss_cls + loss_dfl) * gb
    return total, PoseLossItems(loss_box.detach(), loss_kpt.detach(),
                                loss_kobj.detach(), loss_cls.detach(),
                                loss_dfl.detach())


def classification_loss(logits, labels, nbs=64):
    """(loss, loss detached): the cross-entropy of (B, nc) logits against
    int labels, summed over the batch and divided by `nbs` (JAX
    losses/segment.py:217-222, reference loss.py:380-385)."""
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    ce = -(torch.log_softmax(logits, -1) * onehot.to(logits.dtype)).sum(-1)
    loss = ce.sum() / nbs
    return loss, loss.detach()
