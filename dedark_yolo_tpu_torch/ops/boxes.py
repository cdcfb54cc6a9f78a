"""Box geometry (JAX ops/boxes.py:18-143). Reference ultralytics/utils/ops.py
and metrics.py."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Reference ops.py:386-403."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Reference ops.py:366-383."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_iou_matrix(box1, box2, eps=1e-7):
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M), in the JAX
    package's operation order (ops/boxes.py:132-143; reference
    metrics.py:52-72 box_iou)."""
    lt = torch.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = torch.minimum(box1[:, None, 2:], box2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def ltwh2xyxy(x):
    """(left, top, w, h) -> xyxy. Reference ops.py:457-470."""
    left, top, w, h = x.unbind(-1)
    return torch.stack([left, top, left + w, top + h], -1)


def xyxy2ltwh(x):
    """xyxy -> (left, top, w, h). Reference ops.py:473-489."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], -1)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to the image shape (h, w). Reference ops.py:281-301."""
    h, w = shape[0], shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def scale_boxes(img1_shape, boxes, img0_shape, ratio_pad=None, padding=True):
    """Rescale xyxy boxes from the letterboxed `img1_shape` back to
    `img0_shape`, with the reference's round(x - 0.1) pad quirk (ops.py:95-125).
    `ratio_pad` ((gain, _), (pad_w, pad_h)) gives the letterbox's gain and
    pad instead; `padding=False` divides by the gain only."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
               round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    if padding:
        boxes = boxes - torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                                     dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Rescale (..., 2+) points (keypoints x, y[, visibility]) from the
    letterboxed `img1_shape` back to `img0_shape` (JAX ops/boxes.py:70-87,
    reference ops.py:699-737): the gain and the unrounded pad of the
    letterbox, or those of `ratio_pad`, x and y clipped to the image, the
    other columns untouched."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    x = ((coords[..., 0:1] - pad[0]) / gain).clamp(0, img0_shape[1])
    y = ((coords[..., 1:2] - pad[1]) / gain).clamp(0, img0_shape[0])
    return torch.cat([x, y, coords[..., 2:]], -1)


def bbox_iou(box1, box2, xywh=True, GIoU=False, DIoU=False, CIoU=False,
             eps=1e-7):
    """Elementwise IoU, GIoU, DIoU or CIoU of broadcastable boxes (last dim
    4; (cx, cy, w, h) where `xywh`, else xyxy) -> (..., 1). JAX
    ops/boxes.py:90-129 (reference metrics.py:75-128): eps on h1 and h2 in
    the xyxy branch only, CIoU before DIoU before GIoU, and the CIoU alpha
    detached."""
    if xywh:
        x1, y1, w1, h1 = box1.split(1, -1)
        x2, y2, w2, h2 = box2.split(1, -1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.split(1, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.split(1, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (CIoU or DIoU or GIoU):
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if not (CIoU or DIoU):
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
            + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if not CIoU:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
