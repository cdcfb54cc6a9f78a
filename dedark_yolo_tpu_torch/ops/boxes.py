"""Box geometry (JAX ops/boxes.py:18-69). Reference ultralytics/utils/ops.py."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Reference ops.py:386-403."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to the image shape (h, w). Reference ops.py:281-301."""
    h, w = shape[0], shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def scale_boxes(img1_shape, boxes, img0_shape):
    """Rescale xyxy boxes from the letterboxed `img1_shape` back to
    `img0_shape`, with the reference's round(x - 0.1) pad quirk (ops.py:95-125)."""
    gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
    pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
           round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
    boxes = boxes - torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                                 dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)
