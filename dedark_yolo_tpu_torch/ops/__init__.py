"""Tensor ops: box geometry, anchors, NMS, the dark-channel priors, the
low-light degrade and the letterbox's geometry, under the JAX package's
names (JAX ops/__init__.py). The hand-written kernels (`enhance_kernel`,
`int8_conv`, the `nms` gate's) build at their first call, never here."""

from .anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from .boxes import (bbox_iou, box_iou_matrix, clip_boxes, ltwh2xyxy,
                    scale_boxes, scale_coords, xywh2xyxy, xyxy2ltwh,
                    xyxy2xywh)
from .dark_channel import atmospheric_light, dark_channel, dark_channel_priors
from .degrade import lowlight_degrade
from .letterbox import letterbox_params
from .nms import non_max_suppression

__all__ = [
    "bbox_iou", "box_iou_matrix", "xywh2xyxy", "xyxy2xywh", "ltwh2xyxy",
    "xyxy2ltwh", "clip_boxes", "scale_boxes", "scale_coords", "make_anchors",
    "dist2bbox", "bbox2dist", "dfl_decode", "non_max_suppression",
    "dark_channel", "atmospheric_light", "dark_channel_priors",
    "lowlight_degrade", "letterbox_params",
]
