"""YOLOv8 Detect, AsffDetect, Segment and Pose heads and the eval decodes
(JAX nn/heads.py:28-140, 275-315).

The head returns raw per-level maps in the JAX layout, (B, H, W, 4*reg_max +
nc); `decode_detections` turns them into xywh pixel boxes and sigmoid class
scores. DFL is a fixed arange, not a module, so it has no state_dict key.
Segment also returns per-level (B, H, W, nm) mask coefficients and the
(B, 2H0, 2W0, nm) prototypes of the first level, NHWC as in JAX; Pose the
per-level (B, H, W, nk * kdim) keypoint maps, which `decode_keypoints`
turns into pixel keypoints.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from .layers import BiasConv2d, Conv, Proto, sigmoid


class Detect(nn.Module):
    """Per-level box (4*reg_max ch) and cls (nc ch) branches.

    Branch widths c2 = max(16, ch0//4, 4*reg_max), c3 = max(ch0, min(nc, 100))
    (reference head.py:38).
    """

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          BiasConv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3),
                          BiasConv2d(c3, nc, 1)) for x in ch)

    def bias_init(self):
        """Box bias 1.0, cls bias log(5 / nc / (640/stride)^2) (head.py:95-102)."""
        for box, cls, s in zip(self.cv2, self.cv3, self.strides):
            box[-1].bias.data.fill_(1.0)
            cls[-1].bias.data.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, xs):
        return [torch.cat([b(x), c(x)], 1).permute(0, 2, 3, 1)
                for x, b, c in zip(xs, self.cv2, self.cv3)]


class AsffDetect(Detect):
    """Detect with one biased 1x1 a branch and level (reference
    head.py:105-174, JAX heads.py:65-85), `cv2.{i}.0` and `cv3.{i}.0`; the
    same raw-map layout, biases and decode as Detect."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 reg_max: int = 16):
        nn.Module.__init__(self)
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.cv2 = nn.ModuleList(
            nn.Sequential(BiasConv2d(x, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(BiasConv2d(x, nc, 1)) for x in ch)


class Segment(Detect):
    """Detect plus a mask-coefficient branch a level and Proto on the first
    level (reference head.py:177-200, JAX heads.py:90-116): `cv4.{i}` is two
    Convs to c4 = max(ch0 // 4, nm) and a biased 1x1 to nm coefficients;
    `proto` makes nm prototypes from npr channels at twice the first
    level's size. forward -> (detect maps, coefficient maps, protos), each
    NHWC."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 nm: int = 32, npr: int = 256, reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          BiasConv2d(c4, nm, 1)) for x in ch)

    def forward(self, xs):
        protos = self.proto(xs[0]).permute(0, 2, 3, 1)
        coefs = [c(x).permute(0, 2, 3, 1) for x, c in zip(xs, self.cv4)]
        return super().forward(xs), coefs, protos


class Pose(Detect):
    """Detect plus a keypoint branch a level (reference head.py:203-241, JAX
    heads.py:119-140): `cv4.{i}` is two Convs to c4 = max(ch0 // 4, nk *
    kdim) and a biased 1x1 to nk * kdim values an anchor. forward ->
    (detect maps, keypoint maps), each NHWC."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 kpt_shape=(17, 3), reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          BiasConv2d(c4, nk, 1)) for x in ch)

    def forward(self, xs):
        kpts = [c(x).permute(0, 2, 3, 1) for x, c in zip(xs, self.cv4)]
        return super().forward(xs), kpts


def decode_keypoints(kpt_maps, strides: Sequence[int], kpt_shape=(17, 3)):
    """Raw keypoint maps -> (B, N, nk, kdim) keypoints in pixels (JAX
    heads.py:275-291, reference head.py kpts_decode): xy = (2 * offset +
    anchor - 0.5) * stride, the visibility through a sigmoid."""
    feat_shapes = [(m.shape[1], m.shape[2]) for m in kpt_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                     device=kpt_maps[0].device)
    b = kpt_maps[0].shape[0]
    nk, kdim = kpt_shape
    x = torch.cat([m.reshape(b, -1, nk, kdim) for m in kpt_maps], 1)
    xy = (x[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) \
        * stride_t[None, :, None, :]
    if kdim == 3:
        return torch.cat([xy, sigmoid(x[..., 2:3])], -1)
    return xy


def flatten_raw(raw_maps):
    """Per-level (B, H, W, no) maps -> (B, sum(hw), no), reference anchor order."""
    b = raw_maps[0].shape[0]
    return torch.cat([m.reshape(b, -1, m.shape[-1]) for m in raw_maps], 1)


def decode_detections(raw_maps, nc: int, strides: Sequence[int],
                      reg_max: int = 16):
    """Raw maps -> (boxes_xywh_pixels (B, N, 4), class_scores (B, N, nc))."""
    if torch.is_tensor(raw_maps):
        raise ValueError("decode_detections takes a detect head's list of "
                         "per-level maps; a single tensor is a classify "
                         "model's logits (DetectionModel.decode)")
    feat_shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                     device=raw_maps[0].device)
    x = flatten_raw(raw_maps)
    box, cls = x[..., :4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_decode(box, reg_max)
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return dbox, sigmoid(cls)
