"""Anchor-free grid anchors and DFL box decoding (JAX ops/anchors.py).

Reference formulas: ultralytics/utils/tal.py:246-277, nn/modules/block.py:220-239.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import device_cache


@lru_cache(maxsize=16)
def _anchors_np(feat_shapes, strides, grid_cell_offset):
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = np.arange(w, dtype=np.float32) + grid_cell_offset
        sy = np.arange(h, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        points.append(np.stack([gx, gy], -1).reshape(-1, 2))
        stride_list.append(np.full((h * w, 1), s, dtype=np.float32))
    return np.concatenate(points), np.concatenate(stride_list)


@device_cache(maxsize=16)
def _anchors_on(feat_shapes, strides, grid_cell_offset, device):
    pts, st = _anchors_np(feat_shapes, strides, grid_cell_offset)
    # not inference tensors, whoever asks first: the loss saves them for
    # backward (ROADMAP C10)
    with torch.inference_mode(False):
        return (torch.from_numpy(pts).to(device),
                torch.from_numpy(st).to(device))


def make_anchors(feat_shapes, strides, grid_cell_offset=0.5, device="cpu"):
    """Grid anchor centres for feature shapes [(h, w), ...].

    Returns anchor_points (sum(h*w), 2) as (x, y) in grid units and
    stride_tensor (sum(h*w), 1); row-major per level, levels in input order.
    Kept per device: a host-to-device copy waits on the stream, so it
    happens once per shape, not once per batch (but not while a model is
    traced, `utils.device_cache`). Callers must not write to them.
    """
    return _anchors_on(tuple(tuple(s) for s in feat_shapes), tuple(strides),
                       grid_cell_offset, torch.device(device))


def dist2bbox(distance, anchor_points, xywh=True, axis=-1):
    """ltrb distances -> boxes around anchor points, the sides along `axis`.
    Reference tal.py:262-271."""
    lt, rb = distance.chunk(2, axis)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], axis)
    return torch.cat([x1y1, x2y2], axis)


def dfl_decode(pred_dist, reg_max=16):
    """(..., 4*reg_max) bin logits -> (..., 4) expected distances:
    softmax over the reg_max bins of each side, dotted with arange(reg_max)."""
    x = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max).float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return torch.softmax(x, dim=-1) @ proj


def bbox2dist(anchor_points, bbox, reg_max):
    """xyxy boxes -> ltrb distances, clamped to [0, reg_max - 0.01].
    Reference tal.py:274-277 (JAX ops/anchors.py:47-51)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    return dist.clamp(0, reg_max - 0.01)
