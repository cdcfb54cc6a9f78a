"""Bboxes and Instances label containers (JAX data/instances.py; reference
ultralytics/utils/instance.py:34, 185), numpy only: format conversion
(xyxy, xywh, ltwh), normalise and denormalise, scale, padding offsets,
flips, clipping and zero-area removal, with the segment and pose tasks'
polygons and keypoints carried beside the boxes."""

from __future__ import annotations

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


class Bboxes:
    """Boxes in one of xyxy / xywh / ltwh formats (reference instance.py:34)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        assert format in _FORMATS, format
        bboxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
        self.bboxes = bboxes
        self.format = format

    def convert(self, format: str):
        assert format in _FORMATS, format
        if format == self.format:
            return self
        b = self.bboxes
        # to xyxy first
        if self.format == "xywh":
            cx, cy, w, h = b.T
            xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
        elif self.format == "ltwh":
            l, t, w, h = b.T
            xyxy = np.stack([l, t, l + w, t + h], 1)
        else:
            xyxy = b
        if format == "xyxy":
            out = xyxy
        elif format == "xywh":
            x1, y1, x2, y2 = xyxy.T
            out = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1)
        else:
            x1, y1, x2, y2 = xyxy.T
            out = np.stack([x1, y1, x2 - x1, y2 - y1], 1)
        self.bboxes = out.astype(np.float32)
        self.format = format
        return self

    def areas(self):
        b = Bboxes(self.bboxes.copy(), self.format).convert("xyxy").bboxes
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def mul(self, scale):
        """Multiply coords by (sx, sy, sx, sy) or scalar."""
        if np.isscalar(scale):
            scale = (scale,) * 4
        self.bboxes = self.bboxes * np.asarray(scale, np.float32)
        return self

    def add(self, offset):
        """Add (ox, oy, ox, oy) or scalar offset."""
        if np.isscalar(offset):
            offset = (offset,) * 4
        self.bboxes = self.bboxes + np.asarray(offset, np.float32)
        return self

    def __len__(self):
        return len(self.bboxes)


class Instances:
    """Boxes + optional segments/keypoints with joint geometric ops
    (reference instance.py:185)."""

    def __init__(self, bboxes, segments=None, keypoints=None, bbox_format="xywh",
                 normalized=True):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = segments
        self.keypoints = keypoints
        self.normalized = normalized

    @property
    def bboxes(self):
        return self._bboxes.bboxes

    @property
    def bbox_areas(self):
        return self._bboxes.areas()

    def convert_bbox(self, format):
        self._bboxes.convert(format)
        return self

    def denormalize(self, w, h):
        if not self.normalized:
            return self
        self._bboxes.mul((w, h, w, h))
        if self.keypoints is not None:
            self.keypoints[..., 0] *= w
            self.keypoints[..., 1] *= h
        self.normalized = False
        return self

    def normalize(self, w, h):
        if self.normalized:
            return self
        self._bboxes.mul((1 / w, 1 / h, 1 / w, 1 / h))
        if self.keypoints is not None:
            self.keypoints[..., 0] /= w
            self.keypoints[..., 1] /= h
        self.normalized = True
        return self

    def scale(self, sx, sy, bbox_only=False):
        self._bboxes.mul((sx, sy, sx, sy))
        if not bbox_only and self.keypoints is not None:
            self.keypoints[..., 0] *= sx
            self.keypoints[..., 1] *= sy
        return self

    def add_padding(self, padw, padh):
        assert not self.normalized, "pad offsets apply to pixel coords"
        self._bboxes.add((padw, padh, padw, padh))
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh
        return self

    def fliplr(self, w):
        if self._bboxes.format == "xyxy":
            x1 = self.bboxes[:, 0].copy()
            x2 = self.bboxes[:, 2].copy()
            self.bboxes[:, 0] = w - x2
            self.bboxes[:, 2] = w - x1
        else:
            self.bboxes[:, 0] = w - self.bboxes[:, 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]
        return self

    def flipud(self, h):
        if self._bboxes.format == "xyxy":
            y1 = self.bboxes[:, 1].copy()
            y2 = self.bboxes[:, 3].copy()
            self.bboxes[:, 1] = h - y2
            self.bboxes[:, 3] = h - y1
        else:
            self.bboxes[:, 1] = h - self.bboxes[:, 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]
        return self

    def clip(self, w, h):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        self.bboxes[:, [0, 2]] = self.bboxes[:, [0, 2]].clip(0, w)
        self.bboxes[:, [1, 3]] = self.bboxes[:, [1, 3]].clip(0, h)
        if fmt != "xyxy":
            self.convert_bbox(fmt)
        return self

    def remove_zero_area_boxes(self):
        keep = self.bbox_areas > 0
        self._bboxes.bboxes = self._bboxes.bboxes[keep]
        if self.keypoints is not None:
            self.keypoints = self.keypoints[keep]
        return keep

    def __len__(self):
        return len(self._bboxes)
