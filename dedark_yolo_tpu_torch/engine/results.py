"""Results and Boxes containers, numpy-backed (JAX engine/results.py:43-160).

Built after the device readback: one Results holds one image's detections in
original-image pixels.
"""

from __future__ import annotations

import numpy as np


class Boxes:
    """(n, 6) [x1, y1, x2, y2, conf, cls] in original-image pixels."""

    def __init__(self, data, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]


class Results:
    """One image's result: the RGB original, its path, class names, Boxes,
    and the per-image stage times in ms."""

    def __init__(self, orig_img, path, names, boxes=None, speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)),
                           self.orig_shape)
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes)
