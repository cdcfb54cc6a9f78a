"""Letterbox (JAX data/augment.py:24-49; reference augment.py:540-605).

cv2 is imported only when the image needs resizing; an image that already
fits is padded with numpy, which gives the same bytes as
cv2.copyMakeBorder(BORDER_CONSTANT).
"""

from __future__ import annotations

import numpy as np

PAD_VALUE = 114


def letterbox(img, new_shape=640):
    """Ratio-preserving resize + centred pad of an HWC uint8 image to a
    `new_shape` square (the predict letterbox: scale up, no stride rounding).

    Returns (img, ratio, (dw, dh)).
    """
    shape = img.shape[:2]
    r = min(new_shape / shape[0], new_shape / shape[1])
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw = (new_shape - new_unpad[0]) / 2
    dh = (new_shape - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        import cv2
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2)
    img = np.pad(img, pad, mode="constant", constant_values=PAD_VALUE)
    return img, (r, r), (dw, dh)
