"""Letterbox and the val transform (JAX data/augment.py:24-49, 160-166,
378-402; reference augment.py:540-605, dataset.py:146-150).

cv2 is imported only when the image needs resizing; an image that already
fits is padded with numpy, which gives the same bytes as
cv2.copyMakeBorder(BORDER_CONSTANT).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD_VALUE = 114


def letterbox(img, new_shape=640, color=PAD_VALUE, scaleup=True, center=True,
              stride=32, auto=False):
    """Ratio-preserving resize + pad of an HWC uint8 image to `new_shape`,
    an int (square) or (h, w). `scaleup=False` only shrinks; `auto` pads
    only up to the next multiple of `stride`; `center` splits the pad
    between both sides (with `center=False` each side gets the whole pad, as
    in the JAX package).

    Returns (img, ratio, (dw, dh)).
    """
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    if center:
        dw /= 2
        dh /= 2
    if shape[::-1] != new_unpad:
        import cv2
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2)
    img = np.pad(img, pad, mode="constant", constant_values=color)
    return img, (r, r), (dw, dh)


@dataclass
class Sample:
    """One decoded image + labels in pixel xyxy."""
    img: np.ndarray           # HWC BGR uint8
    boxes: np.ndarray         # (n, 4) xyxy pixels
    cls: np.ndarray           # (n,)


class ValTransforms:
    """LetterBox only (reference dataset.py:146-150). `imgsz` may be an int or a
    rectangular (h, w) target for rect-val buckets. Returns the RGB image,
    normalised xywh in the letterboxed frame and the classes."""

    def __init__(self, imgsz=640):
        self.imgsz = imgsz

    def __call__(self, get_sample, index, rng=None):
        max_side = self.imgsz if isinstance(self.imgsz, int) else max(self.imgsz)
        sm = get_sample(index, max_side)
        img, ratio, (dw, dh) = letterbox(sm.img, self.imgsz, scaleup=True)
        boxes = sm.boxes.copy()
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * ratio[0] + dw
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * ratio[1] + dh
        ih, iw = img.shape[:2]
        img = np.ascontiguousarray(img[..., ::-1])
        if len(boxes):
            xywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / iw,
                             (boxes[:, 1] + boxes[:, 3]) / 2 / ih,
                             (boxes[:, 2] - boxes[:, 0]) / iw,
                             (boxes[:, 3] - boxes[:, 1]) / ih], 1).astype(np.float32)
        else:
            xywh = np.zeros((0, 4), np.float32)
        return img, xywh, sm.cls.astype(np.float32)
