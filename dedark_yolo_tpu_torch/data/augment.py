"""Letterbox, the train transforms and the val transform (JAX
data/augment.py; reference augment.py:118-269, 540-795, dataset.py:146-157).

Train: Mosaic(p) -> RandomPerspective -> MixUp(p) -> the photometric
extras (Blur, MedianBlur, ToGray, CLAHE, each p = 0.01) -> RandomHSV ->
RandomFlip(ud) -> RandomFlip(lr), then normalised xywh. Every random
number is drawn from the per-item `random.Random` the loader passes, in
the JAX package's order and count, so a seed gives both packages the same
geometry. The pixel operations are `data.imgops`, which computes what the
JAX package's cv2 calls compute without OpenCV.

The letterbox resizes with `imgops.resize_linear` (cv2.resize INTER_LINEAR)
and pads with numpy, which gives the same bytes as
cv2.copyMakeBorder(BORDER_CONSTANT); nothing here imports cv2.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np

from . import imgops

PAD_VALUE = 114


def letterbox(img, new_shape=(640, 640), color=PAD_VALUE, scaleup=True,
              center=True, stride=32, auto=False, scale_fill=False):
    """Ratio-preserving resize + pad of an HWC uint8 image to `new_shape`,
    an int (square) or (h, w). `scaleup=False` only shrinks; `auto` pads
    only up to the next multiple of `stride`; `center` splits the pad
    between both sides (with `center=False` each side gets the whole pad, as
    in the JAX package). `scale_fill` is taken and, as in the JAX package
    (data/augment.py:24-49), not applied: the ratio is always kept.

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
        img = imgops.resize_linear(img, new_unpad)
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


def random_hsv(img, hgain=0.015, sgain=0.7, vgain=0.4, rng=None):
    """HSV jitter (reference RandomHSV): three uniform gains, one LUT per
    channel on the u8 HSV image."""
    rng = rng or random
    if hgain or sgain or vgain:
        r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
        hsv = imgops.bgr2hsv(img)
        x = np.arange(0, 256, dtype=r.dtype)
        tables = (((x * r[0]) % 180).astype(img.dtype),
                  np.clip(x * r[1], 0, 255).astype(img.dtype),
                  np.clip(x * r[2], 0, 255).astype(img.dtype))
        hsv = np.stack([np.take(t, hsv[..., k]) for k, t in enumerate(tables)], -1)
        img = imgops.hsv2bgr(hsv)
    return img


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Filter degenerate transformed boxes (reference RandomPerspective)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr) &
            (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def _affine_matrix(img_shape, degrees, translate, scale, shear, perspective,
                   border, rng):
    """Random M = T @ S @ R @ P @ C and the output (height, width, s) of
    the warp (reference RandomPerspective affine_transform)."""
    height = img_shape[0] + border[0] * 2
    width = img_shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = imgops.rotation_matrix_2d(a, s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    return T @ S @ R @ P @ C, height, width, s


def warp_image(img, M, height, width, perspective=0.0):
    """The affine or perspective warp of `img` by M, gray-114 border."""
    if perspective:
        return imgops.warp_perspective(img, M, (width, height))
    return imgops.warp_affine(img, M[:2], (width, height))


def transform_points(pts, M, perspective=0.0):
    """Transform (n, 2) pixel points by the 3x3 matrix."""
    n = len(pts)
    if n == 0:
        return pts
    xy = np.ones((n, 3))
    xy[:, :2] = pts
    xy = xy @ M.T
    return xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]


def random_perspective(img, boxes_xyxy, cls, degrees=0.0, translate=0.1,
                       scale=0.5, shear=0.0, perspective=0.0, border=(0, 0),
                       rng=None):
    """Affine/perspective warp of image + xyxy pixel boxes (reference
    RandomPerspective): the box corners transformed, clipped to the output
    and filtered by `_box_candidates`."""
    rng = rng or random
    M, height, width, s = _affine_matrix(img.shape, degrees, translate, scale,
                                         shear, perspective, border, rng)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        img = warp_image(img, M, height, width, perspective)

    n = len(boxes_xyxy)
    if n:
        corners = boxes_xyxy[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = transform_points(corners, M, perspective).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(boxes_xyxy.T * s, new.T)
        boxes_xyxy = new[keep]
        cls = cls[keep]
    return img, boxes_xyxy, cls


def _cat(parts, shape, dtype=np.float32):
    return np.concatenate(parts, 0) if parts else np.zeros(shape, dtype)


def mosaic4(samples, imgsz, rng=None):
    """2x2 mosaic on a 2s x 2s gray canvas (reference Mosaic). samples: 4
    Samples max-side-resized to imgsz; boxes in canvas pixels."""
    rng = rng or random
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), PAD_VALUE, dtype=np.uint8)
    out_boxes, out_cls = [], []
    for i, sm in enumerate(samples):
        h, w = sm.img.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = sm.img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(sm.boxes):
            b = sm.boxes.copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            out_boxes.append(b)
            out_cls.append(sm.cls)
    boxes, cls = _cat(out_boxes, (0, 4)), _cat(out_cls, (0,))
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    return Sample(canvas, boxes, cls)


def mosaic9(samples, imgsz, rng=None):
    """3x3 mosaic on a 3s x 3s gray canvas, the centre tile first, each
    tile jittered in its cell, then the central 2s x 2s window (reference
    Mosaic n=9). samples: 9 Samples max-side-resized to imgsz."""
    rng = rng or random
    s = imgsz
    canvas = np.full((s * 3, s * 3, 3), PAD_VALUE, dtype=np.uint8)
    out_boxes, out_cls = [], []
    offsets = [(1, 1), (0, 0), (1, 0), (2, 0), (0, 1), (2, 1), (0, 2), (1, 2),
               (2, 2)]
    for sm, (cx, cy) in zip(samples, offsets):
        h, w = sm.img.shape[:2]
        ox = cx * s + rng.randint(0, max(s - w, 0)) if s > w else cx * s
        oy = cy * s + rng.randint(0, max(s - h, 0)) if s > h else cy * s
        canvas[oy:oy + h, ox:ox + w] = sm.img
        if len(sm.boxes):
            b = sm.boxes.copy()
            b[:, [0, 2]] += ox
            b[:, [1, 3]] += oy
            out_boxes.append(b)
            out_cls.append(sm.cls)
    x0 = y0 = s // 2
    canvas = canvas[y0:y0 + 2 * s, x0:x0 + 2 * s]
    boxes, cls = _cat(out_boxes, (0, 4)), _cat(out_cls, (0,))
    if len(boxes):
        boxes[:, [0, 2]] -= x0
        boxes[:, [1, 3]] -= y0
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & ((boxes[:, 3] - boxes[:, 1]) > 2)
        boxes, cls = boxes[keep], cls[keep]
    return Sample(canvas, boxes, cls)


def mixup(sample_a, sample_b, rng=None):
    """MixUp with a beta(32, 32) ratio drawn from the per-item rng
    (reference MixUp)."""
    rng = rng or random
    r = rng.betavariate(32.0, 32.0)
    img = (sample_a.img.astype(np.float32) * r +
           sample_b.img.astype(np.float32) * (1 - r)).astype(np.uint8)
    boxes = np.concatenate([sample_a.boxes, sample_b.boxes], 0)
    cls = np.concatenate([sample_a.cls, sample_b.cls], 0)
    return Sample(img, boxes, cls)


def photometric_augment(img, rng, p=0.01):
    """The reference's Albumentations extras (augment.py:648-672), each at
    p: Blur (ksize 3-7), MedianBlur (3, 5 or 7), ToGray (replicated to
    three channels), CLAHE (clip 1-4, 8x8 tiles) on the LAB L channel.
    Pixel-only: the boxes stay."""
    if rng.random() < p:
        img = imgops.box_blur(img, rng.randint(3, 7))
    if rng.random() < p:
        img = imgops.median_blur(img, rng.choice((3, 5, 7)))
    if rng.random() < p:
        img = np.repeat(imgops.bgr2gray(img)[..., None], 3, -1)
    if rng.random() < p:
        clip = rng.uniform(1.0, 4.0)
        lab = imgops.bgr2lab(img)
        lab[..., 0] = imgops.clahe(lab[..., 0], clip)
        img = imgops.lab2bgr(lab)
    return img


def to_xywhn(boxes, cls, ih, iw):
    """Pixel xyxy -> normalised xywh (Format), zero-area boxes dropped."""
    if not len(boxes):
        return np.zeros((0, 4), np.float32), cls
    xywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / iw,
                     (boxes[:, 1] + boxes[:, 3]) / 2 / ih,
                     (boxes[:, 2] - boxes[:, 0]) / iw,
                     (boxes[:, 3] - boxes[:, 1]) / ih], 1).astype(np.float32)
    keep = (xywh[:, 2] > 0) & (xywh[:, 3] > 0)
    return xywh[keep], cls[keep]


class TrainTransforms:
    """Mosaic + affine + mixup + photometric + HSV + flips, emitting
    (img_uint8_RGB, boxes_xywhn, cls). `mosaic_enabled` goes off for the
    final close_mosaic epochs (reference dataset.py:152-157): then the
    sample is letterboxed instead. CopyPaste needs instance polygons and
    is a no-op in the detect pipeline (reference augment.py:621), so it is
    absent, as in the JAX package."""

    def __init__(self, hyp, imgsz=640, n_mosaic=4):
        self.hyp = hyp
        self.imgsz = imgsz
        self.n_mosaic = n_mosaic  # 4 (2x2) or 9 (3x3)
        self.mosaic_enabled = True

    def _perspective(self, sample, border, rng):
        h = self.hyp
        return random_perspective(
            sample.img, sample.boxes, sample.cls,
            degrees=h.get("degrees", 0.0), translate=h.get("translate", 0.1),
            scale=h.get("scale", 0.5), shear=h.get("shear", 0.0),
            perspective=h.get("perspective", 0.0), border=border, rng=rng)

    def __call__(self, get_sample, index, rng: random.Random):
        h = self.hyp
        use_mosaic = self.mosaic_enabled and rng.random() < h.get("mosaic", 1.0)
        if use_mosaic:
            idxs = [index] + [get_sample.random_index(rng)
                              for _ in range(self.n_mosaic - 1)]
            mosaic_fn = mosaic9 if self.n_mosaic == 9 else mosaic4
            sample = mosaic_fn([get_sample(i, self.imgsz) for i in idxs],
                               self.imgsz, rng)
            border = (-self.imgsz // 2, -self.imgsz // 2)
        else:
            sm = get_sample(index, self.imgsz)
            img, ratio, (dw, dh) = letterbox(sm.img, self.imgsz)
            boxes = sm.boxes.copy()
            if len(boxes):
                boxes[:, [0, 2]] = boxes[:, [0, 2]] * ratio[0] + dw
                boxes[:, [1, 3]] = boxes[:, [1, 3]] * ratio[1] + dh
            sample = Sample(img, boxes, sm.cls)
            border = (0, 0)
        sample = Sample(*self._perspective(sample, border, rng))

        if use_mosaic and rng.random() < h.get("mixup", 0.0):
            idxs = [get_sample.random_index(rng) for _ in range(4)]
            other = mosaic4([get_sample(i, self.imgsz) for i in idxs],
                            self.imgsz, rng)
            other = Sample(*self._perspective(other, border, rng))
            sample = mixup(sample, other, rng)

        img = sample.img
        if h.get("photometric", True):
            img = photometric_augment(img, rng)
        img = random_hsv(img, h.get("hsv_h", 0.015), h.get("hsv_s", 0.7),
                         h.get("hsv_v", 0.4), rng)
        boxes, cls = sample.boxes, sample.cls

        ih, iw = img.shape[:2]
        if rng.random() < h.get("flipud", 0.0):
            img = np.flipud(img)
            if len(boxes):
                boxes[:, [1, 3]] = ih - boxes[:, [3, 1]]
        if rng.random() < h.get("fliplr", 0.5):
            img = np.fliplr(img)
            if len(boxes):
                boxes[:, [0, 2]] = iw - boxes[:, [2, 0]]

        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
        xywh, cls = to_xywhn(boxes, cls, ih, iw)
        return img, xywh, cls.astype(np.float32)


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
