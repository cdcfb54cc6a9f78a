"""The segment task's data: polygon labels to fixed-shape mask batches (JAX
data/segment.py; reference data/utils.py:137-191, augment.py:608-645).

A label row is `cls x1 y1 x2 y2 ...`, a normalised polygon. A batch's
ground-truth masks are overlap-encoded at imgsz / mask_ratio, (B, mh, mw)
with each pixel the index + 1 of the instance on top (0 none), as the
reference's overlap_mask=True default: every polygon is resampled to 1000
points, rasterised at the full letterbox size (`imgops.fill_poly`, cv2's
fillPoly), resized down by mask_ratio (`imgops.resize_linear`, cv2's
INTER_LINEAR: the boundary is antialiased, not rasterised at the small
size), and the instances are drawn larger first so small ones stay on top;
past 255 instances the raster is int32.

The train pipeline (`SegTrainTransforms`) is the reference's v8 order:
mosaic4 -> CopyPaste -> affine -> photometric -> HSV -> flip lr, each
random number drawn from the item's rng in JAX's order, the pixels through
`data/imgops.py`, so nothing here needs OpenCV. Images are read the detect
dataset's way (`data/dataset.py`): with cache='disk' from the `.npy`
sidecar beside each image.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from . import imgops
from .augment import (_affine_matrix, letterbox, photometric_augment,
                      random_hsv, transform_points, warp_image)
from .dataset import YOLODataset, _scan_images, img2label_path


def parse_segment_label(label_path, nc):
    """-> [(cls, polygon (k, 2) normalised)]; rows with fewer than three
    points or an odd coordinate count are skipped."""
    out = []
    if not Path(label_path).is_file():
        return out
    for line in Path(label_path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 7:
            c = int(float(parts[0]))
            if c >= nc:
                raise ValueError(f"class id >= nc in {label_path}")
            pts = np.asarray([float(x) for x in parts[1:]], np.float32)
            if len(pts) % 2 == 0:
                out.append((c, pts.reshape(-1, 2)))
    return out


def resample_segment(poly, n=1000):
    """The closed outline densified to n points by linear interpolation, in
    float32 (reference ops.py:533-551): fillPoly truncates each vertex to
    int32, so the rasterised mask depends on these points."""
    s = np.concatenate([poly, poly[0:1]], axis=0).astype(np.float32)
    x = np.linspace(0, len(s) - 1, n)
    xp = np.arange(len(s))
    return np.stack([np.interp(x, xp, s[:, i]) for i in range(2)],
                    axis=1).astype(np.float32)


def polygon2mask(imgsz_hw, polygon_px, value=1, downsample_ratio=1):
    """One pixel-space polygon rasterised at imgsz_hw, then resized down by
    downsample_ratio (reference data/utils.py:137-155)."""
    mask = np.zeros(imgsz_hw, np.uint8)
    imgops.fill_poly(mask, np.asarray(polygon_px, np.int32), value)
    if downsample_ratio != 1:
        nh, nw = imgsz_hw[0] // downsample_ratio, imgsz_hw[1] // downsample_ratio
        mask = imgops.resize_linear(mask, (nw, nh))
    return mask


def polygons2masks_overlap(imgsz_hw, polygons_px, downsample_ratio=1):
    """The overlap-encoded raster at imgsz / ratio: pixel = instance index
    + 1, larger instances drawn first (reference data/utils.py:173-190)."""
    nh = imgsz_hw[0] // downsample_ratio
    nw = imgsz_hw[1] // downsample_ratio
    out = np.zeros((nh, nw),
                   np.int32 if len(polygons_px) > 255 else np.uint8)
    ms = [polygon2mask(imgsz_hw, resample_segment(p), value=1,
                       downsample_ratio=downsample_ratio)
          for p in polygons_px]
    areas = np.asarray([m.sum() for m in ms])
    for idx in np.argsort(-areas):
        out[ms[idx] > 0] = int(idx) + 1
    return out


class SegmentDataset(YOLODataset):
    """Images and polygon labels. The image reads (`cache`: False, True or
    'ram', 'disk') and `image_shapes` are the detect dataset's; `labels[i]`
    is image i's [(cls, normalised polygon)]."""

    def __init__(self, img_path, imgsz=640, nc=80, cache=False):
        self.imgsz = imgsz
        self.nc = nc
        self.single_cls = False
        self.im_files = _scan_images(img_path)
        self.labels = [parse_segment_label(img2label_path(f), nc)
                       for f in self.im_files]
        self._ram = {} if cache in (True, "ram") else None
        self._disk = cache == "disk"

    def load_raw(self, index):
        """(BGR image resized so its longer side is imgsz, cls (n,),
        polygons [(k, 2) pixels]); no letterbox: mosaic pastes raw tiles."""
        img = self._read(index)
        h0, w0 = img.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            img = imgops.resize_linear(img, (min(int(w0 * r), self.imgsz),
                                             min(int(h0 * r), self.imgsz)))
        h, w = img.shape[:2]
        cls, polys = [], []
        for c, poly_n in self.labels[index]:
            cls.append(c)
            polys.append(poly_n * np.asarray([w, h], np.float32))
        return img, np.asarray(cls, np.float32), polys

    def load(self, index, fliplr_p=0.5, train=False, rng=None):
        """(RGB uint8 (s, s, 3) letterboxed, boxes xywhn (n, 4), cls (n,),
        polygons [(k, 2) pixels in the letterbox frame])."""
        rng = rng or random
        img = self._read(index)
        h0, w0 = img.shape[:2]
        out, ratio, (dw, dh) = letterbox(img, self.imgsz)
        polys, cls = [], []
        for c, poly_n in self.labels[index]:
            p = poly_n * np.asarray([w0, h0], np.float32)
            p = p * ratio[0] + np.asarray([dw, dh], np.float32)
            polys.append(p)
            cls.append(c)
        if train and rng.random() < fliplr_p:
            out = np.fliplr(out)
            polys = [np.stack([self.imgsz - p[:, 0], p[:, 1]], 1) for p in polys]
        s = self.imgsz
        boxes = [[(p[:, 0].min() + p[:, 0].max()) / 2 / s,
                  (p[:, 1].min() + p[:, 1].max()) / 2 / s,
                  (p[:, 0].max() - p[:, 0].min()) / s,
                  (p[:, 1].max() - p[:, 1].min()) / s] for p in polys]
        boxes = (np.asarray(boxes, np.float32) if boxes
                 else np.zeros((0, 4), np.float32))
        return (np.ascontiguousarray(out[..., ::-1]), boxes,
                np.asarray(cls, np.float32), polys)


def collate_segment(items, max_boxes=32, mask_ratio=4):
    """[(img, xywhn, cls, polygons)] -> the fixed-shape batch: 'img' (B, S,
    S, 3) uint8, 'bboxes' (B, M, 4), 'cls' and 'mask_gt' (B, M), 'masks'
    (B, S / r, S / r) f32 overlap-encoded from the first M instances."""
    b = len(items)
    s = items[0][0].shape[0]
    mh = mw = s // mask_ratio
    imgs = np.zeros((b, s, s, 3), np.uint8)
    bboxes = np.zeros((b, max_boxes, 4), np.float32)
    cls = np.zeros((b, max_boxes), np.float32)
    mask_gt = np.zeros((b, max_boxes), np.float32)
    masks = np.zeros((b, mh, mw), np.float32)
    for i, (img, xywh, c, polys) in enumerate(items):
        imgs[i] = img
        n = min(len(c), max_boxes)
        if n:
            bboxes[i, :n] = xywh[:n]
            cls[i, :n] = c[:n]
            mask_gt[i, :n] = 1.0
            masks[i] = polygons2masks_overlap((s, s), list(polys[:n]),
                                              downsample_ratio=mask_ratio)
    return {"img": imgs, "bboxes": bboxes, "cls": cls, "mask_gt": mask_gt,
            "masks": masks}


def polys_to_boxes(polys, w, h):
    """Polygons -> pixel xyxy boxes of their points clipped to the image
    (reference ops.segment2box)."""
    boxes = []
    for p in polys:
        x = p[:, 0].clip(0, w)
        y = p[:, 1].clip(0, h)
        boxes.append([x.min(), y.min(), x.max(), y.max()])
    return (np.asarray(boxes, np.float32) if boxes
            else np.zeros((0, 4), np.float32))


def seg_mosaic4(items, imgsz, rng):
    """The 2x2 mosaic of four (img, cls, polygons) samples on a 2s canvas
    of gray 114 around a random centre, each sample's polygons shifted by
    its paste offset (reference Mosaic._mosaic4)."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    out_cls, out_polys = [], []
    for i, (img, cls, polys) in enumerate(items):
        h, w = img.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                       x1b:x1b + (x2a - x1a)]
        padw, padh = x1a - x1b, y1a - y1b
        for c, p in zip(cls, polys):
            out_cls.append(c)
            out_polys.append(p + np.asarray([padw, padh], np.float32))
    return canvas, np.asarray(out_cls, np.float32), out_polys


def _bbox_ioa(box1, box2, eps=1e-7):
    """(N, M) intersection over box2's area (reference metrics.bbox_ioa)."""
    ix = (np.minimum(box1[:, None, 2], box2[None, :, 2]) -
          np.maximum(box1[:, None, 0], box2[None, :, 0])).clip(0)
    iy = (np.minimum(box1[:, None, 3], box2[None, :, 3]) -
          np.maximum(box1[:, None, 1], box2[None, :, 1])).clip(0)
    area2 = ((box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]))[None]
    return ix * iy / (area2 + eps)


def copy_paste(img, cls, polys, p, rng):
    """Copy-Paste (reference augment.py:608-645): the instances whose
    left-right mirror overlaps every box with IoA < 0.30 are candidates;
    round(p * n) of them, drawn from rng, are pasted as mirrored pixels
    under their mirrored polygon, with their labels."""
    if not p or not len(polys):
        return img, cls, polys
    h, w = img.shape[:2]
    boxes = polys_to_boxes(polys, w, h)
    flip_polys = [np.stack([w - q[:, 0], q[:, 1]], 1) for q in polys]
    flip_boxes = polys_to_boxes(flip_polys, w, h)
    ioa = _bbox_ioa(flip_boxes, boxes)
    eligible = np.nonzero((ioa < 0.30).all(1))[0]
    k = round(p * len(eligible))
    if k == 0:
        return img, cls, polys
    pick = rng.sample(list(eligible), k=k)
    mask = np.zeros(img.shape[:2], np.uint8)
    cls = list(cls)
    polys = list(polys)
    for j in pick:
        cls.append(cls[j])
        polys.append(flip_polys[j])
        imgops.fill_poly(mask, flip_polys[j].astype(np.int32), 1)
    flipped = img[:, ::-1]
    img = img.copy()
    img[mask.astype(bool)] = flipped[mask.astype(bool)]
    return img, np.asarray(cls, np.float32), polys


def seg_affine(img, cls, polys, hyp, border, rng):
    """The random affine (or perspective) warp of the image and polygons;
    each polygon clipped to the output, and kept where its box is wider
    and taller than 2 pixels (reference RandomPerspective with segments)."""
    persp = hyp.get("perspective", 0.0)
    M, height, width, _ = _affine_matrix(
        img.shape, hyp.get("degrees", 0.0), hyp.get("translate", 0.1),
        hyp.get("scale", 0.5), hyp.get("shear", 0.0), persp, border, rng)
    img = warp_image(img, M, height, width, persp)
    new_polys, new_cls = [], []
    for c, q in zip(cls, polys):
        tq = transform_points(q, M, persp).astype(np.float32)
        tq[:, 0] = tq[:, 0].clip(0, width)
        tq[:, 1] = tq[:, 1].clip(0, height)
        bw = tq[:, 0].max() - tq[:, 0].min()
        bh = tq[:, 1].max() - tq[:, 1].min()
        if bw > 2 and bh > 2:
            new_polys.append(tq)
            new_cls.append(c)
    return img, np.asarray(new_cls, np.float32), new_polys


class SegTrainTransforms:
    """mosaic4 -> CopyPaste -> affine -> photometric -> HSV -> flip lr ->
    (RGB uint8, xywhn, cls, polygons), as `collate_segment` takes them
    (reference v8_transforms, augment.py:767-795). `mosaic_enabled` goes
    off for close_mosaic: the sample is letterboxed instead."""

    def __init__(self, hyp, imgsz=640):
        self.hyp = hyp
        self.imgsz = imgsz
        self.mosaic_enabled = True

    def __call__(self, ds, index, rng):
        h = self.hyp
        s = self.imgsz
        use_mosaic = self.mosaic_enabled and rng.random() < h.get("mosaic", 1.0)
        if use_mosaic:
            idxs = [index] + [ds.random_index(rng) for _ in range(3)]
            img, cls, polys = seg_mosaic4([ds.load_raw(i) for i in idxs], s, rng)
            img, cls, polys = copy_paste(img, cls, polys,
                                         h.get("copy_paste", 0.0), rng)
            border = (-s // 2, -s // 2)
        else:
            img, cls, polys = ds.load_raw(index)
            img, ratio, (dw, dh) = letterbox(img, s)
            polys = [q * np.asarray(ratio, np.float32)
                     + np.asarray([dw, dh], np.float32) for q in polys]
            border = (0, 0)
        img, cls, polys = seg_affine(img, cls, polys, h, border, rng)
        if h.get("photometric", True):
            img = photometric_augment(img, rng)
        img = random_hsv(img, h.get("hsv_h", 0.015), h.get("hsv_s", 0.7),
                         h.get("hsv_v", 0.4), rng)
        ih, iw = img.shape[:2]
        if rng.random() < h.get("fliplr", 0.5):
            img = np.fliplr(img)
            polys = [np.stack([iw - q[:, 0], q[:, 1]], 1) for q in polys]
        boxes = polys_to_boxes(polys, iw, ih)
        if len(boxes):
            xywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / iw,
                             (boxes[:, 1] + boxes[:, 3]) / 2 / ih,
                             (boxes[:, 2] - boxes[:, 0]) / iw,
                             (boxes[:, 3] - boxes[:, 1]) / ih], 1)
        else:
            xywh = np.zeros((0, 4), np.float32)
        return (np.ascontiguousarray(img[..., ::-1]),
                xywh.astype(np.float32), cls, polys)
