"""The pose task's data: keypoint labels to fixed-shape batches (JAX
data/pose.py; reference data/dataset.py's keypoint labels, augment.py's
Mosaic and RandomPerspective with keypoints).

A label row is `cls cx cy w h kx1 ky1 v1 ... kxK kyK vK`, normalised (the
Ultralytics pose format); rows with fewer than 5 + 3 nk values are
skipped. A batch's keypoints are (B, max_boxes, nk, 3), x and y normalised
to the letterbox frame, the visibility as labelled (0 for a padding row).

The train pipeline (`PoseTrainTransforms`) is JAX's: mosaic4 -> affine
(boxes by their corners, keypoints as points, the visibility of a keypoint
warped out of the frame zeroed) -> photometric -> HSV, each random number
drawn from the item's rng in JAX's order, the pixels through
`data/imgops.py`, so nothing here needs OpenCV. Horizontal flip stays off,
as in JAX: a flip would have to swap the left and right keypoints. Images
are read the detect dataset's way (`data/dataset.py`): with cache='disk'
from the `.npy` sidecar beside each image.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from . import imgops
from .augment import (_affine_matrix, _box_candidates, letterbox,
                      photometric_augment, random_hsv, transform_points,
                      warp_image)
from .dataset import YOLODataset, _scan_images, img2label_path


def parse_pose_label(label_path, nc, nk):
    """-> [(cls, box cxcywh (4,) normalised, keypoints (nk, 3))]."""
    out = []
    if not Path(label_path).is_file():
        return out
    for line in Path(label_path).read_text().splitlines():
        p = line.split()
        if len(p) >= 5 + nk * 3:
            c = int(float(p[0]))
            if c >= nc:
                raise ValueError(f"class id >= nc in {label_path}")
            box = np.asarray([float(x) for x in p[1:5]], np.float32)
            kpt = np.asarray([float(x) for x in p[5:5 + nk * 3]],
                             np.float32).reshape(nk, 3)
            out.append((c, box, kpt))
    return out


class PoseDataset(YOLODataset):
    """Images and keypoint labels. The image reads (`cache`: False, True or
    'ram', 'disk') and `image_shapes` are the detect dataset's; `labels[i]`
    is image i's [(cls, normalised box, normalised keypoints)]."""

    def __init__(self, img_path, imgsz=640, nc=1, kpt_shape=(17, 3),
                 cache=False):
        self.imgsz = imgsz
        self.nc = nc
        self.nk = int(kpt_shape[0])
        self.single_cls = False
        self.im_files = _scan_images(img_path)
        self.labels = [parse_pose_label(img2label_path(f), nc, self.nk)
                       for f in self.im_files]
        self._ram = {} if cache in (True, "ram") else None
        self._disk = cache == "disk"

    def load_raw(self, index):
        """(BGR image resized so its longer side is imgsz, boxes xyxy px,
        cls (n,), keypoints (n, nk, 3) px); no letterbox: mosaic pastes raw
        tiles."""
        img = self._read(index)
        h0, w0 = img.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            img = imgops.resize_linear(img, (min(int(w0 * r), self.imgsz),
                                             min(int(h0 * r), self.imgsz)))
        h, w = img.shape[:2]
        boxes, cls, kpts = [], [], []
        for c, box_n, kpt_n in self.labels[index]:
            cx, cy = box_n[0] * w, box_n[1] * h
            bw, bh = box_n[2] * w, box_n[3] * h
            boxes.append([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])
            cls.append(c)
            k = kpt_n.copy()
            k[:, 0] *= w
            k[:, 1] *= h
            kpts.append(k)
        boxes = (np.asarray(boxes, np.float32) if boxes
                 else np.zeros((0, 4), np.float32))
        kpts = (np.stack(kpts) if kpts
                else np.zeros((0, self.nk, 3), np.float32))
        return img, boxes, np.asarray(cls, np.float32), kpts

    def load(self, index, fliplr_p=0.0, train=False, rng=None):
        """(RGB uint8 (s, s, 3) letterboxed, boxes xywhn (n, 4), cls (n,),
        keypoints (n, nk, 3) normalised to the letterbox frame)."""
        rng = rng or random
        img = self._read(index)
        h0, w0 = img.shape[:2]
        out, ratio, (dw, dh) = letterbox(img, self.imgsz)
        s = self.imgsz
        boxes, cls, kpts = [], [], []
        for c, box_n, kpt_n in self.labels[index]:
            cx = (box_n[0] * w0 * ratio[0] + dw) / s
            cy = (box_n[1] * h0 * ratio[1] + dh) / s
            bw = box_n[2] * w0 * ratio[0] / s
            bh = box_n[3] * h0 * ratio[1] / s
            k = kpt_n.copy()
            k[:, 0] = (k[:, 0] * w0 * ratio[0] + dw) / s
            k[:, 1] = (k[:, 1] * h0 * ratio[1] + dh) / s
            boxes.append([cx, cy, bw, bh])
            cls.append(c)
            kpts.append(k)
        if train and rng.random() < fliplr_p:
            out = np.fliplr(out)
            for b in boxes:
                b[0] = 1.0 - b[0]
            for k in kpts:
                k[:, 0] = 1.0 - k[:, 0]
        boxes = (np.asarray(boxes, np.float32) if boxes
                 else np.zeros((0, 4), np.float32))
        kpts = (np.stack(kpts) if kpts
                else np.zeros((0, self.nk, 3), np.float32))
        return (np.ascontiguousarray(out[..., ::-1]), boxes,
                np.asarray(cls, np.float32), kpts)


def collate_pose(items, max_boxes=32, nk=17):
    """(img RGB, boxes xywhn, cls, keypoints) items -> the batch dict: 'img'
    (B, S, S, 3) uint8, 'bboxes' (B, M, 4), 'cls' (B, M), 'mask_gt' (B, M),
    'keypoints' (B, M, nk, 3); past max_boxes an image's rows are dropped."""
    b = len(items)
    s = items[0][0].shape[0]
    imgs = np.zeros((b, s, s, 3), np.uint8)
    bboxes = np.zeros((b, max_boxes, 4), np.float32)
    cls = np.zeros((b, max_boxes), np.float32)
    mask_gt = np.zeros((b, max_boxes), np.float32)
    keypoints = np.zeros((b, max_boxes, nk, 3), np.float32)
    for i, (img, xywh, c, k) in enumerate(items):
        imgs[i] = img
        n = min(len(c), max_boxes)
        if n:
            bboxes[i, :n] = xywh[:n]
            cls[i, :n] = c[:n]
            mask_gt[i, :n] = 1.0
            keypoints[i, :n] = k[:n]
    return {"img": imgs, "bboxes": bboxes, "cls": cls, "mask_gt": mask_gt,
            "keypoints": keypoints}


def pose_mosaic4(items, imgsz, rng):
    """2 x 2 keypoint mosaic (reference Mosaic with keypoints): four
    load_raw items pasted on a 2s canvas of gray 114 around a random
    centre, their boxes and keypoint xy shifted by the paste offsets."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    out_boxes, out_cls, out_kpts = [], [], []
    for i, (img, boxes, cls, kpts) in enumerate(items):
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
        if len(cls):
            b = boxes.copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            out_boxes.append(b)
            out_cls.append(cls)
            k = kpts.copy()
            k[..., 0] += padw
            k[..., 1] += padh
            out_kpts.append(k)
    nk = items[0][3].shape[1] if items[0][3].size else 17
    boxes = (np.concatenate(out_boxes, 0) if out_boxes
             else np.zeros((0, 4), np.float32))
    cls = (np.concatenate(out_cls, 0) if out_cls
           else np.zeros((0,), np.float32))
    kpts = (np.concatenate(out_kpts, 0) if out_kpts
            else np.zeros((0, nk, 3), np.float32))
    return canvas, boxes, cls, kpts


class PoseTrainTransforms:
    """mosaic4 -> affine (boxes and keypoints) -> photometric -> HSV (JAX
    data/pose.py:182-261), emitting the (img RGB, boxes xywhn, cls,
    keypoints normalised) item `collate_pose` takes."""

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
            img, boxes, cls, kpts = pose_mosaic4(
                [ds.load_raw(i) for i in idxs], s, rng)
            border = (-s // 2, -s // 2)
        else:
            img, boxes, cls, kpts = ds.load_raw(index)
            img, ratio, (dw, dh) = letterbox(img, s)
            if len(boxes):
                boxes = boxes * np.asarray([ratio[0], ratio[1]] * 2, np.float32)
                boxes[:, [0, 2]] += dw
                boxes[:, [1, 3]] += dh
                kpts = kpts.copy()
                kpts[..., 0] = kpts[..., 0] * ratio[0] + dw
                kpts[..., 1] = kpts[..., 1] * ratio[1] + dh
            border = (0, 0)
        persp = h.get("perspective", 0.0)
        M, height, width, sc = _affine_matrix(
            img.shape, h.get("degrees", 0.0), h.get("translate", 0.1),
            h.get("scale", 0.5), h.get("shear", 0.0), persp, border, rng)
        img = warp_image(img, M, height, width, persp)
        n = len(boxes)
        if n:
            corners = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
            tc = transform_points(corners, M, persp).reshape(n, 8)
            x = tc[:, [0, 2, 4, 6]]
            y = tc[:, [1, 3, 5, 7]]
            new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), 1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
            keep = _box_candidates(boxes.T * sc, new.T)
            nk = kpts.shape[1]
            tk = transform_points(kpts[..., :2].reshape(-1, 2), M,
                                  persp).reshape(n, nk, 2)
            vis = kpts[..., 2] * ((tk[..., 0] >= 0) & (tk[..., 0] < width) &
                                  (tk[..., 1] >= 0) & (tk[..., 1] < height))
            kpts = np.concatenate([tk, vis[..., None]],
                                  -1).astype(np.float32)[keep]
            boxes, cls = new[keep].astype(np.float32), cls[keep]
        if h.get("photometric", True):
            img = photometric_augment(img, rng)
        img = random_hsv(img, h.get("hsv_h", 0.015), h.get("hsv_s", 0.7),
                         h.get("hsv_v", 0.4), rng)
        ih, iw = img.shape[:2]
        if len(boxes):
            xywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / iw,
                             (boxes[:, 1] + boxes[:, 3]) / 2 / ih,
                             (boxes[:, 2] - boxes[:, 0]) / iw,
                             (boxes[:, 3] - boxes[:, 1]) / ih], 1)
            kn = kpts.copy()
            kn[..., 0] /= iw
            kn[..., 1] /= ih
        else:
            nk = kpts.shape[1] if kpts.size else 17
            xywh = np.zeros((0, 4), np.float32)
            kn = np.zeros((0, nk, 3), np.float32)
        return (np.ascontiguousarray(img[..., ::-1]),
                xywh.astype(np.float32), cls, kn)
