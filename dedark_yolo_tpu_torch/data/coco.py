"""COCO json -> YOLO txt converter (JAX data/coco.py, reference
data/converter.py:28-117).

As in the JAX package: `save_dir` is a parameter; RLE masks decode in pure
numpy (`rle_decode`: COCO's column-major run lengths, uncompressed or as
pycocotools' LEB128-style string), with no pycocotools; the 91->80 class
map is built from the 11 unused category ids. `rle2polygon` traces the
decoded mask with OpenCV, imported at call time.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils import LOGGER
from ..utils.patches import require

# COCO published 91 category ids; these 11 were never annotated, so the
# standard "paper" (91) -> "2017 detection" (80) map skips them
_COCO_UNUSED_91 = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}


def coco91_to_coco80_class():
    """91-element list mapping 0-indexed COCO-91 category to COCO-80 index
    (None for the 11 unused ids). Reference converter.py:13-25."""
    out, j = [], 0
    for i in range(1, 92):
        if i in _COCO_UNUSED_91:
            out.append(None)
        else:
            out.append(j)
            j += 1
    return out


def rle_decode(rle):
    """Decode a COCO RLE segmentation dict to a (h, w) uint8 mask.

    Handles both uncompressed RLE (counts: list of run lengths) and the
    compressed string form (pycocotools' LEB128-like signed varint deltas).
    Runs alternate 0/1 in COLUMN-major (Fortran) order, starting with 0.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        # pycocotools compressed RLE: 6-bit chars offset by 48; each value a
        # signed varint; values after the 2nd are deltas vs counts[i-2]
        out = []
        i = 0
        while i < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k + 5)
                k += 1
            if len(out) > 2:
                x += out[-2]
            out.append(x)
        counts = out
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            mask[pos:pos + run] = 1
        pos += run
        val ^= 1
    return mask.reshape((w, h)).T  # column-major


def rle2polygon(segmentation):
    """RLE mask -> list of polygon contours (reference converter.py:118-144,
    minus the pycocotools dependency)."""
    cv2 = require("cv2", "tracing an RLE mask (rle2polygon)")
    m = rle_decode(segmentation) * 255
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_TC89_KCOS)
    polygons = []
    for contour in contours:
        eps = 0.001 * cv2.arcLength(contour, True)
        polygons.append(cv2.approxPolyDP(contour, eps, True)
                        .flatten().tolist())
    return polygons


def _min_index(a, b):
    """Index pair with the smallest pairwise distance between point sets."""
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.unravel_index(np.argmin(d), d.shape)


def merge_multi_segment(segments):
    """Connect an instance's multiple polygon parts into one closed polygon
    by joining each consecutive pair at their closest points (reference
    converter.py:161-209 — YOLO label rows hold ONE polygon per instance)."""
    segments = [np.array(s).reshape(-1, 2) for s in segments]
    idx_list = [[] for _ in segments]
    for i in range(1, len(segments)):
        i1, i2 = _min_index(segments[i - 1], segments[i])
        idx_list[i - 1].append(i1)
        idx_list[i].append(i2)
    s = []
    for k in range(2):
        if k == 0:  # forward pass: roll each part to start at its join point
            for i, idx in enumerate(idx_list):
                if len(idx) == 2 and idx[0] > idx[1]:
                    idx = idx[::-1]
                    segments[i] = segments[i][::-1, :]
                segments[i] = np.roll(segments[i], -idx[0], axis=0)
                segments[i] = np.concatenate([segments[i], segments[i][:1]])
                if i in (0, len(idx_list) - 1):
                    s.append(segments[i])
                else:
                    j = [0, idx[1] - idx[0]]
                    s.append(segments[i][j[0]:j[1] + 1])
        else:       # backward pass: the return paths of middle parts
            for i in range(len(idx_list) - 1, -1, -1):
                if i not in (0, len(idx_list) - 1):
                    idx = idx_list[i]
                    s.append(segments[i][abs(idx[1] - idx[0]):])
    return s


def convert_coco(labels_dir, save_dir="yolo_labels", use_segments=False,
                 use_keypoints=False, cls91to80=True):
    """Convert every instances_*.json under `labels_dir` into YOLO label txt
    files under `save_dir`/labels/<split>/ (reference converter.py:28-117:
    box -> normalized cxcywh; optional per-instance merged polygon; optional
    keypoints appended as normalized x,y,v triples). Crowd and degenerate
    boxes are skipped; duplicate rows are deduped like the reference."""
    labels_dir = Path(labels_dir)
    save_dir = Path(save_dir)
    coco80 = coco91_to_coco80_class()
    json_files = sorted(labels_dir.resolve().glob("*.json"))
    if not json_files:
        raise FileNotFoundError(f"no COCO json files in {labels_dir}")
    for json_file in json_files:
        fn = save_dir / "labels" / json_file.stem.replace("instances_", "")
        fn.mkdir(parents=True, exist_ok=True)
        data = json.loads(json_file.read_text())
        images = {x["id"]: x for x in data["images"]}
        img_anns = defaultdict(list)
        for ann in data["annotations"]:
            img_anns[ann["image_id"]].append(ann)
        n_rows = 0
        for img_id, anns in img_anns.items():
            img = images[img_id]
            h, w, f = img["height"], img["width"], img["file_name"]
            bboxes, segments, keypoints = [], [], []
            for ann in anns:
                if ann.get("iscrowd"):
                    continue
                box = np.array(ann["bbox"], np.float64)  # tlx, tly, w, h
                box[:2] += box[2:] / 2
                box[[0, 2]] /= w
                box[[1, 3]] /= h
                if box[2] <= 0 or box[3] <= 0:
                    continue
                cls = (coco80[ann["category_id"] - 1] if cls91to80
                       else ann["category_id"] - 1)
                if cls is None:
                    continue
                box = [cls] + box.tolist()
                if box in bboxes:
                    continue
                bboxes.append(box)
                if use_segments:
                    # keep segments index-aligned with bboxes: box-only
                    # annotations contribute an empty row (falls back to the
                    # box below) — the reference appends only when the
                    # segmentation key exists, which desyncs mixed data
                    seg = ann.get("segmentation") or []
                    if isinstance(seg, dict):
                        seg = rle2polygon(seg)
                    if len(seg) > 1:
                        s = merge_multi_segment(seg)
                        s = (np.concatenate(s, 0) /
                             np.array([w, h])).reshape(-1).tolist()
                        segments.append([cls] + s)
                    elif len(seg) == 1:
                        s = (np.array(seg[0]).reshape(-1, 2) /
                             np.array([w, h])).reshape(-1).tolist()
                        segments.append([cls] + s)
                    else:
                        segments.append([])
                if use_keypoints:
                    k_ann = ann.get("keypoints")
                    if k_ann is not None:
                        k = (np.array(k_ann).reshape(-1, 3) /
                             np.array([w, h, 1])).reshape(-1).tolist()
                        keypoints.append(box + k)
                    else:
                        keypoints.append(box)  # aligned box-only row
            lines = []
            for i in range(len(bboxes)):
                if use_keypoints:
                    row = keypoints[i]
                elif use_segments and len(segments[i]) > 0:
                    row = segments[i]
                else:
                    row = bboxes[i]
                lines.append(" ".join(f"{v:g}" for v in row))
            out = (fn / f).with_suffix(".txt")
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text("\n".join(lines) + ("\n" if lines else ""))
            n_rows += len(lines)
        LOGGER.info(f"convert_coco: {json_file.name} -> {fn} "
                    f"({n_rows} label rows)")
    return save_dir
