"""Results, Boxes, Masks and Probs containers, numpy-backed (JAX
engine/results.py:15-295 and results_extra.py:12-86, the detect, segment
and classify tasks).

Built after the device readback: one Results holds one image's detections
in original-image pixels, with the reference's API (`plot`, `save`,
`save_txt`, `save_crop`, `tojson`, `verbose`, indexing). Drawing and
encoding go through OpenCV (`utils.plotting`), imported at call time;
`tojson`, `save_txt`, `verbose` and the arrays need no package beyond
numpy. `update_tracks` takes a tracker's output (`track`). A classify
Results holds `probs` (a Probs of the image's class probabilities) and no
boxes; a segment Results also `masks` (a Masks of (n, h, w) bool masks at
the original size, one a detection), whose `xy` contours are
`imgops.find_external_contours` (cv2.findContours without OpenCV).
Keypoints belong to the pose task (ROADMAP A12f).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils import LOGGER
from ..utils.patches import require


class NumpyTensorAPI:
    """The reference BaseTensor's device moves (results.py:41-55) as
    identities: results are host numpy already, so call chains such as
    `r.boxes.cpu().numpy()` keep working."""

    def cpu(self):
        return self

    def numpy(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def cuda(self):
        raise NotImplementedError("results are host numpy arrays; cuda() "
                                  "does not apply to them")

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, idx):
        return type(self)(self.data[idx], self.orig_shape)


class Boxes(NumpyTensorAPI):
    """(n, 6) [x1, y1, x2, y2, conf, cls] in original-image pixels, or
    (n, 7) [x1, y1, x2, y2, track_id, conf, cls] of a tracked frame."""

    def __init__(self, data, orig_shape):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data.reshape(1, -1) if data.size else data.reshape(0, 6)
        # the width survives 0-row arrays: an empty tracked frame is (0, 7)
        w = data.shape[1] if data.ndim == 2 and data.shape[1] in (6, 7) else 6
        self.data = data.reshape(-1, w)
        self.is_track = w == 7
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        return self.data[:, 4] if self.is_track else None

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                         b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class Masks(NumpyTensorAPI):
    """(n, h, w) binary instance masks of one image (reference
    results.py:457-518, JAX results_extra.py:12-53)."""

    def __init__(self, data, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        """Each mask's largest external contour (by cv2.contourArea, the
        first of equal ones) as (m, 2) float32 original-image pixels; (0, 2)
        for an empty mask."""
        from ..data.imgops import contour_area, find_external_contours
        h, w = self.orig_shape
        mh, mw = self.data.shape[1:]
        out = []
        for m in self.data:
            cs = find_external_contours(m)
            if cs:
                areas = [contour_area(c) for c in cs]
                c = cs[int(np.argmax(areas))].astype(np.float32)
                c[:, 0] *= w / mw
                c[:, 1] *= h / mh
                out.append(c)
            else:
                out.append(np.zeros((0, 2), np.float32))
        return out

    @property
    def xyn(self):
        """`xy` over the image's (w, h)."""
        h, w = self.orig_shape
        return [c / np.asarray([w, h], np.float32) for c in self.xy]

    @property
    def segments(self):
        """The deprecated name of `xyn` (reference results.py:486-492)."""
        LOGGER.warning("'Masks.segments' is deprecated - use 'Masks.xyn' "
                       "(normalized) or 'Masks.xy' (pixels)")
        return self.xyn


class Probs(NumpyTensorAPI):
    """(nc,) class probabilities of one image (reference results.py:569,
    JAX results_extra.py:56-86)."""

    def __init__(self, data, names=None):
        self.data = np.asarray(data).reshape(-1)
        self.names = names or {}

    def __getitem__(self, idx):
        return Probs(self.data[idx], self.names)

    @property
    def top1(self):
        return int(np.argmax(self.data))

    @property
    def top1conf(self):
        return float(self.data[self.top1])

    @property
    def top5(self):
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top5conf(self):
        return self.data[self.top5]


class Results:
    """One image's result: the RGB original, its path, class names, Boxes,
    the per-image stage times in ms, layer 0's enhanced image (predict's
    `save_enhanced`: (S, S, 3) f32 in [0, 1], letterboxed) and the batch's
    captured activations on its first image (`visualize`: {layer: (1, h, w,
    <= 32) f32 NHWC}; None on the others), a segment model's Masks
    (`masks`) and a classify model's Probs (`probs`), None where the task
    has none."""

    _keys = ("boxes", "masks", "probs")

    def __init__(self, orig_img, path, names, boxes=None, speed=None,
                 enhanced_img=None, features=None, probs=None, masks=None):
        self.orig_img = orig_img            # RGB uint8
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)),
                           self.orig_shape)
        self.speed = speed or {}
        self.enhanced_img = enhanced_img
        self.features = features
        self.probs = Probs(probs, names) if probs is not None else None
        self.masks = (Masks(masks, self.orig_shape) if masks is not None
                      else None)

    def __len__(self):
        return len(self.boxes)

    @property
    def keys(self):
        """Names of the components present (reference results.py:161-164)."""
        return [k for k in self._keys if getattr(self, k) is not None]

    def new(self):
        """An empty Results of the same image, path and names."""
        return Results(orig_img=self.orig_img, path=self.path, names=self.names)

    def __getitem__(self, idx):
        """The detections at idx, as a Results (reference results.py:107-112)."""
        r = self.new()
        for k in self.keys:     # probs are the image's, kept whole
            comp = getattr(self, k)
            setattr(r, k, comp if k == "probs" else comp[idx])
        r.speed = self.speed
        return r

    def update(self, boxes=None, masks=None, probs=None):
        """Replace the boxes, masks or probs in place (reference results.py:
        114-122)."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if probs is not None:
            self.probs = probs

    def update_tracks(self, tracks):
        """Replace the boxes with a tracker's output (m, 8) [x1, y1, x2, y2,
        id, conf, cls, det_idx] (JAX results.py:218-229; det_idx re-indexes
        a segment model's masks there, which waits for segment tracking,
        ROADMAP A12e-b)."""
        tracks = np.asarray(tracks, np.float32).reshape(-1, 8)
        self.boxes = Boxes(tracks[:, :7], self.orig_shape)
        return self

    def verbose(self):
        """'4 persons, 1 bus, ' style log string, or a classify image's
        top-5 'name 0.91, ...' (reference results.py:258-273)."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(int(j), j)} "
                             f"{self.probs.data[j]:.2f}"
                             for j in self.probs.top5) + ", "
        if len(self) == 0:
            return "(no detections), "
        s = ""
        cls = self.boxes.cls.astype(int)
        for c in sorted(set(cls.tolist())):
            n = int((cls == c).sum())
            s += f"{n} {self.names.get(c, c)}{'s' * (n > 1)}, "
        return s

    def pandas(self):
        LOGGER.warning("'Results.pandas' is not implemented (reference "
                       "results.py:330-332 stub)")

    def plot(self, line_width=None, boxes=True, conf=True, labels=True,
             **kwargs):
        """The RGB original with the detections drawn (OpenCV)."""
        if "show_conf" in kwargs:       # the reference's deprecated names
            conf = kwargs.pop("show_conf")
        if "show_boxes" in kwargs:
            boxes = kwargs.pop("show_boxes")
        if "line_thickness" in kwargs:
            line_width = kwargs.pop("line_thickness")
        from ..utils.plotting import annotate_image
        img = annotate_image(self.orig_img, self.boxes.data, self.names,
                             line_width, show_boxes=boxes, show_conf=conf,
                             show_labels=labels)
        if self.masks is not None and len(self.masks):
            # JAX results.py:186-200: each mask filled in its colour, blended
            # 0.6 / 0.4 with the annotated image
            cv2 = require("cv2", "drawing masks")
            h, w = self.orig_shape
            overlay = img.copy()
            for j, m in enumerate(self.masks.data):
                mm = m.astype(np.uint8)
                if mm.shape != (h, w):
                    mm = cv2.resize(mm, (w, h), interpolation=cv2.INTER_NEAREST)
                overlay[mm > 0] = np.asarray(
                    [(37 * (j + 1)) % 255, (17 * (j + 7)) % 255,
                     (29 * (j + 3)) % 255], np.uint8)
            img = cv2.addWeighted(img, 0.6, overlay, 0.4, 0)
        return img

    def save(self, filename, **plot_kwargs):
        """`plot` written to `filename` through cv2.imwrite."""
        cv2 = require("cv2", "saving an annotated image")
        img = self.plot(**plot_kwargs)
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(filename), img[..., ::-1])
        return filename

    def save_txt(self, txt_file, save_conf=False):
        """One `cls cx cy w h [conf] [id]` line a detection, normalised."""
        lines = []
        h, w = self.orig_shape
        for d in self.boxes.data:
            x1, y1, x2, y2 = d[:4]
            conf, c = d[-2], d[-1]
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = (x2 - x1) / w, (y2 - y1) / h
            row = f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
            if save_conf:
                row += f" {conf:.6f}"
            if self.boxes.is_track:
                row += f" {int(d[4])}"
            lines.append(row)
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file

    def save_crop(self, save_dir, file_name=None):
        """One crop a detection into save_dir/<class name>/, the box grown
        by 2% + 10 px and clipped to the frame, written BGR (reference
        save_one_box); a taken name gets _2, _3, ... Returns the count."""
        cv2 = require("cv2", "saving crops")
        h, w = self.orig_shape
        stem = Path(file_name or self.path or "im").stem
        n_saved = 0
        for i, d in enumerate(self.boxes.data):
            x1, y1, x2, y2 = d[:4]
            c = d[-1]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            bw, bh = (x2 - x1) * 1.02 + 10, (y2 - y1) * 1.02 + 10
            xa = max(int(cx - bw / 2), 0)
            ya = max(int(cy - bh / 2), 0)
            xb = min(int(cx + bw / 2), w)
            yb = min(int(cy + bh / 2), h)
            if xb <= xa or yb <= ya:
                continue
            out = Path(save_dir) / self.names.get(int(c), str(int(c)))
            out.mkdir(parents=True, exist_ok=True)
            crop = self.orig_img[ya:yb, xa:xb]
            target = out / f"{stem}{'' if i == 0 else i}.jpg"
            bump = 2
            while target.exists():
                target = out / f"{stem}{'' if i == 0 else i}_{bump}.jpg"
                bump += 1
            cv2.imwrite(str(target), crop[..., ::-1])
            n_saved += 1
        return n_saved

    def tojson(self):
        out = []
        for d in self.boxes.data:
            c = int(d[-1])
            row = {"name": self.names.get(c, str(c)), "class": c,
                   "confidence": float(d[-2]),
                   "box": {"x1": float(d[0]), "y1": float(d[1]),
                           "x2": float(d[2]), "y2": float(d[3])}}
            if self.boxes.is_track:
                row["track_id"] = int(d[4])
            out.append(row)
        return json.dumps(out, indent=2)
