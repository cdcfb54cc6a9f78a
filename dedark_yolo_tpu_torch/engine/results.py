"""Results and Boxes containers, numpy-backed (JAX engine/results.py:15-295,
the detect task).

Built after the device readback: one Results holds one image's detections
in original-image pixels, with the reference's API (`plot`, `save`,
`save_txt`, `save_crop`, `tojson`, `verbose`, indexing). Drawing and
encoding go through OpenCV (`utils.plotting`), imported at call time;
`tojson`, `save_txt`, `verbose` and the arrays need no package beyond
numpy. `update_tracks` takes a tracker's output (`track`). Masks,
keypoints and probs belong to the other tasks (ROADMAP A12).
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


class Results:
    """One image's result: the RGB original, its path, class names, Boxes,
    the per-image stage times in ms, layer 0's enhanced image (predict's
    `save_enhanced`: (S, S, 3) f32 in [0, 1], letterboxed) and the batch's
    captured activations on its first image (`visualize`: {layer: (1, h, w,
    <= 32) f32 NHWC}; None on the others)."""

    _keys = ("boxes",)

    def __init__(self, orig_img, path, names, boxes=None, speed=None,
                 enhanced_img=None, features=None):
        self.orig_img = orig_img            # RGB uint8
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)),
                           self.orig_shape)
        self.speed = speed or {}
        self.enhanced_img = enhanced_img
        self.features = features

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
        for k in self.keys:
            setattr(r, k, getattr(self, k)[idx])
        r.speed = self.speed
        return r

    def update(self, boxes=None):
        """Replace the boxes in place (reference results.py:114-122)."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)

    def update_tracks(self, tracks):
        """Replace the boxes with a tracker's output (m, 8) [x1, y1, x2, y2,
        id, conf, cls, det_idx] (JAX results.py:218-229; det_idx re-indexes
        the other tasks' masks and keypoints, which the port does not
        carry)."""
        tracks = np.asarray(tracks, np.float32).reshape(-1, 8)
        self.boxes = Boxes(tracks[:, :7], self.orig_shape)
        return self

    def verbose(self):
        """'4 persons, 1 bus, ' style log string (reference results.py:
        258-273)."""
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
        return annotate_image(self.orig_img, self.boxes.data, self.names,
                              line_width, show_boxes=boxes, show_conf=conf,
                              show_labels=labels)

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
