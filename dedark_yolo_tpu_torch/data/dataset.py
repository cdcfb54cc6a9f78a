"""Dataset: image/label scan, verification, label cache, sample access (JAX
data/dataset.py).

Scans an images dir or a txt list, maps images to labels by the
'/images/ -> /labels/' convention (reference data/utils.py:39), verifies
and caches the labels under a content hash in the same `labels.cache.npz`
container as the JAX package, and loads an image resized so its longer side
is `imgsz` (reference base.py:142-169).

`yaml` is imported only to read a dataset file (a dict needs none), `cv2`
only to decode an image (the max-side resize is `imgops.resize_linear`,
cv2's INTER_LINEAR without OpenCV). With `cache='disk'` an image is read
from its `.npy` sidecar (the array `cv2.imread` gave, written on the first
read), and `image_shapes()` takes an image's (h, w) from its sidecar's
header where there is one: the same shape the JAX package reads from the
image's own header, with no decoder. A deployment without OpenCV can so
validate and train on sidecars alone. `fraction` keeps the first share of
the sorted images; `random_index` draws the partners of mosaic and mixup.
A dataset name that is not a file, such as 'tielu.yaml', resolves to the
packaged card of that name (`cfg/datasets.py`).
"""

from __future__ import annotations

import copy
import hashlib
import os
import threading
from pathlib import Path

import numpy as np

from ..cfg import yaml_load
from ..cfg.datasets import DATASETS
from . import imgops
from .augment import Sample

IMG_FORMATS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
CACHE_VERSION = "dedark-tpu-1.0"    # the JAX package's: the caches cross


def read_image_shapes(im_files):
    """(n, 2) int32 array of original (h, w) per file via header-only reads."""
    shapes = []
    for f in im_files:
        try:
            from PIL import Image
            with Image.open(f) as im:
                w, h = im.size
        except Exception:
            import cv2
            h, w = cv2.imread(str(f)).shape[:2]
        shapes.append((h, w))
    return np.asarray(shapes, np.int32)


def save_sidecar(path, img):
    """Write the `.npy` sidecar `path` whole or not at all: into a name of
    this thread's, then renamed over it, so a loader thread that reads the
    image while another writes it never finds a half-written file. An
    unwritable directory leaves no sidecar."""
    path = Path(path)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}-{threading.get_ident()}"
                         ".tmp.npy")
    try:
        np.save(tmp, img)
        os.replace(tmp, path)
    except OSError:
        pass


def img2label_path(img_path: str) -> str:
    """images/... -> labels/... with .txt (reference data/utils.py:39)."""
    p = str(img_path)
    parts = p.rsplit("/images/", 1)
    if len(parts) == 2:
        return parts[0] + "/labels/" + str(Path(parts[1]).with_suffix(".txt"))
    return str(Path(p).with_suffix(".txt"))


def check_det_dataset(data):
    """A dataset dict, the path of a dataset yaml, or the name of a
    packaged card (JAX data/dataset.py:59-64) -> dict(path, train, val,
    names, nc) with the split paths under `path` and integer-keyed names.

    Reference: ultralytics/data/utils.py:193-267 (without auto-download).
    """
    if isinstance(data, dict):
        d = dict(data)
    elif not Path(data).is_file() and Path(data).name in DATASETS:
        d = copy.deepcopy(DATASETS[Path(data).name])
    else:
        p = Path(data)
        d = yaml_load(p)
        d.setdefault("path", str(p.parent))
    root = Path(d.get("path", "."))
    for k in ("train", "val", "test"):
        if d.get(k):
            p = Path(d[k])
            d[k] = str(p if p.is_absolute() else root / p)
    names = d.get("names")
    if isinstance(names, (list, tuple)):
        names = {i: n for i, n in enumerate(names)}
    elif names is None:
        names = {i: str(i) for i in range(d.get("nc", 80))}
    d["names"] = names
    d["nc"] = len(names)
    return d


def _scan_images(path) -> list:
    p = Path(path)
    if p.is_dir():
        files = sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_FORMATS)
    elif p.is_file() and p.suffix == ".txt":
        base = p.parent
        files = []
        for line in p.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            fp = Path(line)
            files.append(str(fp if fp.is_absolute() else base / fp))
    else:
        raise FileNotFoundError(f"dataset path not found: {path}")
    if not files:
        raise FileNotFoundError(f"no images found in {path}")
    return files


def verify_label(label_path, nc) -> np.ndarray:
    """Load and validate one label file -> (n, 5) [cls, cx, cy, w, h] normalized.

    Reference checks (data/utils.py:63-135): 5 columns, normalized coords <= 1,
    nonnegative, class < nc, duplicate rows removed.
    """
    if not Path(label_path).is_file():
        return np.zeros((0, 5), np.float32)
    rows = []
    for line in Path(label_path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 5:
            rows.append([float(x) for x in parts[:5]])
    if not rows:
        return np.zeros((0, 5), np.float32)
    lb = np.asarray(rows, np.float32)
    if (lb < 0).any():
        raise ValueError(f"negative label values: {label_path}")
    if (lb[:, 1:] > 1).any():
        raise ValueError(f"non-normalized coordinates: {label_path}")
    if (lb[:, 0] >= nc).any():
        raise ValueError(f"class id >= nc in {label_path}")
    return np.unique(lb, axis=0)


class YOLODataset:
    """Detection dataset with label cache and max-side image loading.
    cache: False, True or 'ram' (decoded images kept), 'disk' (.npy
    sidecars)."""

    def __init__(self, img_path, imgsz=640, nc=80, cache=False,
                 single_cls=False, fraction=1.0):
        self.imgsz = imgsz
        self.nc = nc
        self.single_cls = single_cls
        self.im_files = _scan_images(img_path)
        if fraction < 1.0:   # the first share of the sorted files
            self.im_files = self.im_files[:max(1, int(len(self.im_files) * fraction))]
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = self._load_cache()
        self._ram = {} if cache in (True, "ram") else None
        self._disk = cache == "disk"  # .npy sidecars (reference base.py:171-209)

    # -- label cache -------------------------------------------------------
    def _hash(self):
        h = hashlib.sha256()
        for f, lf in zip(self.im_files, self.label_files):
            h.update(f.encode())
            p = Path(lf)
            if p.is_file():
                h.update(str(p.stat().st_mtime_ns).encode())
        h.update(CACHE_VERSION.encode())
        return h.hexdigest()

    def _cache_path(self):
        return Path(self.im_files[0]).parent.parent / "labels.cache.npz"

    def _load_cache(self):
        cp = self._cache_path()
        want = self._hash()
        if cp.is_file():
            # the cache holds an object array, written by this class or the
            # JAX package's beside the images; whatever fails to read it
            # only means the labels are verified again
            try:
                z = np.load(cp, allow_pickle=True)
                if str(z["hash"]) == want:
                    return [np.asarray(lb, np.float32) for lb in z["labels"]]
            except Exception:
                pass
        labels = [verify_label(lf, self.nc) for lf in self.label_files]
        # a 1-D object array even when every image has as many labels
        packed = np.empty(len(labels), dtype=object)
        packed[:] = labels
        try:
            np.savez(cp, hash=want, labels=packed)
        except OSError:
            pass
        return labels

    # -- sample access -------------------------------------------------------
    def __len__(self):
        return len(self.im_files)

    def random_index(self, rng):
        """An image index drawn from the per-item rng (mosaic and mixup
        partners)."""
        return rng.randrange(len(self.im_files))

    def _sidecar(self, index):
        return Path(self.im_files[index]).with_suffix(".npy")

    def image_shapes(self):
        """(n, 2) array of original (h, w) per image, cached: from the .npy
        sidecar's header under cache='disk' where it exists, else from the
        image file's header. Used by rect-val aspect bucketing (reference
        base.py:211-234) and native-space validation."""
        if not hasattr(self, "_shapes"):
            shapes = [None] * len(self)
            if self._disk:
                for i in range(len(self)):
                    if self._sidecar(i).is_file():
                        shapes[i] = np.load(self._sidecar(i),
                                            mmap_mode="r").shape[:2]
            missing = [i for i, s in enumerate(shapes) if s is None]
            for i, hw in zip(missing, read_image_shapes(
                    [self.im_files[i] for i in missing])):
                shapes[i] = tuple(hw)
            self._shapes = np.asarray(shapes, np.int32)
        return self._shapes

    def _read(self, index):
        if self._ram is not None and index in self._ram:
            return self._ram[index]
        if self._disk and self._sidecar(index).is_file():
            return np.load(self._sidecar(index))
        import cv2
        img = cv2.imread(self.im_files[index])
        if img is None:
            raise FileNotFoundError(f"image not found: {self.im_files[index]}")
        if self._disk:
            save_sidecar(self._sidecar(index), img)
        if self._ram is not None:
            self._ram[index] = img
        return img

    def __call__(self, index, imgsz=None):
        """Return a Sample resized so max side == imgsz (reference base.py:142-169)."""
        imgsz = imgsz or self.imgsz
        img = self._read(index)
        h0, w0 = img.shape[:2]
        r = imgsz / max(h0, w0)
        if r != 1:
            img = imgops.resize_linear(
                img, (min(int(w0 * r), imgsz), min(int(h0 * r), imgsz)))
        lb = self.labels[index]
        cls = lb[:, 0].copy()
        if self.single_cls:
            cls[:] = 0
        # normalized xywh -> pixel xyxy at loaded size
        h, w = img.shape[:2]
        if len(lb):
            cx, cy, bw, bh = lb[:, 1] * w, lb[:, 2] * h, lb[:, 3] * w, lb[:, 4] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        else:
            boxes = np.zeros((0, 4), np.float32)
        return Sample(img, boxes.astype(np.float32), cls.astype(np.float32))
