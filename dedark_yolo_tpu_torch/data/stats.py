"""Dataset statistics and preview packaging (JAX data/stats.py, reference
data/utils.py:318-525, HUBDatasetStats / compress_one_image /
zip_directory).

The stats.json schema of the reference's hub statistics, with no service
client: per split, the instances and images of each class and the rounded
label rows keyed by image file name, in `<dataset path>-hub/`. YOLO txt
rows carry each task's coordinates (box, polygon, box and keypoints), so
one parser serves detect, segment and pose. Pillow (and OpenCV for an
image Pillow cannot read) is imported at call time.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils import LOGGER
from ..utils.patches import require
from .dataset import check_det_dataset, img2label_path, _scan_images


def compress_one_image(f, f_new=None, max_dim: int = 1920, quality: int = 50):
    """Resize to <= max_dim and re-encode as quality-50 JPEG
    (reference data/utils.py:445-476)."""
    require("PIL", "compressing an image")
    from PIL import Image

    try:
        im = Image.open(f)
        r = max_dim / max(im.height, im.width)
        if r < 1.0:
            im = im.resize((int(im.width * r), int(im.height * r)))
        im.convert("RGB").save(f_new or f, "JPEG", quality=quality,
                               optimize=True)
    except Exception as e:  # PIL-unreadable -> cv2 fallback (reference :466)
        cv2 = require("cv2", f"reading the image {f}")
        im = cv2.imread(str(f))
        if im is None:
            raise FileNotFoundError(f"cannot read image {f}") from e
        r = max_dim / max(im.shape[:2])
        if r < 1.0:
            im = cv2.resize(im, (int(im.shape[1] * r), int(im.shape[0] * r)),
                            interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(f_new or f), im)


def zip_directory(dir, compress: bool = True) -> Path:
    """Zip a directory's contents into <dir>.zip (reference :501-524)."""
    from zipfile import ZIP_DEFLATED, ZIP_STORED, ZipFile

    dir = Path(dir)
    if not dir.is_dir():
        raise FileNotFoundError(f"directory not found: {dir}")
    out = dir.with_suffix(".zip")
    with ZipFile(out, "w", ZIP_DEFLATED if compress else ZIP_STORED) as z:
        for f in sorted(dir.rglob("*")):
            if f.is_file():
                z.write(f, f.relative_to(dir))
    return out


def unzip_file(file, path=None, exclude=(".DS_Store", "__MACOSX"),
               exist_ok: bool = False) -> Path:
    """Unzip `file` into `path` (JAX utils/downloads.py:37-68, reference
    downloads.py:46-89); returns the directory that holds the members.
    Members that do not share one top-level directory are extracted into a
    directory named after the zip. An existing, non-empty target is kept
    as it is unless `exist_ok`."""
    from zipfile import ZipFile, is_zipfile

    file = Path(file)
    if not (file.exists() and is_zipfile(file)):
        raise FileNotFoundError(f"'{file}' does not exist or is not a zipfile")
    path = Path(path or file.parent)
    with ZipFile(file) as z:
        names = [n for n in z.namelist()
                 if all(x not in n for x in exclude)]
        tops = {n.split("/")[0] for n in names}
        if len(tops) > 1 or (len(names) > 1 and not names[0].endswith("/")):
            dest = path / file.stem     # wrap loose members
        else:
            dest = path
        final = dest if dest != path else path / next(iter(tops))
        if final.exists() and any(final.iterdir()) and not exist_ok:
            LOGGER.info(f"skipping unzip: {final} exists (exist_ok=False)")
            return final
        for n in names:
            z.extract(n, dest)
    return final


class DatasetStats:
    """Build the HUB-schema stats.json for a detect/segment/pose dataset.

    Accepts a data.yaml path/dict or a .zip containing one (reference
    HUBDatasetStats._unzip). Artifacts land in `<dataset-path>-hub/`.
    """

    def __init__(self, path, task: str = "detect"):
        path = path if isinstance(path, dict) else Path(path)
        if not isinstance(path, dict) and str(path).endswith(".zip"):
            unzip_dir = unzip_file(path, path=Path(path).parent)
            yamls = list(Path(unzip_dir).glob("*.yaml")) or \
                list(Path(unzip_dir).rglob("*.yaml"))
            if not yamls:
                raise FileNotFoundError(f"no data.yaml inside {path}")
            path = yamls[0]
        self.data = check_det_dataset(path)
        self.task = task
        self.hub_dir = Path(str(self.data.get("path", ".")) + "-hub")
        self.im_dir = self.hub_dir / "images"
        self.stats = {"nc": self.data["nc"],
                      "names": list(self.data["names"].values())}

    @staticmethod
    def _read_rows(label_file):
        """[[cls, coords...], ...] from one YOLO txt label file."""
        p = Path(label_file)
        if not p.is_file():
            return []
        rows = []
        for line in p.read_text().splitlines():
            parts = line.split()
            if parts:
                rows.append([int(float(parts[0])),
                             *(round(float(x), 4) for x in parts[1:])])
        return rows

    def get_json(self, save: bool = False, verbose: bool = False):
        for split in ("train", "val", "test"):
            if not self.data.get(split):
                self.stats[split] = None
                continue
            im_files = _scan_images(self.data[split])
            nc = self.data["nc"]
            per_image = []
            labels = []
            for f in im_files:
                rows = self._read_rows(img2label_path(f))
                per_image.append(np.bincount(
                    np.asarray([r[0] for r in rows], dtype=int),
                    minlength=nc))
                labels.append({Path(f).name: rows})
            x = (np.stack(per_image) if per_image
                 else np.zeros((0, nc), dtype=int))
            self.stats[split] = {
                "instance_stats": {"total": int(x.sum()),
                                   "per_class": x.sum(0).tolist()},
                "image_stats": {"total": len(im_files),
                                "unlabelled": int(np.all(x == 0, 1).sum()),
                                "per_class": (x > 0).sum(0).tolist()},
                "labels": labels,
            }
        if save:
            self.hub_dir.mkdir(parents=True, exist_ok=True)
            sp = self.hub_dir / "stats.json"
            sp.write_text(json.dumps(self.stats))
            LOGGER.info(f"saved {sp}")
        if verbose:
            LOGGER.info(json.dumps(self.stats, indent=2))
        return self.stats

    def process_images(self) -> Path:
        """Compressed preview copies of every image (reference :431-443)."""
        self.im_dir.mkdir(parents=True, exist_ok=True)
        for split in ("train", "val", "test"):
            if not self.data.get(split):
                continue
            for f in _scan_images(self.data[split]):
                compress_one_image(f, self.im_dir / Path(f).name)
        LOGGER.info(f"compressed previews in {self.im_dir}")
        return self.im_dir
