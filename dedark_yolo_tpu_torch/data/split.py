"""Dataset splitting (JAX data/split.py, reference ultralytics/data/utils.py
autosplit): autosplit_{train,val,test}.txt index files from an images dir."""

from __future__ import annotations

import random
from pathlib import Path

from .dataset import IMG_FORMATS, img2label_path


def autosplit(path, weights=(0.9, 0.1, 0.0), annotated_only=False, seed=0):
    """Split an images dir into train/val/test txt lists (paths relative to
    its parent), each image drawn with `random.Random(seed)` by `weights`;
    `annotated_only` keeps the images that have a label file. The three
    files are written beside `path`, the old ones removed first."""
    path = Path(path)
    files = sorted(f for f in path.rglob("*") if f.suffix.lower() in IMG_FORMATS)
    if annotated_only:
        files = [f for f in files if Path(img2label_path(str(f))).is_file()]
    rng = random.Random(seed)
    names = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for n in names:
        (path.parent / n).unlink(missing_ok=True)
    cum, total = [], 0.0
    for w in weights:
        total += w
        cum.append(total)
    for f in files:
        r = rng.random() * total
        k = next(i for i, c in enumerate(cum) if r <= c)
        with open(path.parent / names[k], "a") as fh:
            fh.write(f"./{f.relative_to(path.parent)}\n")
    return [path.parent / n for n in names]
