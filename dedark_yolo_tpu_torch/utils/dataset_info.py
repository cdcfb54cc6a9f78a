"""Dataset statistics (JAX utils/dataset_info.py, reference
ultralytics/utils/clac_dataset_info.py:17-148): per-class image and
instance counts and the small/medium/large split of the objects by their
area relative to the image (0.5% and 10%), written to dataset_status.json."""

from __future__ import annotations

import json
from pathlib import Path

from ..data.dataset import YOLODataset, check_det_dataset
from . import LOGGER

SMALL_THR = 0.005   # rel-area < 0.5% -> small
LARGE_THR = 0.10    # rel-area > 10%  -> large


def calc_dataset_info(data, split="train", out_path=None):
    """The counts of `data[split]` (a dataset yaml, dict or packaged card);
    written to `out_path`, by default `<path>/dataset_status.json`."""
    d = check_det_dataset(data)
    names = d["names"]
    ds = YOLODataset(d[split], nc=d["nc"])
    stats = {str(names.get(c, c)): {"images": 0, "instances": 0,
                                    "small": 0, "medium": 0, "large": 0}
             for c in range(d["nc"])}
    for lb in ds.labels:
        seen = set()
        for row in lb:
            c = int(row[0])
            key = str(names.get(c, c))
            stats[key]["instances"] += 1
            if c not in seen:
                stats[key]["images"] += 1
                seen.add(c)
            area = float(row[3] * row[4])  # normalized w*h = relative area
            if area < SMALL_THR:
                stats[key]["small"] += 1
            elif area > LARGE_THR:
                stats[key]["large"] += 1
            else:
                stats[key]["medium"] += 1
    result = {"total_images": len(ds), "split": split, "classes": stats}
    out_path = Path(out_path or Path(d["path"]) / "dataset_status.json")
    out_path.write_text(json.dumps(result, indent=2))
    LOGGER.info(f"dataset stats written to {out_path}")
    return result
