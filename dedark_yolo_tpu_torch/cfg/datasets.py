"""Dataset cards as Python data (copies of the JAX package's
`cfg/datasets/*.yaml`), so that `data='tielu.yaml'` resolves by name on a
host without PyYAML. Keyed by the card's file name.
"""

from __future__ import annotations

DATASETS = {
    # Railway-hazard ("tielu") low-light detection dataset, the one the
    # Dedark-YOLO fork was built around. The images are not distributed;
    # `path` points at a copy relative to the working directory. VOC sources
    # convert with data/voc.py, and utils/lowlight_process.py makes the dark
    # val split offline: validation measures detection on dark frames.
    "tielu.yaml": {
        "path": "../datasets/tielu-yolo",
        "train": "images/train",
        "val": "images/test_dark",
        "test": None,
        "names": {0: "person", 1: "debrisflow", 2: "rockfall"},
    },
}
