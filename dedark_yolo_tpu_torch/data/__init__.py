"""Datasets, loaders and the offline dataset tools, under the JAX
package's names (JAX data/__init__.py). The converters are importable on a
host without PyYAML or OpenCV: each imports them when a call needs them."""

from .augment import Sample, TrainTransforms, ValTransforms, letterbox
from .coco import convert_coco
from .dataset import (YOLODataset, check_det_dataset, img2label_path,
                      verify_label)
from .loader import DataLoader, collate
from .voc import convert_voc_to_yolo

__all__ = [
    "YOLODataset", "check_det_dataset", "img2label_path", "verify_label",
    "DataLoader", "collate", "TrainTransforms", "ValTransforms", "letterbox",
    "Sample", "convert_voc_to_yolo", "convert_coco",
]
