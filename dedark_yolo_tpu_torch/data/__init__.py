"""Datasets, loaders and the offline dataset tools. The converters are
importable on a host without PyYAML or OpenCV: each imports them when a
call needs them."""

from .coco import convert_coco
from .voc import convert_voc_to_yolo

__all__ = ["convert_coco", "convert_voc_to_yolo"]
