"""VOC -> YOLO dataset converter (JAX data/voc.py, reference
ultralytics/utils/voc2yolo.py:36-158): VOC XML bndbox annotations to
normalised cxcywh label files, the images copied per
ImageSets/Main/<split>.txt, and a data.yaml written through PyYAML
(imported at call time)."""

from __future__ import annotations

import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

from ..utils.patches import require


def convert_box(size_wh, box_xyxy):
    """VOC (xmin, ymin, xmax, ymax) -> normalized (cx, cy, w, h)."""
    w, h = size_wh
    xmin, ymin, xmax, ymax = box_xyxy
    return ((xmin + xmax) / 2 / w, (ymin + ymax) / 2 / h,
            (xmax - xmin) / w, (ymax - ymin) / h)


def parse_voc_xml(xml_path, class_names):
    """One VOC XML -> list of (class_idx, cx, cy, w, h). Objects of an
    unknown class or marked difficult are skipped; boxes are clipped to the
    image and dropped when nothing is left."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    rows = []
    for obj in root.iter("object"):
        name = obj.find("name").text
        if name not in class_names:
            continue
        difficult = obj.find("difficult")
        if difficult is not None and int(difficult.text) == 1:
            continue
        bb = obj.find("bndbox")
        box = [float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
        box = [max(box[0], 0), max(box[1], 0), min(box[2], w), min(box[3], h)]
        if box[2] <= box[0] or box[3] <= box[1]:
            continue
        rows.append((class_names.index(name), *convert_box((w, h), box)))
    return rows


def convert_voc_to_yolo(voc_root, out_root, class_names, splits=("train", "val"),
                        copy_images=True):
    """Convert a VOCdevkit-style tree to the YOLO images/labels layout.

    voc_root must contain Annotations/, JPEGImages/, ImageSets/Main/<split>.txt.
    Produces out_root/{images,labels}/{split}/ and out_root/data.yaml; an
    id without an XML gets an empty label file.
    """
    yaml = require("yaml", "writing data.yaml (convert_voc_to_yolo)")
    voc_root, out_root = Path(voc_root), Path(out_root)
    class_names = list(class_names)
    for split in splits:
        split_file = voc_root / "ImageSets" / "Main" / f"{split}.txt"
        ids = [line.strip().split()[0] for line in split_file.read_text().splitlines()
               if line.strip()]
        img_dir = out_root / "images" / split
        lbl_dir = out_root / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lbl_dir.mkdir(parents=True, exist_ok=True)
        for iid in ids:
            xml = voc_root / "Annotations" / f"{iid}.xml"
            rows = parse_voc_xml(xml, class_names) if xml.is_file() else []
            with open(lbl_dir / f"{iid}.txt", "w") as f:
                for r in rows:
                    f.write(f"{r[0]} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} {r[4]:.6f}\n")
            src = voc_root / "JPEGImages" / f"{iid}.jpg"
            if copy_images and src.is_file():
                shutil.copy2(src, img_dir / src.name)
    data = {"path": str(out_root),
            "train": "images/train" if "train" in splits else None,
            "val": "images/val" if "val" in splits else None,
            "nc": len(class_names),
            "names": {i: n for i, n in enumerate(class_names)}}
    with open(out_root / "data.yaml", "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    return out_root / "data.yaml"
