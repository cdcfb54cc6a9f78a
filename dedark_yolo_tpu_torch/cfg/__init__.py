"""Predict, val and train configuration and model-architecture lookup.

The predict keys (TTA, save_enhanced, visualize, the plot and saving keys,
vid_stride among them) and the keys the validator, the train step and the
train loop read of the JAX package's `cfg/default.yaml`, with the same
defaults, plus `device`. A key of the JAX package's defaults that the port does not
carry (`UNPORTED_KEYS`) is refused as not ported; any other unknown key as
unknown, with `difflib` suggestions (JAX cfg/__init__.py:80-90).
`model_yaml_load` resolves a scaled name such as `yolov8l.yaml` to the
unified architecture at scale `l`, as the JAX package does; the built-in
architectures live in `cfg/models.py`. `yaml_load` reads a `.json` file
with `json` and imports `yaml` only for another file on disk; `yaml_save`
writes JSON (valid YAML, which the JAX package's `yaml_load` reads), so a
host without PyYAML reads and writes JSON configs and datasets.
"""

from __future__ import annotations

import copy
import difflib
import json
import re
from pathlib import Path
from types import SimpleNamespace

from .models import MODELS

DEFAULT_CFG = {
    "imgsz": 640,                # square letterbox size, a multiple of 32
    "conf": None,                # None = 0.25 for predict, 0.001 for val
    "iou": 0.7,                  # NMS IoU threshold
    "max_det": 300,              # detections kept per image
    "max_nms": 2048,             # candidates entering NMS after the top-k gate
    "half": False,               # bf16 image into layer 0 (params stay f32)
    "batch": 16,                 # images per device batch (train: < 0 = autobatch)
    "agnostic_nms": False,       # class-agnostic suppression
    "contrast_mode": "channel",  # 'channel' | 'reference' contrast luminance
    "matmul_precision": "default",  # default | tensorfloat32 | float32
    "device": None,              # None = 'cuda'
    "augment": False,            # TTA: scales 1, 0.83, 0.67, the middle flipped
    "save_enhanced": False,      # keep layer 0's output (Results.enhanced_img)
    "visualize": False,          # keep every layer's activations (Results.features)
    "save_crop": False,          # one crop a detection under crops/<class>/
    "show": False,               # an OpenCV window a result
    "show_labels": True,         # plot: class labels
    "show_conf": True,           # plot: confidences
    "boxes": True,               # plot: boxes (False: the bare image)
    "line_width": None,          # plot: box width (None: from the image size)
    "vid_stride": 1,             # every n-th video frame
    "tracker": "botsort.yaml",   # track: botsort.yaml | bytetrack.yaml | a tracker file
    # export (engine/exporter.py)
    "format": "pt2",             # pt2 (torch.export) | npz (weights) | onnx
    "fuse": False,               # RepConv to deploy form (no ported graph has one)
    # val (engine/validator.py)
    "data": None,                # dataset yaml path, or the dataset dict
    "split": "val",              # dataset split to validate
    "rect": False,               # aspect-ratio buckets instead of squares
    "save_json": False,          # COCO-style predictions.json
    "save_txt": False,           # one normalised-xywh label file an image
    "save_conf": False,          # ... with the confidence column
    "save_hybrid": False,        # labels join the candidates before NMS
    "plots": True,               # val/train plots (matplotlib, OpenCV), TensorBoard
    "verbose": True,             # the per-class log
    "single_cls": False,         # every class as class 0
    "max_boxes": 0,              # label rows a batch image; 0 = densest image
    "workers": 8,                # loader threads (processes with loader_mp)
    "cache": False,              # False | True/'ram' | 'disk' (.npy sidecars)
    "exist_ok": False,           # reuse runs/detect/val instead of val2, ...
    # train step (engine/trainer.py)
    "epochs": 100,               # sets the lr schedule's length
    "optimizer": "auto",         # SGD | Adam | AdamW | auto
    "lr0": 0.01,                 # initial lr
    "lrf": 0.01,                 # final lr, a fraction of lr0
    "momentum": 0.937,           # SGD momentum / Adam beta1
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "cos_lr": False,
    "nbs": 64,                   # nominal batch: gradients summed up to it
    "box": 7.5,                  # loss gains
    "cls": 0.5,
    "dfl": 1.5,
    "lrl": 2.0,                  # recovery-loss weight
    "label_smoothing": 0.0,      # classify: the one-hot targets smoothed
    "lowlight_FLAG": True,       # train on img ** dark_param
    "dark_param": 15.0,
    "dedark_FLAG": True,         # dark-channel priors for the DeDark filter
    "prior_mode": "default",     # default (A=0.8, IcA=0.5) | computed
    "amp": False,                # bf16 training (no loss scaling)
    # train loop (engine/trainer.py DetectionTrainer.train)
    "save": True,                # checkpoints (last, best, epochN)
    "save_period": -1,           # epoch{N}.npz every N epochs (< 1: never)
    "ckpt_period": 1,            # refresh last.npz every N epochs
    "val": True,                 # validate the EMA weights during training
    "val_period": 1,             # every N epochs (always the final one)
    "patience": 50,              # EarlyStopping: epochs without improvement
    "close_mosaic": 0,           # mosaic off for the last N epochs
    "resume": False,             # continue from save_dir/weights/last.npz
    "loader_mp": False,          # train loader workers as forked processes
    "profile": False,            # trace micro-step 2 with torch.profiler
    "pretrained": True,          # True/False, or an .npz to warm-start from
    "project": None,             # run dir parent (None: runs/detect)
    "name": None,                # run dir name (None: train)
    "seed": 0,                   # shuffle and augmentation seed
    "fraction": 1.0,             # share of the train images used
    # train augmentation (data/augment.py TrainTransforms)
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,
    "copy_paste": 0.0,           # segment only: flipped instances pasted
    # segment (engine/segment.py)
    "mask_ratio": 4,             # GT and proto masks at imgsz / mask_ratio
    "overlap_mask": True,        # GT masks overlap-encoded in one raster
    "retina_masks": False,       # predict: masks upsampled from probabilities
    "photometric": True,         # Blur/MedianBlur/ToGray/CLAHE, each p=0.01
}

AUGMENT_KEYS = ("mosaic", "mixup", "copy_paste", "hsv_h", "hsv_s", "hsv_v",
                "degrees", "translate", "scale", "shear", "perspective",
                "flipud", "fliplr", "photometric")

_FLOAT_KEYS = {"conf", "iou", "hsv_h", "hsv_s", "hsv_v", "translate",
               "scale", "perspective", "flipud", "fliplr", "mosaic", "mixup",
               "copy_paste", "fraction"}
_NUMBER_KEYS = {"lr0", "lrf", "momentum", "weight_decay", "warmup_epochs",
                "warmup_momentum", "warmup_bias_lr", "box", "cls", "dfl",
                "lrl", "dark_param", "degrees", "shear", "label_smoothing"}
_INT_KEYS = {"imgsz", "max_det", "max_nms", "batch", "epochs", "nbs",
             "max_boxes", "workers", "save_period", "ckpt_period",
             "val_period", "patience", "close_mosaic", "seed", "vid_stride",
             "line_width", "mask_ratio"}
_BOOL_KEYS = {"half", "agnostic_nms", "cos_lr", "lowlight_FLAG", "dedark_FLAG",
              "amp", "rect", "save_json", "save_txt", "save_conf",
              "save_hybrid", "plots", "verbose", "single_cls", "exist_ok",
              "save", "val", "resume", "photometric", "loader_mp", "profile",
              "augment", "save_enhanced", "visualize", "save_crop", "show",
              "show_labels", "show_conf", "boxes", "fuse", "overlap_mask",
              "retina_masks"}
_PRECISIONS = ("default", "tensorfloat32", "float32")

# Keys of the JAX package's cfg/default.yaml that the port does not carry:
# the export, mesh and other-task keys (ROADMAP A10b, A12), and
# the CLI's own model/source/mode/task/cfg, which the CLI takes before the
# config is checked.
UNPORTED_KEYS = frozenset((
    "cfg", "classes", "deterministic", "dnn", "dropout", "dynamic",
    "fpn_fuse", "int8", "keras", "kobj", "mesh_axes", "mesh_shape", "mode",
    "model", "nms", "opset", "optimize", "pose", "remat", "simplify",
    "source", "stem_s2d", "task", "workspace"))


def check_cfg_alignment(base_keys, custom: dict) -> None:
    """Raise SyntaxError for each key of `custom` not in `base_keys`: a key
    of the JAX package's defaults as not ported, any other as unknown with
    the near-misses `difflib` finds among every key the JAX package knows
    (JAX cfg/__init__.py:80-90, the same suggestions)."""
    known = set(base_keys) | UNPORTED_KEYS
    msg = []
    for k in custom:
        if k in base_keys:
            continue
        if k in UNPORTED_KEYS:
            msg.append(f"'{k}' is a config key of the JAX package that is "
                       "not ported to dedark_yolo_tpu_torch (ROADMAP "
                       "A10b, A12)")
            continue
        matches = difflib.get_close_matches(k, known)
        hint = f" Did you mean {matches}?" if matches else ""
        msg.append(f"'{k}' is not a valid config key.{hint}")
    if msg:
        raise SyntaxError("\n".join(msg))


def _coerce(k, v):
    """Type-check and coerce one config entry (JAX cfg/__init__.py:92-118,
    with the port's checks of its own string keys)."""
    if v is None:
        return v
    if k in _FLOAT_KEYS:
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a number")
        v = float(v)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"'{k}={v}' must be in [0, 1]")
    elif k in _NUMBER_KEYS:
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a number")
        v = float(v)
    elif k in _INT_KEYS:
        if isinstance(v, float) and v.is_integer():
            v = int(v)
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be an int")
    elif k in _BOOL_KEYS and not isinstance(v, bool):
        raise TypeError(f"'{k}={v}' must be a bool")
    elif k == "contrast_mode" and v not in ("channel", "reference"):
        raise ValueError(f"contrast_mode '{v}' is not channel|reference")
    elif k == "prior_mode" and v not in ("default", "computed"):
        raise ValueError(f"prior_mode '{v}' is not default|computed")
    elif k == "cache" and v not in (False, True, "ram", "disk"):
        raise ValueError(f"cache '{v}' is not False|True|ram|disk")
    elif k == "data" and not isinstance(v, (str, Path, dict)):
        raise TypeError(f"'data={v}' must be a path or a dict")
    elif k == "pretrained" and not isinstance(v, (bool, str, Path)):
        raise TypeError(f"'pretrained={v}' must be a bool or a path")
    elif k in ("project", "name", "tracker") and not isinstance(v, (str, Path)):
        raise TypeError(f"'{k}={v}' must be a path")
    elif k == "matmul_precision" and v not in _PRECISIONS:
        raise ValueError(f"matmul_precision '{v}' is not one of "
                         f"{_PRECISIONS}")
    return v


def get_cfg(overrides: dict | None = None) -> SimpleNamespace:
    """Merge `overrides` into the defaults, type-checked. A `cfg` key names
    a config file (.json, or yaml) whose keys apply first, under the other
    overrides (JAX cfg/__init__.py:128-136)."""
    cfg = dict(DEFAULT_CFG)
    overrides = dict(overrides or {})
    sub = overrides.pop("cfg", None)
    if sub:
        overrides = {**yaml_load(sub), **overrides}
    check_cfg_alignment(DEFAULT_CFG.keys(), overrides)
    for k, v in overrides.items():
        if isinstance(v, str) and v.lower() == "none":
            v = None
        cfg[k] = _coerce(k, v)
    if cfg["imgsz"] % 32:
        raise ValueError(f"imgsz={cfg['imgsz']} must be a multiple of 32")
    return SimpleNamespace(**cfg)


def yaml_load(path) -> dict:
    """A config or dataset file as a dict: `.json` through json (no PyYAML
    needed), any other file through yaml.safe_load."""
    path = Path(path)
    with open(path, errors="ignore", encoding="utf-8") as f:
        if path.suffix.lower() == ".json":
            return json.load(f) or {}
        import yaml
        return yaml.safe_load(f) or {}


def yaml_save(path, data: dict) -> None:
    """Write `data` to `path` as JSON, which is valid YAML: the JAX
    package's `yaml_load` reads it back (JAX cfg/__init__.py:59-70)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    clean = {k: (str(v) if isinstance(v, Path) else v) for k, v in data.items()}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(clean, f, indent=1, default=str)
        f.write("\n")


def model_yaml_load(path) -> dict:
    """Architecture dict for `path`, with the scale letter from its name.

    'yolov8l.yaml' resolves to the unified 'yolov8.yaml' with scale 'l'. A
    file on disk wins over the built-in architectures of the same name.
    """
    path = Path(path)
    m = re.search(r"v\d+([nslmx])", path.stem)
    scale = m.group(1) if m else ""
    unified = Path(re.sub(r"(\d+)([nslmx])(.+)?$", r"\1\3", str(path)))
    d = None
    for candidate in (unified, path):
        if candidate.is_file():
            d = yaml_load(candidate)
            break
    else:
        for name in (unified.name, path.name):
            if name in MODELS:
                d = copy.deepcopy(MODELS[name])
                break
    if d is None:
        raise FileNotFoundError(f"model architecture not found: {path}")
    d["scale"] = scale
    d["yaml_file"] = str(path)
    return d
