"""Predict, val and train configuration and model-architecture lookup.

Every key of the JAX package's `cfg/default.yaml`, with its defaults but
`format` ('pt2'; the port writes no stablehlo), kept here as data: the
port reads no yaml at run time. `get_cfg` is JAX's (cfg/__init__.py:
121-149): a base config (the defaults, a dict, a namespace or a config
file) under the overrides, the overrides' keys checked, an unknown key
refused with `difflib` suggestions (JAX :80-90), the deprecated hide_* and
line_thickness keys mapped with JAX's warnings, every value typed; the
port adds its checks of its own string keys and that imgsz is a multiple
of 32. A few keys are carried with no effect, as in JAX (see DEFAULT_CFG).
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

from ..utils import LOGGER
from .models import MODELS

DEFAULT_CFG = {
    # the CLI's own (JAX __main__.py takes them from the arguments first)
    "task": "detect",            # detect | segment | pose | classify
    "mode": "train",             # train, val, predict, track, export, ...
    "model": None,               # architecture, checkpoint or .pt2
    "source": None,              # predict/track source
    "cfg": None,                 # a config file whose keys apply first
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
    "pose": 12.0,                # pose loss gains (engine/pose.py)
    "kobj": 1.0,
    "lrl": 2.0,                  # recovery-loss weight
    "label_smoothing": 0.0,      # classify: the one-hot targets smoothed
    "lowlight_FLAG": True,       # train on img ** dark_param
    "dark_param": 15.0,
    "dedark_FLAG": True,         # dark-channel priors for the DeDark filter
    "prior_mode": "default",     # default (A=0.8, IcA=0.5) | computed
    "amp": False,                # bf16 training (no loss scaling)
    "remat": -1,                 # recompute layers <= this index in the backward
    "mesh_shape": None,          # data-parallel ranks (None: the world size)
    "mesh_axes": ["data"],       # mesh axis names; the batch is sharded over 'data'
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
    # Carried with JAX's defaults and no effect, as in JAX, where no module
    # reads them: the reference's keys (classes, deterministic, dnn, dropout)
    # and the TF/ONNX export keys, read only by those formats (JAX
    # engine/exporter.py:167, :218), which the exporter refuses by name.
    "classes": None,
    "deterministic": True,
    "dnn": False,
    "dropout": 0.0,
    "keras": False,
    "optimize": False,
    "int8": False,
    "dynamic": False,
    "simplify": False,
    "opset": None,
    "workspace": 4,
    "nms": False,
    # JAX's TPU layouts of the same graph (JAX default.yaml:44-53): exact
    # algebra with identical checkpoints (tests/test_stem_s2d.py
    # test_eval_forward_exact), so the port takes them and keeps its graph
    "stem_s2d": True,
    "fpn_fuse": True,
}

AUGMENT_KEYS = ("mosaic", "mixup", "copy_paste", "hsv_h", "hsv_s", "hsv_v",
                "degrees", "translate", "scale", "shear", "perspective",
                "flipud", "fliplr", "photometric")

# JAX's typed key sets (JAX cfg/__init__.py:21-43), and the port's own keys
# of each type
CFG_FLOAT_KEYS = {
    "warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "dark_param", "lrl",
}
CFG_FRACTION_KEYS = {
    "dropout", "iou", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum",
    "warmup_bias_lr", "label_smoothing", "hsv_h", "hsv_s", "hsv_v", "translate",
    "scale", "perspective", "flipud", "fliplr", "mosaic", "mixup", "copy_paste",
    "conf", "fraction",
}
CFG_INT_KEYS = {
    "epochs", "patience", "batch", "workers", "seed", "close_mosaic", "mask_ratio",
    "max_det", "vid_stride", "line_width", "workspace", "nbs", "save_period",
    "max_boxes", "max_nms",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "overlap_mask", "val", "save_json", "save_hybrid", "half", "plots", "show",
    "save_txt", "save_conf", "save_crop", "show_labels", "show_conf", "visualize",
    "augment", "agnostic_nms", "retina_masks", "boxes", "keras", "optimize", "int8",
    "dynamic", "simplify", "nms", "profile", "lowlight_FLAG", "dedark_FLAG",
    "save_enhanced", "photometric", "fuse",
}
_NUMBER_KEYS = CFG_FLOAT_KEYS | {"pose", "kobj"}
_INT_KEYS = CFG_INT_KEYS | {"imgsz", "ckpt_period", "val_period", "remat"}
_BOOL_KEYS = CFG_BOOL_KEYS | {"amp", "resume", "loader_mp"}
_PRECISIONS = ("default", "tensorfloat32", "float32")

DEFAULT_CFG_DICT = DEFAULT_CFG
DEFAULT_CFG_KEYS = set(DEFAULT_CFG)


class IterableSimpleNamespace(SimpleNamespace):
    """SimpleNamespace that iterates its (key, value) pairs and has `get`
    (JAX cfg/__init__.py:46-56)."""

    def __iter__(self):
        return iter(vars(self).items())

    def __str__(self):
        return "\n".join(f"{k}={v}" for k, v in vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


def check_cfg_alignment(base_keys, custom: dict) -> None:
    """Raise SyntaxError for each key of `custom` not in `base_keys`, with
    the near-misses `difflib` finds among them (JAX cfg/__init__.py:80-90,
    the same message)."""
    msg = []
    for k in custom:
        if k in base_keys:
            continue
        matches = difflib.get_close_matches(k, set(base_keys))
        hint = f" Did you mean {matches}?" if matches else ""
        msg.append(f"'{k}' is not a valid config key.{hint}")
    if msg:
        raise SyntaxError("\n".join(msg))


def _coerce(k, v):
    """Type-check and coerce one config entry (JAX cfg/__init__.py:92-118,
    with the port's checks of its own string keys)."""
    if v is None:
        return v
    if k in CFG_FRACTION_KEYS:
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
    elif k == "mesh_shape":
        if not (isinstance(v, (list, tuple)) and v and all(
                isinstance(d, int) and not isinstance(d, bool) and d > 0
                for d in v)):
            raise TypeError(f"'mesh_shape={v}' must be a list of positive ints")
        v = list(v)
    elif k == "mesh_axes":
        if not (isinstance(v, (list, tuple)) and v
                and all(isinstance(x, str) for x in v)):
            raise TypeError(f"'mesh_axes={v}' must be a list of axis names")
        v = list(v)
    elif k == "matmul_precision" and v not in _PRECISIONS:
        raise ValueError(f"matmul_precision '{v}' is not one of "
                         f"{_PRECISIONS}")
    return v


def get_cfg(cfg=DEFAULT_CFG_DICT, overrides: dict | None = None
            ) -> IterableSimpleNamespace:
    """`overrides` merged into the base config `cfg` (a dict, a namespace,
    or a config file: .json, or yaml where PyYAML is installed), typed (JAX
    cfg/__init__.py:121-149). As in JAX, the base's keys are taken as they
    are and only the overrides' are checked; a `cfg` key among the
    overrides names a file whose keys apply first, under the other
    overrides; hide_labels, hide_conf and line_thickness map to
    show_labels, show_conf and line_width with JAX's warnings."""
    if isinstance(cfg, (str, Path)):
        cfg = yaml_load(cfg)
    elif isinstance(cfg, SimpleNamespace):
        cfg = vars(cfg)
    cfg = dict(cfg)
    if overrides:
        overrides = dict(overrides)
        sub = overrides.pop("cfg", None)
        if sub:
            cfg.update(yaml_load(sub))
        # deprecation shims (JAX cfg/__init__.py:139-147): hide_* keys
        # invert into their show_* replacements
        for old, new in (("hide_labels", "show_labels"),
                         ("hide_conf", "show_conf")):
            if old in overrides:
                LOGGER.warning(f"'{old}' is deprecated — use '{new}' instead")
                v = overrides.pop(old)
                overrides[new] = not (v if isinstance(v, bool) else v != "False")
        if "line_thickness" in overrides:
            LOGGER.warning("'line_thickness' is deprecated — use 'line_width'")
            overrides["line_width"] = overrides.pop("line_thickness")
        check_cfg_alignment(DEFAULT_CFG_KEYS, overrides)
        cfg.update(overrides)
    for k, v in list(cfg.items()):
        if isinstance(v, str) and v.lower() == "none":
            v = None
        cfg[k] = _coerce(k, v)
    imgsz = cfg.get("imgsz")
    if isinstance(imgsz, int) and imgsz % 32:
        raise ValueError(f"imgsz={imgsz} must be a multiple of 32")
    return IterableSimpleNamespace(**cfg)


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
