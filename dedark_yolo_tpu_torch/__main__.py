"""CLI: `python -m dedark_yolo_tpu_torch [task] mode k=v ...` (JAX
`__main__.py`; reference `yolo TASK MODE k=v`, ultralytics/cfg/__init__.py:
286-423).

`train`, `val` and `predict` run through the `YOLO` facade on `device`
(cuda unless `device=cpu`); each prints its outcome as the last line of
standard output, `results {json}`: the results dict of train and val, the
image and detection counts of predict. `predict` saves the annotated
images unless `save=False`, as the JAX CLI does (JAX `__main__.py:191`;
drawing needs OpenCV). The modes track, export, benchmark and serve and
the tasks segment, pose and classify are not ported and exit with 1,
naming their ROADMAP item; a bare token
that is neither a task, a mode nor k=v exits with 2 and a suggestion.
Special commands: help, version, cfg (the defaults as JSON), checks,
settings and copy-cfg (the defaults as a JSON file that `cfg=` reads back).
"""

from __future__ import annotations

import difflib
import json
import platform
import subprocess
import sys
from pathlib import Path

from .cfg import DEFAULT_CFG, check_cfg_alignment
from .utils import LOGGER

MODES = ("train", "val", "predict", "track", "export", "benchmark", "serve")
TASKS = ("detect", "segment", "pose", "classify")
SPECIAL = ("help", "version", "cfg", "checks", "settings", "copy-cfg")
UNPORTED = {"track": "A12", "export": "A12", "benchmark": "A12",
            "serve": "A12", "segment": "A12", "pose": "A12",
            "classify": "A12"}
CLI_KEYS = ("model", "source", "cfg")

HELP = f"""dedark_yolo_tpu_torch CLI (PyTorch/CUDA)

    python -m dedark_yolo_tpu_torch [TASK] MODE k=v ...

modes: {', '.join(MODES)} (ported: train, val, predict)
tasks: {', '.join(TASKS)} (ported: detect)
examples:
    python -m dedark_yolo_tpu_torch train model=yolov8l.yaml data=data.json epochs=5 imgsz=640 batch=16
    python -m dedark_yolo_tpu_torch val model=runs/detect/train/weights/best.npz data=data.json
    python -m dedark_yolo_tpu_torch predict model=best.npz source=images/ conf=0.4
    python -m dedark_yolo_tpu_torch val model=best.npz data=data.json device=cpu
special:
    python -m dedark_yolo_tpu_torch cfg        # the default config as JSON
    python -m dedark_yolo_tpu_torch checks     # torch, CUDA, the device, nvcc, numpy
    python -m dedark_yolo_tpu_torch settings   # the persistent settings
    python -m dedark_yolo_tpu_torch copy-cfg   # write ./default_copy.json (use with cfg=)
    python -m dedark_yolo_tpu_torch version
"""


def _default_json() -> str:
    return json.dumps(DEFAULT_CFG, indent=1)


def _checks():
    import numpy
    import torch
    from . import __version__
    print(f"dedark_yolo_tpu_torch {__version__}")
    print(f"python          {platform.python_version()}")
    print(f"platform        {platform.platform()}")
    print(f"torch           {torch.__version__} (CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"devices         {n} x {torch.cuda.get_device_name(0)}")
    else:
        print("devices         no CUDA device")
    from .ops._build import _nvcc
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"nvcc            {out.splitlines()[-1] if out else '?'}")
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        print(f"nvcc            MISSING ({e})")
    print(f"numpy           {numpy.__version__}")


def _special_command(cmd) -> int:
    if cmd == "version":
        from . import __version__
        print(__version__)
    elif cmd == "cfg":
        print(_default_json())
    elif cmd == "checks":
        _checks()
    elif cmd == "settings":
        from .utils.settings import get_settings
        st = get_settings()
        print(f"settings saved at {st.file}")
        print(json.dumps(dict(st), indent=1))
    elif cmd == "copy-cfg":
        dst = Path.cwd() / "default_copy.json"
        dst.write_text(_default_json() + "\n", encoding="utf-8")
        print(f"copied the default config to {dst}\n"
              f"use with: python -m dedark_yolo_tpu_torch train "
              f"cfg={dst.name} ...")
    else:
        print(HELP)
    return 0


def _parse_value(v: str):
    """A k=v value: bool, None, int, float, a [list], else the string
    (JAX __main__.py `_parse_value`)."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("none", "null", ""):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [_parse_value(x.strip()) for x in inner.split(",")] if inner else []
    return v


def _results(payload) -> None:
    print("results " + json.dumps(payload, default=float))


def entrypoint(argv=None) -> int:
    """Run one CLI command; returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(HELP)
        return 0
    if argv[0] in SPECIAL:
        return _special_command(argv[0])

    mode = task = None
    overrides = {}
    for a in argv:
        if a in MODES:
            mode = a
        elif a in TASKS:
            task = a
        elif "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = _parse_value(v)
        else:
            cand = difflib.get_close_matches(a, MODES + TASKS + SPECIAL, n=1)
            hint = f" — did you mean '{cand[0]}'?" if cand else ""
            LOGGER.error(f"unrecognized argument '{a}'{hint} "
                         f"(expected TASK, MODE or k=v; see 'help')")
            return 2
    if mode is None:
        mode = overrides.pop("mode", "predict")
    task = task or overrides.pop("task", None) or "detect"
    for what in (mode, task):
        if what in UNPORTED:
            LOGGER.error(f"'{what}' is not ported to dedark_yolo_tpu_torch "
                         f"yet (ROADMAP {UNPORTED[what]}); use "
                         "python -m dedark_yolo_tpu for it")
            return 1
    if mode not in MODES or task not in TASKS:
        LOGGER.error(f"unknown mode '{mode}' or task '{task}' (see 'help')")
        return 2
    check_cfg_alignment(set(DEFAULT_CFG) | set(CLI_KEYS), overrides)

    from .engine.model import YOLO
    model = YOLO(overrides.pop("model", None) or "yolov8l.yaml",
                 device=overrides.get("device"))
    if mode == "train":
        _results(model.train(**overrides))
    elif mode == "val":
        _results(model.val(**overrides))
    else:
        source = overrides.pop("source", None)
        if source is None:
            LOGGER.error("predict requires source=...")
            return 1
        results = model.predict(source, **{"save": True, **overrides})
        LOGGER.info(f"processed {len(results)} images")
        _results({"images": len(results),
                  "detections": int(sum(len(r) for r in results))})
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
