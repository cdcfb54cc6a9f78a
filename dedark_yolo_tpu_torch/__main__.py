"""CLI: `python -m dedark_yolo_tpu_torch [task] mode k=v ...` (JAX
`__main__.py`; reference `yolo TASK MODE k=v`, ultralytics/cfg/__init__.py:
286-423).

`train`, `val`, `predict`, `track`, `export` and `benchmark` run through
the `YOLO` facade on `device` (cuda unless `device=cpu`); each prints its
outcome as the last line of standard output, `results {json}`: the
results dict of train and val, the image and detection counts of predict,
the frame and identity counts of track, the artifact's path of export,
the rows of benchmark; segment predict also counts its masks. `predict` and `track`
save their annotated images unless `save=False`, as the JAX CLI does (JAX
`__main__.py:191-201`; drawing needs OpenCV). The task token picks the
task's default architecture where no `model=` is given (JAX `TASK_MODELS`);
a model of another task keeps its own, with a warning (JAX
`__main__.py:176-181`). `classify` trains, validates and predicts a classify
model (`engine/classify.py`; data is the folder tree's root; predict
prints the top-1 class of each image); `segment` a segment model
(`engine/segment.py`; val prints box and mask mAP). `serve` starts the
dynamic-batching HTTP server (`engine/server.py`; `port` key, `batch` the
batch size) and serves until interrupted. `model=` takes an exported
`.pt2` for predict, val and serve. The pose task, and segment's serve
and track, are not ported and exit with 1, naming their ROADMAP item; a
bare token that
is neither a task, a mode nor k=v exits with 2 and a suggestion.
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
UNPORTED = {"pose": "A12f"}
# (task, mode) pairs not ported yet
UNPORTED_MODES = {("segment", "serve"): "A12e-b", ("segment", "track"): "A12e-b"}
# task token -> its default architecture (JAX __main__.py:18-20)
TASK_MODELS = {"detect": "yolov8l.yaml", "segment": "yolov8-seg.yaml",
               "classify": "yolov8-cls.yaml"}
CLI_KEYS = ("model", "source", "cfg")
# keys of one mode that are arguments of its call, not config keys (JAX
# __main__.py:143-147)
MODE_KEYS = {"serve": ("port",), "track": ("persist",),
             "benchmark": ("formats", "export_dir", "batch_sizes", "iters")}

HELP = f"""dedark_yolo_tpu_torch CLI (PyTorch/CUDA)

    python -m dedark_yolo_tpu_torch [TASK] MODE k=v ...

modes: {', '.join(MODES)}
tasks: {', '.join(TASKS)} (ported: detect, segment, classify)
examples:
    python -m dedark_yolo_tpu_torch train model=yolov8l.yaml data=data.json epochs=5 imgsz=640 batch=16
    python -m dedark_yolo_tpu_torch val model=runs/detect/train/weights/best.npz data=data.json
    python -m dedark_yolo_tpu_torch predict model=best.npz source=images/ conf=0.4
    python -m dedark_yolo_tpu_torch track model=best.npz source=video.mp4 tracker=bytetrack.yaml
    python -m dedark_yolo_tpu_torch export model=best.npz format=pt2 imgsz=640 batch=16
    python -m dedark_yolo_tpu_torch predict model=runs/export/model.pt2 source=images/
    python -m dedark_yolo_tpu_torch benchmark model=best.npz batch_sizes=[1,8,32]
    python -m dedark_yolo_tpu_torch serve model=best.npz port=8080 batch=8
    python -m dedark_yolo_tpu_torch val model=best.npz data=data.json device=cpu
    python -m dedark_yolo_tpu_torch classify train model=yolov8n-cls.yaml data=imagenette/ imgsz=224
    python -m dedark_yolo_tpu_torch classify val model=runs/classify/train/weights/best.npz
    python -m dedark_yolo_tpu_torch segment train model=yolov8n-seg.yaml data=data.json imgsz=640
    python -m dedark_yolo_tpu_torch segment val model=runs/segment/train/weights/best.npz
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
    task = task or overrides.pop("task", None)
    for what in (mode, task, (task, mode)):
        item = UNPORTED.get(what) or UNPORTED_MODES.get(what)
        if item:
            name = " ".join(what) if isinstance(what, tuple) else what
            LOGGER.error(f"'{name}' is not ported to dedark_yolo_tpu_torch "
                         f"yet (ROADMAP {item}); use "
                         "python -m dedark_yolo_tpu for it")
            return 1
    if mode not in MODES or (task is not None and task not in TASKS):
        LOGGER.error(f"unknown mode '{mode}' or task '{task}' (see 'help')")
        return 2
    check_cfg_alignment(set(DEFAULT_CFG) | set(CLI_KEYS)
                        | set(MODE_KEYS.get(mode, ())), overrides)
    if task is not None and "model" not in overrides:
        overrides["model"] = TASK_MODELS[task]
    try:
        return _run(mode, task, overrides)
    except NotImplementedError as e:
        LOGGER.error(str(e))
        return 1


def _run(mode, task, overrides) -> int:
    model_spec = overrides.pop("model", None) or "yolov8l.yaml"
    if mode == "serve":
        return _serve(model_spec, overrides)
    from .engine.model import YOLO
    model = YOLO(model_spec, device=overrides.get("device"))
    if task is not None and model.task != task:
        LOGGER.warning(f"task '{task}' conflicts with {model_spec} "
                       f"(task={model.task}); using the model's task")
    if mode == "train":
        _results(model.train(**overrides))
    elif mode == "val":
        _results(model.val(**overrides))
    elif mode == "benchmark":
        _results(model.benchmark(**overrides))
    elif mode == "export":
        _results({"path": model.export(**overrides)})
    else:
        source = overrides.pop("source", None)
        if source is None:
            LOGGER.error(f"{mode} requires source=...")
            return 1
        call = model.track if mode == "track" else model.predict
        results = call(source, **{"save": True, **overrides})
        if mode == "track":
            ids = {int(i) for r in results
                   for i in (r.boxes.id if r.boxes.is_track else [])}
            LOGGER.info(f"tracked {len(results)} frames, {len(ids)} identities")
            _results({"frames": len(results), "identities": len(ids)})
            return 0
        LOGGER.info(f"processed {len(results)} images")
        if model.task == "classify":
            _results({"images": len(results),
                      "top1": [r.probs.top1 for r in results]})
            return 0
        if model.task == "segment":
            _results({"images": len(results),
                      "detections": int(sum(len(r) for r in results)),
                      "masks": int(sum(len(r.masks) for r in results))})
            return 0
        _results({"images": len(results),
                  "detections": int(sum(len(r) for r in results))})
    return 0


def _serve(model_spec, overrides) -> int:
    """The HTTP server on `port` (default 8080) until interrupted (JAX
    __main__.py:150-170); `batch` is its batch size (default 8)."""
    import time
    from .engine.server import InferenceServer
    srv = InferenceServer(
        model_spec, imgsz=int(overrides.get("imgsz", 640)),
        max_batch=int(overrides.get("batch", 8)),
        conf=float(overrides.get("conf", 0.25)),
        iou=float(overrides.get("iou", 0.7)),
        max_det=int(overrides.get("max_det", 300)),
        half=bool(overrides.get("half", False)),
        device=overrides.get("device"))
    httpd, _ = srv.serve(port=int(overrides.get("port", 8080)))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
