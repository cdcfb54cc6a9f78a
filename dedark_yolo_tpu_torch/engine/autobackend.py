"""AutoBackend: one inference interface over the port's deployment formats
(JAX engine/autobackend.py).

  - `.pt2`  a `torch.export` program written by `engine/exporter.py`
            (weights embedded; its sidecar `.pt2.json` gives imgsz, batch,
            task, names and the outputs). The enhance ops are registered
            before it loads; an artifact exported on another device is
            moved to this one (`torch.export.passes.move_to_device_pass`).
  - `.npz`  a checkpoint of either package, and `.yaml` an architecture
            (seeded weights), or a `YOLO` facade itself: the live model
            through `DetectionModel.eval_outputs`, with `half` on bf16
            casts of its float parameters (the benchmark's bf16 route,
            `engine/benchmarks.bf16_params`).
The JAX package's `.bin`, `.tflite` and saved_model directories need its
own runtimes and raise here.

`forward(img_u8)` takes a (batch, imgsz, imgsz, 3) uint8 RGB batch (numpy
or a tensor) and returns the task's tuple, detect (boxes_xywh, scores),
segment (boxes_xywh, scores, coefs (B, N, nm), protos (B, mh, mw, nm)) or
classify (probs,), f32 on the backend's device, not waited for. `task`
comes from the sidecar, or from the live model. The outputs come in
export order from every format, so there is no `_demux`. `warmup()` runs
one batch.
The device is cuda unless the caller passes another; cuda without a card
raises (`predictor.resolve_device`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..utils import LOGGER
from .predictor import resolve_device



def refuse_jax_artifact(spec):
    """Raise for an artifact of the JAX package (a jax.export `.bin`, a
    `.tflite`, a TF saved_model directory): its runtimes are not the
    port's."""
    s = str(spec)
    if s.endswith((".bin", ".tflite")) or (Path(s) / "saved_model.pb").is_file():
        raise NotImplementedError(
            f"'{s}' is an artifact of the JAX package (jax.export, TFLite or "
            "a TF saved_model); run it with dedark_yolo_tpu, or export "
            "format='pt2' from dedark_yolo_tpu_torch")


class AutoBackend:
    def __init__(self, model_spec, imgsz=640, batch=1, half=False,
                 device=None):
        self.device = resolve_device(device)
        self.imgsz = imgsz
        self.batch = batch
        self.half = half
        self.names = {}
        self.task = "detect"
        self.nc = None
        self.format = self._model_type(model_spec)
        LOGGER.info(f"AutoBackend: loading {model_spec} as '{self.format}' "
                    f"on {self.device}")
        if self.format == "pt2":
            from ..ops import enhance_kernel  # noqa: F401  registers the ops
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(torch.export.load(str(model_spec)),
                                     self.device)
            self._read_sidecar(Path(str(model_spec) + ".json"))
            self._fn = ep.module()           # built once: it is costly
        else:
            from .benchmarks import bf16_params
            from .exporter import U8Program
            from .model import YOLO
            y = (model_spec if isinstance(model_spec, YOLO)
                 else YOLO(str(model_spec), device=self.device))
            y._args({})                      # the checkpoint's contrast_mode
            model = y.model.to(self.device).eval()
            self.names = dict(y.names)
            self.nc = model.nc
            self.task = model.task
            self._fn = U8Program(
                model, torch.bfloat16 if half else torch.float32,
                bf16_params(model) if half else None)

    def _read_sidecar(self, path):
        if Path(path).is_file():
            meta = json.loads(Path(path).read_text())
            self.imgsz = int(meta.get("imgsz", self.imgsz))
            self.batch = int(meta.get("batch", self.batch))
            self.task = meta.get("task", self.task)
            self.nc = meta.get("nc", self.nc)
            self.names = {int(k): v for k, v in meta.get("names", {}).items()}

    @staticmethod
    def _model_type(spec):
        from .model import YOLO
        if isinstance(spec, YOLO):
            return "live"
        s = str(spec)
        if s.endswith(".pt2"):
            return "pt2"
        if s.endswith(".npz"):
            return "checkpoint"
        if s.endswith((".yaml", ".yml")):
            return "yaml"
        refuse_jax_artifact(s)
        raise ValueError(f"unrecognized model format: {spec}")

    @torch.inference_mode()
    def forward(self, img_u8):
        """(batch, imgsz, imgsz, 3) uint8 RGB -> detect (boxes_xywh (B, N,
        4), scores (B, N, nc)), segment (boxes_xywh, scores, coefs, protos)
        or classify (probs (B, nc),), f32 on the device."""
        x = (torch.from_numpy(np.ascontiguousarray(img_u8))
             if isinstance(img_u8, np.ndarray) else img_u8)
        return tuple(self._fn(x.to(self.device)))

    __call__ = forward

    def warmup(self):
        dummy = np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
        self.forward(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
