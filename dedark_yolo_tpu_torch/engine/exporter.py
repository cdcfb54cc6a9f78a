"""Exporter: the model's inference program as a deployable artifact (JAX
engine/exporter.py).

The program is JAX's `infer_u8`: a (batch, imgsz, imgsz, 3) uint8 RGB batch,
divided by 255 in the compute dtype, through `DetectionModel.eval_outputs`
(detect: layer 0's enhance chain, the graph, the DFL decode; segment: the
same with the flattened mask coefficients and the NHWC protos; classify:
the graph and the softmax), each output cast to f32. Its shapes are fixed, as
JAX's are. NMS stays outside it, as in JAX.

Formats:
  - `pt2` (aliases `export`, `bin`, `serialized`): `torch.export.export` of
    the program, written by `torch.export.save` as `model.pt2`, weights
    embedded, plus the sidecar `model.pt2.json` (JAX's `.bin` and its
    sidecar: imgsz, batch, nc, task, names and the ordered outputs). Layer
    0's kernels are registered torch ops (`ops/enhance_kernel.py`), so the
    program keeps each as one node; run on the card it launches them.
  - `npz` (aliases `weights`, `savedmodel_npz`): the weights in the JAX
    package's checkpoint container (`utils/checkpoint.save_checkpoint`),
    `model_weights.npz`, the keys and arrays JAX's `save_checkpoint` writes.
  - `onnx` raises a RuntimeError naming the absent `onnx` package, as JAX's
    guard does. `stablehlo`, `saved_model`, `tflite` and `pb` are written by
    the JAX package's XLA and TensorFlow toolchains and raise here.

`half=True` casts the float parameters to bf16 (the BN statistics stay f32)
and computes in bf16, with f32 outputs (JAX exporter.py:86-91). `fuse=True`
has nothing to fuse: RepConv blocks (`RepC3`) are not ported (ROADMAP A12g).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch
from torch import nn

from ..utils import LOGGER
from .predictor import resolve_device

# each task's outputs, in order (JAX exporter.py:102-105)
OUTPUTS = {"detect": ("boxes", "scores"),
           "segment": ("boxes", "scores", "coefs", "protos"),
           "classify": ("probs",)}
PROGRAM_FORMATS = ("pt2", "export", "bin", "serialized")
WEIGHT_FORMATS = ("npz", "weights", "savedmodel_npz")
JAX_TOOLCHAIN = {"stablehlo": "XLA", "saved_model": "TensorFlow",
                 "savedmodel": "TensorFlow", "tflite": "TensorFlow Lite",
                 "pb": "TensorFlow"}


class U8Program(nn.Module):
    """JAX's `infer_u8`: uint8 NHWC -> `model.eval_outputs` of the image /
    255 in `dtype`, as f32. `params` runs in place of the model's own
    weights (`DetectionModel.eval_outputs`)."""

    def __init__(self, model, dtype=torch.float32, params=None):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.params = params

    def forward(self, img_u8):
        outs = self.model.eval_outputs(img_u8.to(self.dtype) / 255.0,
                                       self.params)
        return tuple(o.float() for o in outs)


def bf16_copy(model):
    """A copy of `model` whose float32 parameters are bf16 (JAX casts the
    params tree; the BN running stats are buffers and stay f32)."""
    model = copy.deepcopy(model)
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


def sidecar_meta(model, imgsz, batch, shapes):
    """The deployment sidecar of JAX exporter.py:113-127: the artifact's
    fixed shapes, task, class names and the ordered output specs."""
    return {"imgsz": imgsz, "batch": batch, "nc": model.nc, "task": model.task,
            "names": {int(k): v for k, v in model.names.items()},
            "outputs": [{"name": n, "shape": list(s)}
                        for n, s in zip(OUTPUTS[model.task], shapes)]}


class Exporter:
    def __init__(self, args):
        self.args = args

    def __call__(self, model):
        """Write `model` (the port's DetectionModel, moved to the args'
        device) in the args' format under `project` (default runs/export);
        returns the artifact's path."""
        a = self.args
        fmt = (a.format or "pt2").lower()
        imgsz = a.imgsz if isinstance(a.imgsz, int) else 640
        batch = max(1, int(a.batch))
        half = bool(a.half)
        if fmt in JAX_TOOLCHAIN:
            raise NotImplementedError(
                f"format '{fmt}' is written by the JAX package's "
                f"{JAX_TOOLCHAIN[fmt]} toolchain (python -m dedark_yolo_tpu "
                f"export format={fmt}); the port's compiled artifact is "
                "format='pt2'")
        if fmt == "onnx":
            try:
                import onnx  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "ONNX export needs the 'onnx' package, which is not "
                    "installed; use format='pt2' (torch.export) or 'npz'") from e
            raise RuntimeError(
                "ONNX export has no translation of the port's enhance ops; "
                "use format='pt2' (torch.export) or 'npz'")
        if fmt not in PROGRAM_FORMATS + WEIGHT_FORMATS:
            raise ValueError(f"unsupported export format '{fmt}' (supported: "
                             "pt2, npz, onnx)")
        if a.fuse and any(s.name == "RepC3" for s in model.specs):
            raise NotImplementedError("RepConv fusion is not ported (A12g)")
        out_dir = Path(a.project or "runs/export")
        out_dir.mkdir(parents=True, exist_ok=True)
        device = resolve_device(a.device)
        model = model.to(device).eval()

        if fmt in WEIGHT_FORMATS:
            if half:
                raise NotImplementedError(
                    "half=True npz export: the JAX package writes bf16 "
                    "arrays, which numpy holds only through ml_dtypes")
            from ..utils.checkpoint import save_checkpoint
            from ..utils.weights import state_dict_to_jax
            v = state_dict_to_jax(model.state_dict(), model)
            path = save_checkpoint(out_dir / "model_weights.npz",
                                   params=v["params"],
                                   batch_stats=v["batch_stats"],
                                   model_yaml=model.yaml)
            LOGGER.info(f"exported weights to {path}")
            return str(path)

        program = U8Program(bf16_copy(model) if half else model,
                            torch.bfloat16 if half else torch.float32)
        example = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.uint8,
                              device=device)
        with torch.no_grad():
            ep = torch.export.export(program, (example,))
        ep.example_inputs = None     # else the archive keeps the zero batch
        path = out_dir / "model.pt2"
        torch.export.save(ep, path)
        shapes = [tuple(n.meta["val"].shape)
                  for n in ep.graph.output_node().args[0]]
        (out_dir / "model.pt2.json").write_text(
            json.dumps(sidecar_meta(model, imgsz, batch, shapes), indent=2))
        LOGGER.info(f"exported torch.export artifact to {path} "
                    f"({path.stat().st_size / 1e6:.1f} MB, + .json sidecar)")
        return str(path)
