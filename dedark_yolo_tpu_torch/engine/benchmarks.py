"""Precision x batch benchmark on the card (JAX engine/benchmarks.py:18-87).

For fp32 and bf16 and each batch size: seeded distinct uint8 input
batches on the device, the predictor's device work (u8 -> float, the
graph with layer 0's fused_enhance kernel, decode, the nms kernel at conf
0.25 and iou 0.45 as JAX fixes them), `warmup` calls, then `iters` calls
timed depth-2 (call i+1 is dispatched before call i's counts are read
back; every call's counts are read back). The bf16 row computes JAX's
function: every float parameter cast to bf16 (BN running stats stay f32)
and the image u8 / 255 in bf16, through `torch.func.functional_call` on
the casts, as the amp trainer runs its forward (the predictor's `half`
instead keeps f32 parameters). A row that raises becomes an "error" row,
as in JAX. With `data`, a last row holds `val`'s mAP50-95.

`benchmark_formats` (`YOLO.benchmark(formats=...)`, JAX
benchmarks.py:90-160) exports the model to each format and runs each
through AutoBackend: its size, images/s of `iters` forwards (each read
back), and with `data` val's mAP50-95. 'live' is the model itself; a
format whose toolchain is absent (the JAX package's tflite and
saved_model) gives an "error" row.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.nms import non_max_suppression
from ..utils import LOGGER
from .predictor import matmul_precision

NMS_CONF, NMS_IOU = 0.25, 0.45


def bf16_params(model):
    """Every float32 parameter of `model` cast to bf16 (JAX
    benchmarks.py:26-30 casts the params tree; the BN running stats are
    buffers and stay f32)."""
    return {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for n, p in model.named_parameters()}


@torch.inference_mode()
def bench_step(model, params, img_u8, dtype):
    """One benchmark call: (B, S, S, 3) uint8 on the device -> NMS (dets,
    counts), not waited for. params None runs the module's own weights;
    else the graph runs on `params` through functional_call."""
    boxes, scores = model.eval_outputs(img_u8.to(dtype) / 255.0, params)
    return non_max_suppression(boxes.float(), scores.float(),
                               conf_thres=NMS_CONF, iou_thres=NMS_IOU,
                               max_det=300, max_nms=2048, multi_label=False)


def benchmark(yolo, imgsz=640, data=None, batch_sizes=(1, 8, 32), warmup=2,
              iters=5, **kwargs):
    """Rows {"precision", "batch", "img_per_sec", "ms_per_img"} (or
    "error") for fp32 then bf16 at each batch size, on the facade's device
    (kwargs' `device` moves it first); with `data` a last row
    {"mAP50-95": ...} from `yolo.val(data=data, imgsz=imgsz, **kwargs)`."""
    if "device" in kwargs:
        yolo.to(kwargs["device"])
    model = yolo.model.to(yolo.device).eval()
    precision = kwargs.get("matmul_precision", "default")
    rows = []
    for half in (False, True):
        dtype = torch.bfloat16 if half else torch.float32
        name = "bf16" if half else "fp32"
        params = bf16_params(model) if half else None
        for bs in batch_sizes:
            # distinct input buffers, made on the device before the timing
            rng = np.random.default_rng(0)
            imgs = [torch.from_numpy(rng.integers(
                0, 255, (bs, imgsz, imgsz, 3), dtype=np.uint8)).to(yolo.device)
                for _ in range(min(iters, 4))]
            try:
                with matmul_precision(precision):
                    for i in range(warmup):
                        bench_step(model, params, imgs[i % len(imgs)],
                                   dtype)[1].cpu()
                    t0 = time.perf_counter()
                    pending = None
                    for i in range(iters):
                        out = bench_step(model, params, imgs[i % len(imgs)],
                                         dtype)
                        if pending is not None:
                            pending[1].cpu()
                        pending = out
                    pending[1].cpu()
                    dt = time.perf_counter() - t0
                ips = bs * iters / dt
                rows.append({"precision": name, "batch": bs,
                             "img_per_sec": round(ips, 2),
                             "ms_per_img": round(1000 / ips, 3)})
                LOGGER.info(f"bench {name} bs={bs}: {ips:.1f} img/s")
            except Exception as e:
                rows.append({"precision": name, "batch": bs,
                             "error": str(e)[:100]})
    if data is not None:
        metrics = yolo.val(data=data, imgsz=imgsz, **kwargs)
        rows.append({"mAP50-95": metrics.get("metrics/mAP50-95(B)")})
    return rows


def benchmark_formats(yolo, imgsz=640, data=None, batch=8, warmup=1, iters=3,
                      formats=("live", "pt2", "tflite", "saved_model"),
                      export_dir=None, **kwargs):
    """Rows {"format", "size_mb", "img_per_sec"} (+ "mAP50-95" with
    `data`), or {"format", "error"} where a format fails, one a format in
    order, on the facade's device (kwargs' `device` first). Each artifact
    is written under export_dir/<format> (default: a new temporary
    directory)."""
    import tempfile
    from pathlib import Path
    from .autobackend import AutoBackend
    from .model import YOLO

    if yolo._backend_spec:
        raise ValueError(
            "benchmark(formats=True) needs a live model (yaml/npz spec) to "
            "export from; this YOLO wraps an already-exported artifact")
    if "device" in kwargs:
        yolo.to(kwargs["device"])
    device = str(yolo.device)
    export_dir = Path(export_dir or tempfile.mkdtemp(prefix="dedark_bench_"))
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)
            for _ in range(min(iters, 4))]
    precision = kwargs.get("matmul_precision", "default")
    rows = []
    for fmt in formats:
        try:
            path = size_mb = None
            if fmt == "live":
                backend = AutoBackend(yolo, device=device)
            else:
                path = yolo.export(format=fmt, imgsz=imgsz, batch=batch,
                                   device=device,
                                   project=str(export_dir / fmt))
                p = Path(path)
                size = (sum(f.stat().st_size for f in p.rglob("*")
                            if f.is_file()) if p.is_dir()
                        else p.stat().st_size)
                size_mb = round(size / 1e6, 2)
                backend = AutoBackend(path, device=device)
            with matmul_precision(precision):
                for i in range(warmup):
                    backend(imgs[i % len(imgs)])[0].cpu()
                t0 = time.perf_counter()
                for i in range(iters):
                    backend(imgs[i % len(imgs)])[0].cpu()
                dt = time.perf_counter() - t0
            ips = batch * iters / dt
            row = {"format": fmt, "size_mb": size_mb,
                   "img_per_sec": round(ips, 2)}
            if data is not None:
                m = yolo if fmt == "live" else YOLO(path, device=device)
                metrics = m.val(data=data, imgsz=imgsz, batch=batch,
                                **{"device": device, **kwargs})
                row["mAP50-95"] = metrics.get("metrics/mAP50-95(B)")
            rows.append(row)
            LOGGER.info(f"benchmark_formats {fmt}: {row}")
        except Exception as e:
            rows.append({"format": fmt, "error": str(e)[:120]})
            LOGGER.warning(f"benchmark_formats {fmt} failed: {e}")
    return rows
