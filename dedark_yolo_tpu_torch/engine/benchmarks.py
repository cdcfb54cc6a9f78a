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

`YOLO.benchmark(formats=...)` (JAX's `benchmark_formats`, every export
format) needs the exporter, which is not ported (ROADMAP A12).
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
    img = img_u8.to(dtype) / 255.0
    raw = (model(img) if params is None
           else torch.func.functional_call(model, params, (img,)))
    boxes, scores = model.decode(raw)
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

