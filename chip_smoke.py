#!/usr/bin/env python3
"""Smoke run of the torch port (dedark_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device. Phases,
each printed as one JSON line; any failure exits non-zero without the final
line:

  env      card name and power limit (nvidia-smi), torch/CUDA versions, TF32
  build    nvcc of every csrc/*.cu, one process per source, all at once
  kernel   every kernel against its plain PyTorch version on the card, at
           the main path's shapes and at odd ones, with CUDA-event timings
  predict  YOLO("yolov8l.yaml", nc=3) predict on 16-frame batches at
           imgsz 640, f32 then bf16, with the kernels' launch counts
  cpu      the same weights and first frame through predict(device="cpu")

then the card line, a {"kernels": [...]} line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The parity phases run with TF32 off for cuDNN and matmuls; the predict
phase times the default precision (TF32 on) and checks with it off.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 0
DARK_PARAM = 3.0            # exponent of the synthetic low-light frames
CONF = 0.05                 # predict conf for random weights (see phase 4)
BATCH, IMGSZ = 16, 640

# kernel phase: (batch, H, W); random priors at each, the defaults at the first
KERNEL_SHAPES = [(16, 640, 640), (3, 481, 643), (1, 64, 96)]
# |kernel - plain| <= ATOL + RTOL * |plain|, compared in the working dtype.
# f32: both compute in f32, but exp(g*log v) against pow, FMA contraction
# and another association of the contrast scale differ by a few ulps, which
# gamma (<= 3), the DeDark division (tx >= 0.2) and the sharpen's
# cancellation (s <= 5) amplify; the JAX package holds its own kernel to the
# chain at the same 1e-4 (tests/test_pallas_enhance.py). bf16: both round
# one f32 result to bf16 once, so they differ by at most one bf16 ulp.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2 ** -7)}
# cpu phase, GPU (TF32 off) vs CPU predict on one frame: equal counts and
# classes, boxes and scores within these. cuDNN's f32 convolutions sum in
# another order than the CPU's, and the 60-layer random-weight network (its
# BN set from the frames themselves) amplifies the differences; the CPU
# tests hold the port to JAX at 4e-4 px where both sum on the CPU.
BOX_TOL_PX, SCORE_TOL = 0.5, 2e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def enhance_inputs(b, h, w, dtype, default_priors, device):
    import numpy as np
    import torch
    rng = np.random.default_rng([SEED, b, h, w])
    img = rng.uniform(0.02, 0.98, (b, h, w, 3)).astype(np.float32)
    feats = rng.normal(0, 0.7, (b, 15)).astype(np.float32)
    if default_priors:
        A = np.full((b, 3), 0.8, np.float32)
        ica = np.full((b, h, w, 1), 0.5, np.float32)
    else:
        A = rng.uniform(0.6, 0.9, (b, 3)).astype(np.float32)
        ica = rng.uniform(0.2, 0.8, (b, h, w, 1)).astype(np.float32)
    t = [torch.from_numpy(x).to(device) for x in (img, feats, A, ica)]
    return t[0].to(dtype), t[1], t[2], t[3].to(dtype)


def enhance_bound(b, h, w, itemsize):
    """Least time for fused_enhance: bytes (img + IcA + features + A read
    once, out written once) over HBM rate vs flops over the f32 rate."""
    pix = b * h * w
    nbytes = pix * (3 + 1 + 3) * itemsize + b * (15 + 3) * 4
    # per pixel: separable 25-tap blur, 2 passes x 3 channels x 25 FMA = 300
    # flops; point chain ~46 (tx 2, per channel 8 incl. exp/log, lum 5,
    # contrast 7, scale 3 mults); sharpen 3 x 3 = 9
    flops = pix * (300 + 46 + 9)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build():
    from dedark_yolo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.load(name)
    emit({"phase": "build", "seconds": round(secs, 3),
          "built": sorted(logs),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "smem" in ln]
                    for k, v in logs.items()}})


def phase_kernel(torch):
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
    dev = torch.device("cuda")
    checks, worst = [], {}
    for i, (b, h, w) in enumerate(KERNEL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for default_priors in ((False, True) if i == 0 else (False,)):
                args = enhance_inputs(b, h, w, dtype, default_priors, dev)
                got = K.fused_enhance(*args)
                want = K.fused_enhance_reference(*args)
                torch.cuda.synchronize()
                g, r = got.float(), want.float()
                err = (g - r).abs()
                atol, rtol = TOL[str(dtype).split(".")[1]]
                ok = bool(torch.isfinite(g).all()) and \
                    bool((err <= atol + rtol * r.abs()).all())
                at = int(err.argmax())
                checks.append({"shape": [b, h, w], "dtype": str(dtype)[6:],
                               "default_priors": default_priors,
                               "max_abs_err": float(err.max()),
                               "plain_at_max_err": float(r.flatten()[at]),
                               "max_abs_plain": float(r.abs().max()),
                               "atol": atol, "rtol": rtol, "ok": ok})
                key = str(dtype)[6:]
                if i == 0:
                    worst[key] = max(worst.get(key, 0.0), float(err.max()))
    if not all(c["ok"] for c in checks):
        emit({"phase": "kernel", "checks": checks})
        raise AssertionError("fused_enhance disagrees with its plain version")
    timing = {}
    b, h, w = KERNEL_SHAPES[0]
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            args = enhance_inputs(b, h, w, dtype, True, dev)
            key = str(dtype)[6:]
            bound, by = enhance_bound(b, h, w, args[0].element_size())
            timing[key] = {
                "ms": time_ms(lambda: K.fused_enhance(*args)),
                "plain_ms": time_ms(lambda: K.fused_enhance_reference(*args)),
                "bound_ms": bound, "bound_by": by,
                "max_abs_err": worst[key]}
    emit({"phase": "kernel", "checks": checks, "timing": timing})
    return timing


def synthetic_frames(n):
    """Seeded low-light BGR 480x640 frames: 32-px blocks of random colour
    with noise, darkened as (u8/255)**DARK_PARAM and scaled back to u8."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (n, 15, 20, 3)).astype(np.float32) / 255
    img = np.kron(base, np.ones((1, 32, 32, 1), np.float32))
    img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    return list((img ** DARK_PARAM * 255).astype(np.uint8))


def calibrate_bn(torch, model, frames):
    """Set every BN's running stats to its input's statistics over the
    frames, in one pass, so a random-weight model keeps O(1) activations
    and spread-out scores instead of a constant output."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.nn.layers import BatchNorm

    def hook(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    dev = next(model.parameters()).device
    lb = np.stack([letterbox(f, IMGSZ)[0][..., ::-1] for f in frames])
    x = torch.from_numpy(np.ascontiguousarray(lb)).to(dev).float() / 255
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()


def step_breakdown(torch, yolo, frames):
    """CUDA-event medians of the parts of one predictor step on one batch
    (after the timed run, so outside its launch counts)."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.ops.nms import non_max_suppression
    p, a = yolo.predictor, yolo.predictor.args
    dtype = torch.bfloat16 if a.half else torch.float32
    u8 = np.stack([np.ascontiguousarray(letterbox(f, IMGSZ)[0][..., ::-1])
                   for f in frames])
    upload = lambda: torch.from_numpy(u8).to(p.device).to(dtype) / 255.0
    img = upload()
    with torch.inference_mode(), matmul_precision(a.matmul_precision):
        enhance = lambda: yolo.model.model[0](img)
        forward = lambda: yolo.model(img)
        raw = forward()
        decode = lambda: yolo.model.decode(raw)
        boxes, scores = decode()
        nms = lambda: non_max_suppression(
            boxes.float(), scores.float(), conf_thres=CONF, iou_thres=a.iou,
            max_det=a.max_det, max_nms=a.max_nms, multi_label=False)
        return {name: time_ms(fn, iters=5, warmup=1) for name, fn in
                (("upload", upload), ("layer0", enhance), ("forward", forward),
                 ("decode", decode), ("nms", nms))}


def phase_predict(torch, yolo, frames):
    from dedark_yolo_tpu_torch.ops import _build
    reps = 4                                   # 4 batches of 16 per dtype
    out = {}
    for half in (False, True):
        kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, half=half)
        yolo.predict(frames, **kw)             # warm-up batch
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = yolo.predict(frames * reps, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        counts = [len(r) for r in res]
        for r in res:
            d = r.boxes.data
            assert d.shape[1] == 6 and bool((d[:, 4] > CONF).all())
            assert bool(((d[:, 5] >= 0) & (d[:, 5] < 3)).all())
        if max(counts) == 0:
            raise AssertionError(f"no detections at conf={CONF} (half={half})")
        unused = [k for k, v in launches.items() if v == 0]
        if unused:
            raise AssertionError(f"kernels not launched by predict: {unused}")
        key = "bf16" if half else "f32"
        out[key] = {"images": len(res), "seconds": secs,
                    "images_per_s": len(res) / secs,
                    "stage_ms": dict(yolo.predictor.speed),
                    "launches": launches,
                    "dets_per_image": [min(counts), max(counts)],
                    "batch_breakdown_ms": step_breakdown(torch, yolo, frames)}
    emit({"phase": "predict", "model": "yolov8l.yaml", "nc": 3,
          "batch": BATCH, "imgsz": IMGSZ, "conf": CONF,
          "matmul_precision": "default", **out})
    return out


def phase_cpu(torch, yolo, frame):
    """GPU (TF32 off) vs CPU on the same weights and frame."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.data.augment import letterbox
    kw = dict(imgsz=IMGSZ, batch=1, conf=CONF, matmul_precision="float32")
    gpu = yolo.predict([frame], **kw)[0]
    cpu_model = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
    cpu_model.load_state_dict({k: v.cpu() for k, v in yolo.state_dict().items()})
    cpu = cpu_model.predict([frame], device="cpu", **kw)[0]
    lb = letterbox(frame, IMGSZ)[0][..., ::-1].copy()
    x = torch.from_numpy(lb[None]).float() / 255
    with torch.no_grad():
        from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
        with matmul_precision("float32"):
            bg, sg = yolo.model.decode(yolo.model(x.cuda()))
        bc, sc = cpu_model.model.decode(cpu_model.model(x))
        eg = yolo.model.model[0](x.cuda())
        ec = cpu_model.model.model[0](x)
    box_err = float((bg.cpu() - bc).abs().max())
    score_err = float((sg.cpu() - sc).abs().max())
    n = len(cpu)
    rec = {"phase": "cpu", "gpu_count": len(gpu), "cpu_count": n,
           "layer0_max_abs_err": float((eg.cpu() - ec).abs().max()),
           "decoded_box_max_abs_err_px": box_err,
           "decoded_score_max_abs_err": score_err,
           "box_tol_px": BOX_TOL_PX, "score_tol": SCORE_TOL}
    if n and len(gpu) == n:
        rec["det_box_max_abs_err_px"] = float(abs(
            gpu.boxes.xyxy - cpu.boxes.xyxy).max())
        rec["det_conf_max_abs_err"] = float(abs(
            gpu.boxes.conf - cpu.boxes.conf).max())
        rec["det_cls_equal"] = bool((gpu.boxes.cls == cpu.boxes.cls).all())
    emit(rec)
    if not (len(gpu) == n > 0 and box_err <= BOX_TOL_PX
            and score_err <= SCORE_TOL
            and rec["det_box_max_abs_err_px"] <= BOX_TOL_PX
            and rec["det_conf_max_abs_err"] <= SCORE_TOL
            and rec["det_cls_equal"]):
        raise AssertionError(f"GPU and CPU predict disagree: {rec}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "dedark_yolo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = phase_env(torch)
    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = phase_kernel(torch)

    from dedark_yolo_tpu_torch import YOLO
    frames = synthetic_frames(BATCH)
    yolo = YOLO("yolov8l.yaml", nc=3, seed=SEED)   # device None -> cuda
    calibrate_bn(torch, yolo.model, frames)
    pred = phase_predict(torch, yolo, frames)
    phase_cpu(torch, yolo, frames[0])

    print(smi)
    f32, bf16 = timing["float32"], timing["bfloat16"]
    emit({"kernels": [{
        "name": "fused_enhance", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/fused_enhance.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/enhance_kernel.py:218",
        "launches": pred["f32"]["launches"]["fused_enhance"]
        + pred["bf16"]["launches"]["fused_enhance"],
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None,
        "shape": [BATCH, IMGSZ, IMGSZ, 3], "dtype": "float32",
        "bf16": bf16}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
