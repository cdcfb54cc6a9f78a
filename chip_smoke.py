#!/usr/bin/env python3
"""Smoke run of the torch port (dedark_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device. Phases,
each printed as one JSON line; any failure exits non-zero without the final
line:

  env      card name and power limit (nvidia-smi), torch/CUDA versions, TF32
  build    nvcc of every csrc/*.cu, one process per source, all at once
  kernel   every kernel (fused_enhance, usm, int8_conv) against its plain
           PyTorch version on the card, at its main path's shapes and at
           odd ones, with CUDA-event timings, each beside nvidia-smi's SM
           clock, power draw and power limit
  predict  YOLO("yolov8l.yaml", nc=3) predict on 16-frame batches at
           imgsz 640: f32 and bf16 (contrast_mode 'channel', the
           fused_enhance kernel), then f32 with contrast_mode 'reference'
           (point filters, then the usm kernel), each run's launch counts
           checked against its path
  cpu      the same weights and first frame through predict(device="cpu"),
           and layer 0 in 'reference' mode on the card against the CPU
  probe    tools.int8_probe at its default shape (24 layers, b32, 80x80,
           C=Co=256): bf16 cuDNN chain vs the int8_conv kernel's chain

then the card line, a {"kernels": [...]} line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The parity phases run with TF32 off for cuDNN and matmuls; the predict
phase times the default precision (TF32 on) and checks with it off.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
INT8_OP_PER_S = 1979e12     # H100 SXM int8 tensor cores, dense
SEED = 0
DARK_PARAM = 3.0            # exponent of the synthetic low-light frames
CONF = 0.05                 # predict conf for random weights (see phase 4)
BATCH, IMGSZ = 16, 640

# kernel phase: (batch, H, W); random priors at each, the defaults at the
# first; then the edge cases of the blur stage's plan: ragged strips and
# segments, two strips by two segments, the smallest side, W and H below a
# strip and a segment
KERNEL_SHAPES = [(16, 640, 640), (3, 481, 643), (1, 64, 96), (1, 13, 13),
                 (2, 37, 45)]
# usm: the reference-mode predict shape, a ragged one, the smallest side
USM_SHAPES = [(16, 640, 640), (3, 481, 643), (1, 13, 13)]
# int8_conv: (B, H, W, C, Co) unpadded; the probe's layer first, then the
# JAX package's test shapes (M and Co tails, odd H and W), then shapes whose
# K block is 32 (C = 32 and 96; the others take 128 or 64) with Co tails
INT8_SHAPES = [(32, 80, 80, 256, 256), (2, 8, 10, 128, 128),
               (1, 4, 6, 64, 512), (1, 10, 12, 64, 128), (1, 9, 11, 64, 128),
               (1, 7, 13, 32, 40), (2, 9, 21, 96, 136)]
INT8_OUT_SCALE = 0.05
# The enhance kernels take their seeded inputs from, and are held to their
# plain versions under the TOL of, dedark_yolo_tpu_torch/tools/enhance_ab.py
# (f32 1e-4 + 1e-4*|plain|, bf16 one ulp).
#
# cpu phase, GPU (TF32 off) vs CPU predict on one frame: equal counts and
# classes, boxes and scores within these. cuDNN's f32 convolutions sum in
# another order than the CPU's, and the 60-layer random-weight network (its
# BN set from the frames themselves) amplifies the differences; the CPU
# tests hold the port to JAX at 4e-4 px where both sum on the CPU.
BOX_TOL_PX, SCORE_TOL = 0.5, 2e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, ops, op_rate):
    """(least ms, what bounds it): bytes over HBM rate vs ops over op_rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def enhance_bound(b, h, w, itemsize):
    """Least time for fused_enhance: bytes (img + IcA + features + A read
    once, out written once) over HBM rate vs flops over the f32 rate."""
    pix = b * h * w
    nbytes = pix * (3 + 1 + 3) * itemsize + b * (15 + 3) * 4
    # per pixel: separable 25-tap blur, 2 passes x 3 channels x 25 FMA = 300
    # flops; point chain ~46 (tx 2, per channel 8 incl. exp/log, lum 5,
    # contrast 7, scale 3 mults); sharpen 3 x 3 = 9
    return bound(nbytes, pix * (300 + 46 + 9), F32_FLOP_PER_S)


def usm_bound(b, h, w, itemsize):
    """usm: y read once, out written once, the strengths; per value 2 x 25
    FMA of the separable blur and 3 flops of the sharpen."""
    vals = b * h * w * 3
    return bound(2 * vals * itemsize + b * 4, vals * 103, F32_FLOP_PER_S)


def int8_bound(B, H, W, C, Co):
    """int8_conv: 2*M*N*K ops against the padded input, weights, scales and
    output moved once."""
    nbytes = B * (H + 2) * (W + 2) * C + 9 * C * Co + 4 * Co + B * H * W * Co
    return bound(nbytes, 2 * B * H * W * Co * 9 * C, INT8_OP_PER_S)


def phase_env(torch):
    from dedark_yolo_tpu_torch.tools._ab import nvidia_smi
    smi = nvidia_smi()
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
    ptxas = {k: _build.ptxas_lines(v) for k, v in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3),
          "built": sorted(logs), "ptxas": ptxas})
    return ptxas


def plan_record(K, b, h, w, lib):
    """The blur stage's plan at (b, h, w), its shared memory held to the
    library's own `enhance_smem_bytes` (ops/enhance_kernel.py mirrors
    csrc/usm_tile.cuh)."""
    p = K.enhance_plan(b, h, w)
    return {"seg_rows": p["seg_rows"], "grid": list(p["grid"]),
            "smem_bytes": p["smem_bytes"],
            "smem_matches_library": p["smem_bytes"] == lib.enhance_smem_bytes()}


def phase_kernel(torch, ptxas=None):
    """fused_enhance against its plain version at every KERNEL_SHAPES case;
    timed at the first through the wrapper (`ms`) and, beside it, with the
    (B, 16) parameter vector made by torch ops first (`ms_host_params`): the
    cost of the form before the kernel regressed the parameters itself."""
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
    from dedark_yolo_tpu_torch.tools._ab import (CLOCKS_QUERY, nvidia_smi,
                                                 time_ms)
    from dedark_yolo_tpu_torch.tools.enhance_ab import compare, enhance_inputs
    dev = torch.device("cuda")
    lib = _build.load(K.NAME)
    checks, worst = [], {}
    for i, (b, h, w) in enumerate(KERNEL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for default_priors in ((False, True) if i == 0 else (False,)):
                args = enhance_inputs(b, h, w, dtype, default_priors, dev)
                got = K.fused_enhance(*args)
                want = K.fused_enhance_reference(*args)
                torch.cuda.synchronize()
                rec = compare(got, want, dtype)
                rec.update(plan_record(K, b, h, w, lib))
                rec["ok"] = rec["ok"] and rec["smem_matches_library"]
                checks.append({"shape": [b, h, w], "dtype": str(dtype)[6:],
                               "default_priors": default_priors, **rec})
                key = str(dtype)[6:]
                if i == 0:
                    worst[key] = max(worst.get(key, 0.0), rec["max_abs_err"])
    if not all(c["ok"] for c in checks):
        emit({"phase": "kernel", "kernel": "fused_enhance", "checks": checks})
        raise AssertionError("fused_enhance disagrees with its plain version")
    timing = {}
    b, h, w = KERNEL_SHAPES[0]
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            args = enhance_inputs(b, h, w, dtype, True, dev)
            key = str(dtype)[6:]
            ms_bound, by = enhance_bound(b, h, w, args[0].element_size())
            timing[key] = {
                "ms": time_ms(lambda: K.fused_enhance(*args)),
                "ms_host_params": time_ms(lambda: (
                    K.param_vec(args[1], args[2]), K.fused_enhance(*args))),
                "nvidia_smi": nvidia_smi(CLOCKS_QUERY),
                "plain_ms": time_ms(lambda: K.fused_enhance_reference(*args)),
                "bound_ms": ms_bound, "bound_by": by,
                "max_abs_err": worst[key]}
    emit({"phase": "kernel", "kernel": "fused_enhance", "checks": checks,
          "timing": timing, "ptxas": (ptxas or {}).get(K.NAME, [])})
    return timing


def phase_kernel_usm(torch, ptxas=None):
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
    from dedark_yolo_tpu_torch.tools._ab import (CLOCKS_QUERY, nvidia_smi,
                                                 time_ms)
    from dedark_yolo_tpu_torch.tools.enhance_ab import compare, usm_inputs
    dev = torch.device("cuda")
    lib = _build.load(K.USM_NAME)
    checks, timing = [], {}
    for i, (b, h, w) in enumerate(USM_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            args = usm_inputs(b, h, w, dtype, dev)
            got, want = K.usm(*args), K.usm_reference(*args)
            torch.cuda.synchronize()
            rec = compare(got, want, dtype)
            rec.update(plan_record(K, b, h, w, lib))
            rec["ok"] = rec["ok"] and rec["smem_matches_library"]
            checks.append({"shape": [b, h, w], "dtype": str(dtype)[6:], **rec})
            if i == 0:
                ms_bound, by = usm_bound(b, h, w, args[0].element_size())
                with torch.no_grad():
                    timing[str(dtype)[6:]] = {
                        "ms": time_ms(lambda: K.usm(*args)),
                        "nvidia_smi": nvidia_smi(CLOCKS_QUERY),
                        "plain_ms": time_ms(lambda: K.usm_reference(*args)),
                        "bound_ms": ms_bound, "bound_by": by,
                        "max_abs_err": rec["max_abs_err"]}
    emit({"phase": "kernel", "kernel": "usm", "checks": checks,
          "timing": timing, "ptxas": (ptxas or {}).get(K.USM_NAME, [])})
    if not all(c["ok"] for c in checks):
        raise AssertionError("usm disagrees with its plain version")
    return timing


def int8_inputs(shape, device, inputs):
    """The int8 phase's inputs at (B, H, W, C, Co): the probe's seeded draw
    ('random'), the same with each channel's scale times its own factor in
    [0.5, 2) ('channel_scales'), all 127 ('saturate'), or the draw with the
    scales a view 4 bytes off a 16-byte boundary ('scale_view')."""
    import torch
    from dedark_yolo_tpu_torch.tools.int8_probe import layer_inputs
    B, H, W, C, Co = shape
    if inputs == "saturate":
        return (torch.full((B, H + 2, W + 2, C), 127, dtype=torch.int8,
                           device=device),
                torch.full((3, 3, C, Co), 127, dtype=torch.int8,
                           device=device),
                torch.ones(Co, device=device))
    x, w, scale = layer_inputs(*shape, device, SEED,
                               channel_scales=inputs == "channel_scales")
    if inputs == "scale_view":
        scale = torch.cat([scale[:1], scale])[1:]
    return x, w, scale


def phase_kernel_int8(torch, ptxas=None):
    """act=None must be bit-exact; silu may differ by one int8 step on under
    1% of outputs (the JAX package's bar, tests/test_int8_conv.py:71-73).
    The timing record carries the plan, TOP/s, the share of the int8 peak
    and the build's ptxas lines for the kernel. Each case also holds the
    plan's shared memory (ops/int8_conv.py mirrors the .cu's layout) to the
    library's own int8_conv_smem_bytes."""
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import int8_conv as I
    from dedark_yolo_tpu_torch.tools._ab import (CLOCKS_QUERY, nvidia_smi,
                                                 time_ms)
    dev = torch.device("cuda")
    lib_smem = _build.load(I.NAME).int8_conv_smem_bytes
    checks = []
    # (shape, act, inputs, see int8_inputs): every shape on the probe's
    # draw; every other shape (K blocks 128, 64 and 32, Co tails) with
    # per-channel scales; saturation; a misaligned scale view
    cases = [(s, act, "random") for s in INT8_SHAPES for act in (None, "silu")]
    cases += [(s, act, "channel_scales") for s in INT8_SHAPES[1:]
              for act in (None, "silu")]
    cases += [((1, 4, 4, 128, 128), None, "saturate"),
              ((2, 8, 10, 128, 128), None, "scale_view")]
    for shape, act, inputs in cases:
        args = int8_inputs(shape, dev, inputs)
        kw = {"out_scale": INT8_OUT_SCALE, "act": act} if act else {}
        got = I.conv3x3_s1_w8a8(*args, **kw)
        want = I.conv3x3_s1_w8a8_reference(*args, **kw)
        torch.cuda.synchronize()
        d = (got.int() - want.int()).abs()
        p = I.kernel_plan(*shape)
        rec = {"shape": list(shape), "act": act, "inputs": inputs,
               "bk": p["bk"], "bn": p["bn"], "tile": [p["th"], p["tw"]],
               "stages": p["stages"], "smem_bytes": p["smem_bytes"],
               "smem_matches_library":
                   p["smem_bytes"] == lib_smem(p["bk"], p["stages"]),
               "max_step": int(d.max()),
               "frac_differ": float((d > 0).float().mean()),
               "out_min": int(got.min()), "out_max": int(got.max())}
        rec["ok"] = (rec["max_step"] == 0 if act is None else
                     rec["max_step"] <= 1 and rec["frac_differ"] < 0.01)
        if inputs == "saturate":
            rec["ok"] = rec["ok"] and rec["out_max"] == 127
        rec["ok"] = rec["ok"] and rec["smem_matches_library"]
        checks.append(rec)
    B, H, W, C, Co = INT8_SHAPES[0]
    x, w, scale = int8_inputs(INT8_SHAPES[0], dev, "random")
    kw = {"out_scale": INT8_OUT_SCALE, "act": "silu"}
    ms_bound, by = int8_bound(B, H, W, C, Co)
    timing = {"ms": time_ms(lambda: I.conv3x3_s1_w8a8(x, w, scale, **kw)),
              "nvidia_smi": nvidia_smi(CLOCKS_QUERY),
              "plain_ms": time_ms(
                  lambda: I.conv3x3_s1_w8a8_reference(x, w, scale, **kw),
                  iters=3, warmup=1),
              "bound_ms": ms_bound, "bound_by": by, "act": "silu",
              "max_abs_err": max(c["max_step"] for c in checks
                                 if c["shape"] == [B, H, W, C, Co])}
    ops = 2 * B * H * W * Co * 9 * C
    plan = I.kernel_plan(B, H, W, C, Co)
    timing.update({"tops": ops / timing["ms"] / 1e9,
                   "peak_pct": 100 * ops / (timing["ms"] / 1e3) / INT8_OP_PER_S,
                   "plan": {k: plan[k] for k in ("bk", "stages",
                                                 "smem_bytes")},
                   "ptxas": (ptxas or {}).get(I.NAME, [])})
    timing.update(int_mm_yardstick(torch, I, x, w, scale))
    emit({"phase": "kernel", "kernel": "int8_conv", "checks": checks,
          "timing": timing})
    if not all(c["ok"] for c in checks):
        raise AssertionError("int8_conv disagrees with its plain version")
    if not timing["library_matches_kernel"]:
        raise AssertionError("torch._int_mm yardstick disagrees with int8_conv")
    return timing


def int_mm_yardstick(torch, I, x, w, scale):
    """library_ms: torch._int_mm on the unfolded input (M, 9C) x (9C, Co),
    the int32 product alone; the port never calls it. Its requantised result
    is held to the kernel's act=None output."""
    from dedark_yolo_tpu_torch.tools._ab import time_ms
    if not hasattr(torch, "_int_mm"):
        return {"library_ms": None, "library": "torch._int_mm is missing",
                "library_matches_kernel": True}
    B, Hp, Wp, C = x.shape
    H, W, Co = Hp - 2, Wp - 2, w.shape[3]
    cols = torch.cat([x[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(B * H * W, 9 * C)
    wt = w.permute(3, 0, 1, 2).reshape(Co, 9 * C).contiguous()
    acc = torch._int_mm(cols, wt.t())
    q = torch.round(acc.float() * scale).clamp(-128, 127).to(torch.int8)
    same = bool((q.reshape(B, H, W, Co) == I.conv3x3_s1_w8a8(x, w, scale)).all())
    return {"library_ms": time_ms(lambda: torch._int_mm(cols, wt.t())),
            "library": "torch._int_mm(unfolded x, w) -> int32, no requant",
            "library_matches_kernel": same}


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


def layer0_parts(torch, m, x):
    """The calls of `LowlightRecovery.forward` (m) on the batch x, one by
    one, each on the outputs of the one before: the default priors, the
    256x256 resize, the parameter CNN, then the fused_enhance kernel
    ('channel'), or the plain parameter regression, the point filters and
    the usm kernel ('reference')."""
    from dedark_yolo_tpu_torch.nn import enhance as E
    from dedark_yolo_tpu_torch.ops.enhance_kernel import FusedEnhance, Usm
    b, h, w, _ = x.shape
    priors = lambda: (
        torch.full((b, 3), E.DEFAULT_A, dtype=x.dtype, device=x.device),
        torch.full((b, h, w, 1), E.DEFAULT_ICA, dtype=x.dtype,
                   device=x.device))
    A, ica = priors()
    resize = lambda: E.torch_bilinear_resize(x, 256, 256).permute(0, 3, 1, 2)
    small = resize()
    cnn = lambda: m.extractor(small.to(m.extractor.fc1.weight.dtype))
    feats = cnn()
    parts = {"priors": priors, "resize": resize, "params_cnn": cnn}
    if m.contrast_mode == "channel":
        parts["kernel"] = lambda: FusedEnhance.apply(x, feats, A, ica)
        return parts
    params = E.regress_filter_params(feats)
    point = lambda: E.apply_point_filters(x, params, A, ica, m.contrast_mode)
    y = point()
    parts.update(regress=lambda: E.regress_filter_params(feats),
                 point_filters=point,
                 kernel=lambda: Usm.apply(y, params["usm"]))
    return parts


def step_breakdown(torch, yolo, frames):
    """CUDA-event medians of the parts of one predictor step on one batch
    (after the timed run, so outside its launch counts), and of layer 0's
    own parts (`layer0_parts`)."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.ops.nms import non_max_suppression
    from dedark_yolo_tpu_torch.tools._ab import time_ms
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
        parts = layer0_parts(torch, yolo.model.model[0], img)
        out = {name: time_ms(fn, iters=5, warmup=1) for name, fn in
               (("upload", upload), ("layer0", enhance), ("forward", forward),
                ("decode", decode), ("nms", nms))}
        out["layer0_parts"] = {name: time_ms(fn, iters=5, warmup=1)
                               for name, fn in parts.items()}
        return out


def zero_launches():
    from dedark_yolo_tpu_torch.ops import _build
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def check_launches(path, launches, expected):
    """Each kernel launched exactly as often as `path` must launch it (0 for
    kernels not in `expected`)."""
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches}, "
                             f"expected {want}")


# predict runs: (key, predict options, kernel the path launches per batch)
PREDICT_RUNS = [("f32", {"half": False}, "fused_enhance"),
                ("bf16", {"half": True}, "fused_enhance"),
                ("reference_f32", {"half": False,
                                   "contrast_mode": "reference"}, "usm")]


def phase_predict(torch, yolo, frames):
    from dedark_yolo_tpu_torch.ops import _build
    reps = 4                                   # 4 batches of 16 per run
    out = {}
    for key, opts, kernel in PREDICT_RUNS:
        kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, **opts)
        yolo.predict(frames, **kw)             # warm-up batch
        zero_launches()
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
            raise AssertionError(f"no detections at conf={CONF} ({key})")
        check_launches(f"predict {key}", launches, {kernel: reps})
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
    from dedark_yolo_tpu_torch.tools.enhance_ab import compare
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
        # layer 0 in 'reference' mode: point filters, then the usm kernel
        layer0s = (yolo.model.model[0], cpu_model.model.model[0])
        for m in layer0s:
            m.contrast_mode = "reference"
        ref_rec = compare(layer0s[0](x.cuda()).cpu(), layer0s[1](x),
                          torch.float32)
        for m in layer0s:
            m.contrast_mode = "channel"
    box_err = float((bg.cpu() - bc).abs().max())
    score_err = float((sg.cpu() - sc).abs().max())
    n = len(cpu)
    rec = {"phase": "cpu", "gpu_count": len(gpu), "cpu_count": n,
           "layer0_max_abs_err": float((eg.cpu() - ec).abs().max()),
           "layer0_reference_mode": ref_rec,
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
            and rec["det_cls_equal"] and ref_rec["ok"]):
        raise AssertionError(f"GPU and CPU predict disagree: {rec}")


def phase_probe(torch):
    """The int8 probe's chains at their default shape, few iterations."""
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools import int8_probe
    zero_launches()
    res = int8_probe.run(iters=2)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    emit({"phase": "probe", **res, "launches": launches})
    check_launches("int8 probe", launches, {"int8_conv": res["int8_calls"]})
    return launches


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
    ptxas = phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = phase_kernel(torch, ptxas)
    usm_timing = phase_kernel_usm(torch, ptxas)
    int8_timing = phase_kernel_int8(torch, ptxas)

    from dedark_yolo_tpu_torch import YOLO
    frames = synthetic_frames(BATCH)
    yolo = YOLO("yolov8l.yaml", nc=3, seed=SEED)   # device None -> cuda
    calibrate_bn(torch, yolo.model, frames)
    pred = phase_predict(torch, yolo, frames)
    phase_cpu(torch, yolo, frames[0])
    probe_launches = phase_probe(torch)

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
        "bf16": bf16}, {
        "name": "usm", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/usm.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/enhance_kernel.py:277",
        "launches": pred["reference_f32"]["launches"]["usm"],
        **{k: usm_timing["float32"][k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": [BATCH, IMGSZ, IMGSZ, 3], "dtype": "float32",
        "bf16": usm_timing["bfloat16"]}, {
        "name": "int8_conv", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/int8_conv.py:133",
        "launches": probe_launches["int8_conv"],
        **{k: int8_timing[k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": list(INT8_SHAPES[0]), "dtype": "int8",
        **{k: int8_timing[k] for k in ("act", "tops", "peak_pct")}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
