#!/usr/bin/env python3
"""Smoke run of the torch port (dedark_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device. Phases,
each printed as one JSON line; any failure exits non-zero without the final
line:

  env      card name and power limit (nvidia-smi), torch/CUDA versions, TF32
  build    nvcc of every csrc/*.cu, one process per source, all at once
  kernel   every kernel (fused_enhance, usm, int8_conv, nms) against its
           plain PyTorch version on the card, at its main path's shapes and
           at odd ones, with CUDA-event timings, each beside nvidia-smi's SM
           clock, power draw and power limit; nms must equal `_greedy` bit
           for bit, its mask and scan passes also timed apart
  predict  YOLO("yolov8l.yaml", nc=3) predict on 16-frame batches at
           imgsz 640: f32 and bf16 (contrast_mode 'channel', the
           fused_enhance kernel), then f32 with contrast_mode 'reference'
           (point filters, then the usm kernel), each run's launch counts
           checked against its path (nms once a batch in each), no plain
           version reached with a CUDA tensor; then the host ms inside the
           predictor's step against the batch's device ms, the step called
           behind 100 ms of queued device work (it must return before that
           work ends), any synchronising call inside it an error
  cpu      the same weights and first frame through predict(device="cpu"),
           and layer 0 in 'reference' mode on the card against the CPU
  probe    tools.int8_probe at its default shape (24 layers, b32, 80x80,
           C=Co=256): bf16 cuDNN chain vs the int8_conv kernel's chain
  train    DetectionTrainer: at imgsz 128, b2, one micro-step on the card
           against the CPU (loss items, gradients, updated parameters, BN
           stats, EMA; TF32 off); then yolov8l at b16, imgsz 640, f32,
           default precision: a warm-up window and two timed accumulation
           windows (8 micro-steps, 2 applied updates), fused_enhance
           launched once per micro-step and nms never
  val      YOLO(...).val on seeded synthetic datasets written as .npy
           sidecars (cache='disk', data as a dict), BN calibrated on each
           set's own images: 8 images of 3 shapes at imgsz 128 on the card
           against the CPU image by image (counts, classes, TP matrices,
           boxes, scores) and by metrics (plain, save_hybrid, with_loss;
           TF32 off; fused_enhance and nms once a batch), then
           contrast_mode 'reference' (usm and nms once a batch); then 64
           images of 4 shapes, longest side 640, at the val defaults (b16,
           conf 0.001): a warm-up call and a timed one, fused_enhance and
           nms once a batch, no plain version reached with a CUDA tensor

then the card line, a {"kernels": [...]} line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The parity phases run with TF32 off for cuDNN and matmuls; the predict
phase and the full-size train run time the default precision (TF32 on).

One phase alone, after the build (TF32 off first, as `main` does):

    python3 -c "import chip_smoke as c, torch; p = c.phase_build(); \
        c.phase_kernel_nms(torch, p)"      # or c.phase_train(torch)
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


# per candidate and greedy step: the argmax compare, the IoU (2 min, 2 max,
# 2 subtractions and 2 clamps for the sides, a product, 2 additions, a
# subtraction and a division) and the threshold test
NMS_FLOPS = 16


def nms_bound(b, k, max_det, keep_idx):
    """nms: boxes and scores read once, keep_idx (int64) and keep_scores
    written once; the operations of the steps this run's data needed (an
    image stops one step after its last kept box, or at max_det)."""
    kept = (keep_idx >= 0).sum(1)
    steps = int((kept + (kept < max_det)).sum())
    return bound(b * k * 20 + b * max_det * 12, steps * k * NMS_FLOPS,
                 F32_FLOP_PER_S)


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


def phase_kernel_nms(torch, ptxas=None):
    """nms against `_greedy` on every scene of tools/nms_scenes.py, equal
    bit for bit in keep_idx and keep_scores; the wrapper refuses a K above
    MAX_K; the wrapper's CHUNK, MAX_K and mask size held to the library's.
    Every scene is timed (the kernel through the wrapper, a call alone and
    among calls back to back, its mask and scan passes apart as raw
    launches, and `_greedy`, beside the bound of its own data and the walk's
    depth); the predict scene gives the kernel's entry in the kernels
    line."""
    import ctypes
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import nms as N
    from dedark_yolo_tpu_torch.tools._ab import (CLOCKS_QUERY, nvidia_smi,
                                                 queued_ms, time_ms)
    from dedark_yolo_tpu_torch.tools.nms_ab import pass_ms
    from dedark_yolo_tpu_torch.tools.nms_scenes import (SCENES, scene,
                                                        walk_depth)
    dev = torch.device("cuda")
    lib = _build.load(N.NAME)
    lib.nms_mask_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nms_mask_bytes.restype = ctypes.c_longlong
    sizes = [(16, 2048), (3, 1998), (1, 1), (2, 65)]
    plan = {"chunk": N.CHUNK, "max_k": N.MAX_K,
            "mask_bytes": N.mask_bytes(16, 2048),
            "chunk_matches_library": N.CHUNK == lib.nms_chunk(),
            "max_k_matches_library": N.MAX_K == lib.nms_max_k(),
            "mask_bytes_match_library": all(
                N.mask_bytes(b, k) == lib.nms_mask_bytes(b, k)
                for b, k in sizes)}
    checks, timing = [], {}
    for name in SCENES:
        boxes, scores, kw = scene(name, dev)
        got_i, got_s = N.greedy_nms(boxes, scores, **kw)
        want_i, want_s = N._greedy(boxes, scores, **kw)
        torch.cuda.synchronize()
        b, k = boxes.shape[:2]
        kept = (want_i >= 0).sum(1)
        depth = walk_depth(want_i, scores, kw["max_det"])
        ms_bound, by = nms_bound(b, k, kw["max_det"], want_i)
        rec = {"scene": name, "b": b, "k": k, **kw,
               "kept": [int(kept.min()), int(kept.max())],
               "walk_depth": [int(depth.min()), int(depth.max())],
               "idx_equal": bool(torch.equal(got_i, want_i)),
               "scores_equal": bool(torch.equal(got_s, want_s)),
               "dtypes": [str(got_i.dtype)[6:], str(got_s.dtype)[6:]],
               "ms": time_ms(lambda: N.greedy_nms(boxes, scores, **kw)),
               "queued_ms": queued_ms(
                   lambda: N.greedy_nms(boxes, scores, **kw)),
               **pass_ms(lib, boxes, scores, kw),
               "nvidia_smi": nvidia_smi(CLOCKS_QUERY),
               "plain_ms": time_ms(lambda: N._greedy(boxes, scores, **kw),
                                   iters=3, warmup=1),
               "bound_ms": ms_bound, "bound_by": by}
        rec["ok"] = rec["idx_equal"] and rec["scores_equal"]
        checks.append(rec)
        if name == "predict":
            timing = {key: rec[key] for key in
                      ("ms", "queued_ms", "mask_ms", "scan_ms", "walk_depth",
                       "nvidia_smi",
                       "plain_ms", "bound_ms", "bound_by")}
            timing.update(max_abs_err=float((got_s - want_s).abs().max()),
                          idx_mismatches=int((got_i != want_i).sum()),
                          shape=[b, k], max_det=kw["max_det"])
    too_many = torch.zeros((1, N.MAX_K + 1, 4), device=dev)
    try:
        N.greedy_nms(too_many, too_many[..., 0], 0.5, 10)
        refuses = False
    except ValueError:
        refuses = True
    emit({"phase": "kernel", "kernel": "nms", "plan": plan, "checks": checks,
          "refuses_k_above_max": refuses, "timing": timing,
          "ptxas": (ptxas or {}).get(N.NAME, [])})
    if not (all(c["ok"] for c in checks) and refuses
            and all(v for key, v in plan.items() if key.endswith("library"))):
        raise AssertionError("nms disagrees with _greedy or its plan")
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


def calibrate_bn(torch, model, frames, imgsz=IMGSZ):
    """Set every BN's running stats to its input's statistics over the
    frames, letterboxed to imgsz, in one pass, so a random-weight model
    keeps O(1) activations and spread-out scores instead of a constant
    output."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.nn.layers import BatchNorm

    def hook(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    dev = next(model.parameters()).device
    lb = np.stack([letterbox(f, imgsz)[0][..., ::-1] for f in frames])
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


# predict runs: (key, predict options, layer 0's kernel; nms runs in each)
PREDICT_RUNS = [("f32", {"half": False}, "fused_enhance"),
                ("bf16", {"half": True}, "fused_enhance"),
                ("reference_f32", {"half": False,
                                   "contrast_mode": "reference"}, "usm")]


class no_plain_on_cuda:
    """Within the block, the plain versions of the kernels that predict
    runs (`_greedy`, the enhance chain, the blur) raise when a CUDA tensor
    reaches them: on the card the forward goes through the kernels."""

    def __enter__(self):
        import torch
        from dedark_yolo_tpu_torch.nn import enhance as E
        from dedark_yolo_tpu_torch.ops import nms as N

        def guard(mod, name):
            fn = getattr(mod, name)

            def checked(*args, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"{name} reached with a CUDA tensor")
                return fn(*args, **kwargs)
            setattr(mod, name, checked)
            return mod, name, fn

        self.saved = [guard(N, "_greedy"), guard(E, "apply_filter_chain"),
                      guard(E, "usm_filter")]
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def step_wait(torch, predictor, frames, n=4, ahead_ms=100.0):
    """Per batch: host ms inside the predictor's step (letterboxed u8 batch
    in, device tensors out) and the batch's device ms (CUDA events around
    the step's work). Each step is called with `ahead_ms` of other work
    (torch.cuda._sleep) queued on the device before it: a step that waited
    on the device would take longer than that; one that does not takes its
    own dispatch time. Any synchronising call inside the step raises
    (torch.cuda.set_sync_debug_mode)."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.tools._ab import nvidia_smi
    u8 = np.stack([np.ascontiguousarray(letterbox(f, IMGSZ)[0][..., ::-1])
                   for f in frames])
    predictor.step(u8)                       # buffers and caches warm
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    host, device, ahead = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(ahead_ms * 1e3 * clock_mhz))
        ev[1].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            predictor.step(u8)
            host.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ev[2].record()
        torch.cuda.synchronize()
        ahead.append(ev[0].elapsed_time(ev[1]))
        device.append(ev[1].elapsed_time(ev[2]))
    return {"host_ms_in_step": host, "device_ms": device,
            "device_work_ahead_ms": ahead,
            "host_share": max(h / d for h, d in zip(host, device)),
            "waited": any(h >= a for h, a in zip(host, ahead))}


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
        with no_plain_on_cuda():
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
        check_launches(f"predict {key}", launches, {kernel: reps, "nms": reps})
        out[key] = {"images": len(res), "seconds": secs,
                    "images_per_s": len(res) / secs,
                    "stage_ms": dict(yolo.predictor.speed),
                    "launches": launches,
                    "dets_per_image": [min(counts), max(counts)],
                    "batch_breakdown_ms": step_breakdown(torch, yolo, frames),
                    "step_wait": step_wait(torch, yolo.predictor, frames)}
        if out[key]["step_wait"]["waited"]:
            raise AssertionError(f"predict {key}: the step waited on the "
                                 f"device: {out[key]['step_wait']}")
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


# train phase: the parity size and the label rows an image
TRAIN_SMALL, TRAIN_BOXES = 128, 8
# small-size card vs CPU, TF32 off, one SGD micro-step that applies the
# update (nbs = batch). cuDNN's convolutions sum in other orders than the
# CPU's, and the f32 train forward of these random weights is itself
# ill-conditioned: the port's and the JAX package's CPU forwards each sit
# ~2e-4 of the largest map value from a float64 forward
# (tests/test_torch_train_flagship.py), and the gradients of layer 0's
# parameter CNN differ by 5e-3 of their largest entry between the two
# packages on the CPU (tests/test_torch_train_slice.py). A leaf's gradient
# is held by its norm: the bias of a BN whose output feeds another
# train-mode BN gets a gradient that nearly cancels (a constant shift is
# taken out by the next layer's batch mean, but for the activation between),
# so its largest entry is a poor yardstick (4.9e-2 of it on an H100, where
# the median leaf read 3.4e-3). So: loss items 5e-3 relative;
# each gradient within 5e-2 of its norm; each parameter's and EMA entry's
# move 5e-2 of the largest move of its tensor (plus 1e-6); BN running stats
# 1e-3 absolute.
TRAIN_TOL = {"items_rel": 5e-3, "grad_rel": 5e-2, "move_rel": 5e-2,
             "stats_abs": 1e-3}


def train_batch(n, imgsz, seed):
    """The JAX loader's batch dict: seeded clean u8 frames (32-px colour
    blocks with noise; the trainer darkens them) and TRAIN_BOXES label rows
    an image, a quarter of them padding."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, imgsz // 32, imgsz // 32, 3)) / 255
    img = np.kron(base, np.ones((1, 32, 32, 1)))
    img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    m = TRAIN_BOXES
    xy = rng.uniform(0.2, 0.8, (n, m, 2))
    wh = rng.uniform(0.05, 0.4, (n, m, 2))
    return {"img": (img * 255).astype(np.uint8),
            "cls": rng.integers(0, 3, (n, m)).astype(np.float32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask_gt": (rng.uniform(size=(n, m)) > 0.25).astype(np.float32)}


def train_parity(torch):
    """One micro-step of the flagship at TRAIN_SMALL, b2, on the card and on
    the CPU from the same weights and batch: first the loss and gradients
    (the BN stats put back after), then `step` (update, BN stats, EMA)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
    over = {"batch": 2, "nbs": 2, "optimizer": "SGD", "imgsz": TRAIN_SMALL}
    nb, step_index = 1000, 1500                # inside the 3000-step warmup
    gpu = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    cpu = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    start = {k: v.cpu().clone() for k, v in cpu.state_dict().items()}
    batch = train_batch(2, TRAIN_SMALL, SEED)
    got = {}
    with matmul_precision("float32"):
        for key, yolo, dev in (("gpu", gpu, None), ("cpu", cpu, "cpu")):
            tr = DetectionTrainer(yolo.model, over, nb=nb, device=dev)
            names = list(tr.params)
            tr.model.train()
            total, items = tr.loss(tr.to_device(batch))
            grads = torch.autograd.grad(
                total, [tr.params[n] for n in names], allow_unused=True)
            tr.model.eval()
            tr.model.load_state_dict(start)
            _, step_items = tr.step(batch, step_index)
            got[key] = {"items": items, "step_items": step_items,
                        "grads": {n: g for n, g in zip(names, grads)
                                  if g is not None},
                        "state": tr.model.state_dict(), "ema": tr.ema,
                        "updates": (tr.opt_state.step, tr.ema_updates)}
    g, c = got["gpu"], got["cpu"]
    cpu_of = lambda t: t.detach().cpu()
    rel = lambda a, b: float((cpu_of(a) - b).abs().max() / b.abs().max())
    items_rel = max(rel(torch.stack(list(g["items"])), torch.stack(list(c["items"]))),
                    rel(g["step_items"], c["step_items"]))
    grad_rel = {n: float(torch.linalg.vector_norm(cpu_of(g["grads"][n]) - w)
                         / torch.linalg.vector_norm(w))
                for n, w in c["grads"].items() if w.abs().max() > 0}
    worst_grad = max(grad_rel, key=grad_rel.get)
    grad_max_rel = max(rel(g["grads"][n], c["grads"][n]) for n in grad_rel)
    stats_err, move_err = 0.0, {}
    for k, w in c["state"].items():
        if "running_" in k:
            stats_err = max(stats_err, float((cpu_of(g["state"][k]) - w).abs().max()),
                            float((cpu_of(g["ema"][k]) - c["ema"][k]).abs().max()))
            continue
        moved = float((w - start[k]).abs().max())
        err = max(float((cpu_of(g["state"][k]) - w).abs().max()),
                  float((cpu_of(g["ema"][k]) - c["ema"][k]).abs().max()))
        move_err[k] = (err - 1e-6) / moved if moved else (0.0 if err <= 1e-6 else float("inf"))
    worst_move = max(move_err, key=move_err.get)
    rec = {"imgsz": TRAIN_SMALL, "batch": 2,
           "items_gpu": [float(x) for x in g["items"]],
           "items_cpu": [float(x) for x in c["items"]],
           "items_max_rel_err": items_rel,
           "grad_norm_rel_err": grad_rel[worst_grad], "grad_worst_leaf": worst_grad,
           "grad_norm_rel_err_median": sorted(grad_rel.values())[len(grad_rel) // 2],
           "grad_max_entry_rel_err": grad_max_rel,
           "move_max_rel_err": move_err[worst_move], "move_worst": worst_move,
           "bn_stats_and_ema_max_abs_err": stats_err,
           "updates_gpu": g["updates"], "updates_cpu": c["updates"],
           "tol": TRAIN_TOL}
    rec["ok"] = (items_rel <= TRAIN_TOL["items_rel"]
                 and rec["grad_norm_rel_err"] <= TRAIN_TOL["grad_rel"]
                 and rec["move_max_rel_err"] <= TRAIN_TOL["move_rel"]
                 and stats_err <= TRAIN_TOL["stats_abs"]
                 and g["updates"] == c["updates"] == (1, 1))
    return rec


def train_full(torch):
    """yolov8l, nc=3, b16, imgsz 640, f32, default precision (TF32 on):
    one warm-up window, then two timed accumulation windows of 4."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools._ab import CLOCKS_QUERY, nvidia_smi, time_ms
    yolo = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64}, nb=1000)
    batches = [train_batch(BATCH, IMGSZ, SEED + i) for i in range(3)]
    with matmul_precision("default"):
        for i in range(tr.accumulate):                       # warm-up window
            tr.step(batches[i % 3], i)
        torch.cuda.synchronize()
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        u0, e0 = tr.opt_state.step, tr.ema_updates
        windows_ms, items = [], []
        for w in range(2):
            t0 = time.perf_counter()
            for j in range(tr.accumulate):
                i = tr.accumulate * (w + 1) + j
                items.append(tr.step(batches[i % 3], i)[1])
            torch.cuda.synchronize()
            windows_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        smi = nvidia_smi(CLOCKS_QUERY)
        dev_batch = tr.to_device(batches[0])
        params = list(tr.params.values())
        tr.model.train()
        fwd_loss = time_ms(lambda: tr.loss(dev_batch), iters=3, warmup=1)
        fwd_bwd = time_ms(lambda: torch.autograd.grad(tr.loss(dev_batch)[0],
                                                      params), iters=3, warmup=1)
        tr.model.eval()
    items = torch.stack(items).cpu()
    micro = len(items)
    rec = {"model": "yolov8l.yaml", "nc": 3, "batch": BATCH, "imgsz": IMGSZ,
           "precision": "f32, TF32 convs (default)", "optimizer": tr.opt_name,
           "accumulate": tr.accumulate, "micro_steps": micro,
           "window_ms": windows_ms,
           "micro_step_ms": sum(windows_ms) / micro,
           "images_per_s": BATCH * micro / (sum(windows_ms) / 1e3),
           "forward_loss_ms": fwd_loss, "forward_backward_ms": fwd_bwd,
           "loss_items": items.tolist(),
           "finite": bool(torch.isfinite(items).all()),
           "applied": tr.opt_state.step - u0, "ema_updates": tr.ema_updates - e0,
           "peak_memory_gib": peak / 2 ** 30, "launches": launches,
           "nvidia_smi": smi}
    check_launches("train", launches, {"fused_enhance": micro})
    if not (rec["finite"] and rec["applied"] == 2 and rec["ema_updates"] == 2):
        raise AssertionError(f"train: {rec}")
    return rec


def phase_train(torch):
    small = train_parity(torch)
    full = train_full(torch)
    emit({"phase": "train", "parity": small, "full": full})
    if not small["ok"]:
        raise AssertionError(f"train step: card and CPU disagree: {small}")
    return full


# val phase. Small: the card against the CPU at imgsz 128 (8 images of 3
# shapes, batch 4); full: 64 images of the 4 shapes, longest side 640, at
# the val defaults (batch 16, imgsz 640, conf 0.001, iou 0.7, max_det 300).
VAL_SMALL = {"n": 8, "imgsz": 128, "batch": 4,
             "shapes": [(96, 128), (128, 128), (128, 80)]}
VAL_FULL = {"n": 64, "imgsz": 640, "batch": 16,
            "shapes": [(480, 640), (640, 512), (640, 640), (360, 640)]}
VAL_NAMES = {0: "c0", 1: "c1", 2: "c2"}
VAL_BOXES = (1, 8)          # labels an image
# The card's val against the CPU's (TF32 off) on the same weights and data,
# image by image as tests/test_torch_val.py holds the port to JAX: equal
# detection counts, and every detection paired with one of the same class
# and TP row, box (native pixels) within BOX_TOL_PX and score within
# SCORE_TOL (the cpu phase's bars at 640). Pairs, not ranks: two
# detections whose scores lie closer than the card's score error may be
# listed in the other order (on an H100, 8 detections of the 8 images in
# each of the three runs; boxes within 0.035 px, scores within 6.9e-5).
# With equal TP matrices and classes, AP depends on the scores only through
# their order and P and R through a linear interpolation on the conf grid:
# the metrics came out bit-equal on the card (H100 80GB HBM3, 700 W), held
# to VAL_METRIC_RTOL of each metric's own value, the CPU tests' 1e-6 bar.
# The with_loss items read 3.2e-5 relative on that card (the loss sums
# every anchor's term; cuDNN's convolutions sum in another order than the
# CPU's), held to three times that.
VAL_METRIC_RTOL = 1e-6
VAL_LOSS_RTOL = 1e-4


def val_dataset(root, n, shapes, seed):
    """A seeded YOLO-layout val split under `root`: low-light images (dark
    32-px colour blocks with noise, 1-8 filled boxes of class colours, then
    (u8/255)**DARK_PARAM) of the given (h, w) shapes in turns, each written
    as its .npy sidecar beside an empty placeholder .jpg (the card has no
    image decoder: the validator reads them with cache='disk'), and their
    label files. No two boxes of an image overlap at IoU above 0.5, so NMS
    keeps every label of save_hybrid. Returns the dataset dict."""
    import numpy as np
    import torch
    from dedark_yolo_tpu_torch.ops.boxes import box_iou_matrix
    rng = np.random.default_rng(seed)
    colours = np.array([(255, 64, 64), (64, 255, 64), (64, 64, 255)], np.float32)
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for k in range(n):
        h, w = shapes[k % len(shapes)]
        base = rng.uniform(0, 0.5, (-(-h // 32), -(-w // 32), 3))
        img = np.kron(base, np.ones((32, 32, 1)))[:h, :w] * 255
        boxes, rows = [], []
        for _ in range(int(rng.integers(VAL_BOXES[0], VAL_BOXES[1] + 1))):
            for _ in range(50):
                bw = int(rng.integers(max(8, w // 10), w // 2))
                bh = int(rng.integers(max(8, h // 10), h // 2))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                box = (x1, y1, x1 + bw, y1 + bh)
                if not boxes or float(box_iou_matrix(
                        torch.tensor([box], dtype=torch.float32),
                        torch.tensor(boxes, dtype=torch.float32)).max()) <= 0.5:
                    break
            else:
                continue
            c = int(rng.integers(0, len(VAL_NAMES)))
            boxes.append(box)
            img[y1:y1 + bh, x1:x1 + bw] = colours[c]
            rows.append(f"{c} {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} "
                        f"{bw / w:.6f} {bh / h:.6f}")
        img = np.clip(img / 255 + rng.normal(0, 0.03, img.shape), 0, 1)
        np.save(img_dir / f"{k}.npy", (img ** DARK_PARAM * 255).astype(np.uint8))
        (img_dir / f"{k}.jpg").write_bytes(b"")
        (lbl_dir / f"{k}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "val": "images/val", "names": dict(VAL_NAMES)}


def val_images(data, n):
    """The first n images of a val_dataset, BGR uint8."""
    import numpy as np
    return [np.load(Path(data["path"]) / "images" / "val" / f"{k}.npy")
            for k in range(n)]


class record_detections:
    """Within the block, each image the validator matched, in processing
    order: (native xyxy boxes, classes, TP matrix) from its wrapped
    `match_predictions`, and all images' scores in the same order from its
    wrapped `DetMetrics.process`."""

    def __enter__(self):
        import numpy as np
        from dedark_yolo_tpu_torch.engine import validator as V
        self.module, self.match = V, V.match_predictions
        self.process = V.DetMetrics.process
        self.images, self.scores = [], np.zeros(0, np.float32)

        def recorded(pred_boxes, pred_cls, gt_boxes, gt_cls):
            tp = self.match(pred_boxes, pred_cls, gt_boxes, gt_cls)
            self.images.append((np.array(pred_boxes), np.array(pred_cls), tp))
            return tp

        def processed(metrics, tp, conf, pred_cls, target_cls):
            self.scores = np.array(conf)
            return self.process(metrics, tp, conf, pred_cls, target_cls)
        V.match_predictions = recorded
        V.DetMetrics.process = processed
        return self

    def __exit__(self, *exc):
        self.module.match_predictions = self.match
        self.module.DetMetrics.process = self.process

    @property
    def counts(self):
        return [len(c) for _, c, _ in self.images]

    def detections(self):
        """Per image: (boxes, classes, TP matrix, scores)."""
        import numpy as np
        ends = np.cumsum(self.counts)
        if ends.size and ends[-1] != len(self.scores):
            raise AssertionError("val: scores and matched detections differ")
        return [(*im, s) for im, s in
                zip(self.images, np.split(self.scores, ends[:-1]))]


def pair_detections(g, c):
    """Pairs each of the CPU's detections of an image (in its score order)
    with a card detection of the same class and TP row, its box within
    BOX_TOL_PX and its score within SCORE_TOL; (card index for each, box
    errors, score errors), or None where one finds no partner. The card may
    list two detections whose scores lie within its score error of each
    other in the other order; NMS keeps no two boxes of a class that close,
    so the partner is unique."""
    import numpy as np
    (gb, gc, gtp, gs), (cb, cc, ctp, cs) = g, c
    free, order, box_err, score_err = list(range(len(gc))), [], [], []
    for i in range(len(cc)):
        for j in free:
            db, ds = float(np.abs(gb[j] - cb[i]).max()), abs(float(gs[j] - cs[i]))
            if (gc[j] == cc[i] and db <= BOX_TOL_PX and ds <= SCORE_TOL
                    and np.array_equal(gtp[j], ctp[i])):
                free.remove(j)
                order.append(j)
                box_err.append(db)
                score_err.append(ds)
                break
        else:
            return None
    return order, box_err, score_err


def compare_images(gpu, cpu):
    """The card's records (record_detections) against the CPU's, image by
    image: equal counts, and every detection paired (pair_detections) with
    one of the same class and TP row, box within BOX_TOL_PX and score within
    SCORE_TOL. `reordered` counts the pairs listed at another rank."""
    same = [len(g[1]) == len(c[1]) for g, c in zip(gpu.images, cpu.images)]
    rec = {"images": [len(gpu.images), len(cpu.images)],
           "images_equal_counts": sum(same) / max(len(same), 1),
           "dets_per_image": [min(gpu.counts, default=0),
                              max(gpu.counts, default=0)],
           "cpu_tp50": int(sum(tp[:, 0].sum() for _, _, tp in cpu.images))}
    rec["ok"] = rec["images"][0] == rec["images"][1] and all(same)
    if not rec["ok"]:
        return rec
    pairs = [pair_detections(g, c)
             for g, c in zip(gpu.detections(), cpu.detections())]
    rec["images_paired"] = sum(p is not None for p in pairs)
    rec["ok"] = rec["images_paired"] == len(pairs)
    if rec["ok"]:
        rec["reordered"] = sum(j != i for order, _, _ in pairs
                               for i, j in enumerate(order))
        rec["box_max_abs_err_px"] = max((e for _, b, _ in pairs for e in b),
                                        default=0.0)
        rec["score_max_abs_err"] = max((e for _, _, s in pairs for e in s),
                                       default=0.0)
    return rec


class record_steps:
    """Within the block, each val batch's host ms inside the device step
    (`predictor.detect_step` as the validator calls it: forward, decode,
    NMS) and, from CUDA events around them, the batch's device ms and its
    NMS stage's (gate, kernel, gathers) device ms (read with `device_ms()`
    and `nms_ms()` after a synchronize)."""

    def __enter__(self):
        import torch
        from dedark_yolo_tpu_torch.engine import predictor as P
        from dedark_yolo_tpu_torch.engine import validator as V
        self.module, self.step, self.host, self.events = V, V.detect_step, [], []
        self.nms, self.nms_events = P.non_max_suppression, []

        def timed(fn, events, host=None):
            def call(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if host is not None:
                    host.append((time.perf_counter() - t0) * 1e3)
                ev[1].record()
                events.append(ev)
                return out
            return call
        V.detect_step = timed(self.step, self.events, self.host)
        P.non_max_suppression = timed(self.nms, self.nms_events)
        return self

    def __exit__(self, *exc):
        from dedark_yolo_tpu_torch.engine import predictor as P
        self.module.detect_step = self.step
        P.non_max_suppression = self.nms

    def device_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]

    def nms_ms(self):
        return [a.elapsed_time(b) for a, b in self.nms_events]


def label_counts(data):
    """Labels of each class in the dataset dict's val split."""
    from pathlib import Path
    counts = dict.fromkeys(data["names"], 0)
    for f in (Path(data["path"]) / "labels" / "val").glob("*.txt"):
        for line in f.read_text().split("\n"):
            if line.strip():
                counts[int(line.split()[0])] += 1
    return counts


METRICS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
           "metrics/mAP50-95(B)")


def set_contrast_mode(model, mode):
    """Layer 0's contrast luminance ('channel' or 'reference')."""
    from dedark_yolo_tpu_torch.nn.enhance import LowlightRecovery
    for m in model.modules():
        if isinstance(m, LowlightRecovery):
            m.contrast_mode = mode


def val_parity(torch, yolo, data):
    """The card's val against the CPU's on the small dataset, TF32 off, in
    contrast_mode 'channel': plain, save_hybrid and with_loss, image by
    image (compare_images) and by the results dict; the card's runs launch
    fused_enhance and nms once a batch, no plain version reached with a
    CUDA tensor. Then the card alone in contrast_mode 'reference' (usm, not
    fused_enhance, launched a batch)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.cfg import get_cfg
    from dedark_yolo_tpu_torch.engine.validator import DetectionValidator
    from dedark_yolo_tpu_torch.ops import _build
    cpu = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in yolo.state_dict().items()})
    for model in (yolo.model, cpu.model):
        set_contrast_mode(model, "channel")
    kw = {"data": data, "imgsz": VAL_SMALL["imgsz"],
          "batch": VAL_SMALL["batch"], "cache": "disk",
          "matmul_precision": "float32", "verbose": False}
    batches = -(-VAL_SMALL["n"] // VAL_SMALL["batch"])
    out = {"labels": label_counts(data), "metric_rtol": VAL_METRIC_RTOL,
           "loss_rtol": VAL_LOSS_RTOL, "box_tol_px": BOX_TOL_PX,
           "score_tol": SCORE_TOL}
    ok = True
    for name, extra, with_loss in (("plain", {}, False),
                                   ("save_hybrid", {"save_hybrid": True}, False),
                                   ("with_loss", {}, True)):
        res, recs = {}, {}
        for dev, model in (("cuda", yolo), ("cpu", cpu)):
            v = DetectionValidator(args=get_cfg({**kw, **extra, "device": dev}))
            zero_launches()
            with no_plain_on_cuda(), record_detections() as recs[dev]:
                res[dev] = {k: float(x) for k, x in
                            v(model=model.model, with_loss=with_loss).items()}
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
                check_launches(f"val {name}", launches,
                               {"fused_enhance": batches, "nms": batches})
        g, c = res["cuda"], res["cpu"]
        rec = {"cuda": g, "cpu": c, "launches": launches,
               **compare_images(recs["cuda"], recs["cpu"]),
               "metric_max_rel_err": max(abs(g[k] - c[k]) / abs(c[k])
                                         if c[k] else abs(g[k])
                                         for k in METRICS)}
        rec["ok"] = (rec["ok"] and rec["images"][1] == VAL_SMALL["n"]
                     and rec["metric_max_rel_err"] <= VAL_METRIC_RTOL)
        if with_loss:
            rec["loss_max_rel_err"] = max(abs(g[k] - c[k]) / abs(c[k])
                                          for k in c if k.startswith("val/"))
            rec["ok"] = rec["ok"] and rec["loss_max_rel_err"] <= VAL_LOSS_RTOL
        if extra.get("save_hybrid"):
            # every label comes back as a detection of score 1
            rec["ok"] = (rec["ok"]
                         and rec["cpu_tp50"] == sum(out["labels"].values()))
            rec["ok"] = rec["ok"] and all(
                r[k] >= 0.99 and r[k] == c[k] for r in (g, c)
                for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)"))
        out[name] = rec
        ok = ok and rec["ok"]
    zero_launches()
    with no_plain_on_cuda():
        ref = yolo.val(**kw, contrast_mode="reference")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    out["reference"] = {"results": {k: float(x) for k, x in ref.items()},
                        "launches": launches}
    check_launches("val reference", launches, {"usm": batches, "nms": batches})
    out["ok"] = ok
    return out


def val_full(torch, yolo, data):
    """Flagship val at the defaults (conf 0.001, iou 0.7, max_det 300,
    max_nms 2048, batch 16, imgsz 640, f32, default precision) over the 64
    full-size images: a warm-up call, then the timed call, whose launches
    must be one fused_enhance and one nms a batch, with no plain version
    reached by a CUDA tensor; with its speed, the rest of its time, and
    each batch's host and device ms of the device step and the device ms
    of its NMS stage."""
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools._ab import CLOCKS_QUERY, nvidia_smi
    kw = {"data": data, "imgsz": VAL_FULL["imgsz"],
          "batch": VAL_FULL["batch"], "cache": "disk", "verbose": False}
    yolo.val(**kw)                                   # warm-up
    torch.cuda.synchronize()
    zero_launches()
    with no_plain_on_cuda(), record_detections() as rec, \
            record_steps() as steps:
        t0 = time.perf_counter()
        res = yolo.val(**kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    batches = -(-VAL_FULL["n"] // VAL_FULL["batch"])
    check_launches("val", launches, {"fused_enhance": batches, "nms": batches})
    speed = dict(yolo.validator.speed)
    out = {"images": len(rec.counts), "seconds": secs,
           "images_per_s": len(rec.counts) / secs,
           "speed_ms_per_image": speed,
           # the call's time outside speed's stages: the dataset's scan,
           # label cache and sidecar headers, the metrics at the end
           "other_ms": secs * 1e3 - sum(speed.values()) * len(rec.counts),
           "step_host_ms": steps.host, "step_device_ms": steps.device_ms(),
           "nms_stage_ms": steps.nms_ms(),
           "results": {k: float(x) for k, x in res.items()},
           "dets_per_image": [min(rec.counts), max(rec.counts)],
           "launches": launches, "nvidia_smi": nvidia_smi(CLOCKS_QUERY)}
    if not (len(rec.counts) == VAL_FULL["n"]
            and all(0.0 <= out["results"][k] <= 1.0 for k in METRICS)):
        raise AssertionError(f"val: {out}")
    return out


def phase_val(torch, yolo):
    """val_parity on the small dataset and val_full on the full one, each
    after calibrate_bn on its own images (the box colours of these images
    lie outside the predict frames' statistics: BN set from those frames
    saturates some scores to 1.0, which would tie save_hybrid's labels)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        small = val_dataset(tmp / "small", VAL_SMALL["n"], VAL_SMALL["shapes"],
                            SEED)
        full = val_dataset(tmp / "full", VAL_FULL["n"], VAL_FULL["shapes"],
                           SEED + 1)
        calibrate_bn(torch, yolo.model, val_images(small, VAL_SMALL["n"]),
                     VAL_SMALL["imgsz"])
        parity = val_parity(torch, yolo, small)
        calibrate_bn(torch, yolo.model, val_images(full, BATCH),
                     VAL_FULL["imgsz"])
        out = val_full(torch, yolo, full)
    out["reference_launches"] = parity["reference"]["launches"]
    emit({"phase": "val", "model": "yolov8l.yaml", "nc": 3, "parity": parity,
          "full": {**VAL_FULL, **out}})
    if not parity["ok"]:
        raise AssertionError(f"val: card and CPU disagree: {parity}")
    return out


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
    nms_timing = phase_kernel_nms(torch, ptxas)

    from dedark_yolo_tpu_torch import YOLO
    frames = synthetic_frames(BATCH)
    yolo = YOLO("yolov8l.yaml", nc=3, seed=SEED)   # device None -> cuda
    calibrate_bn(torch, yolo.model, frames)
    pred = phase_predict(torch, yolo, frames)
    phase_cpu(torch, yolo, frames[0])
    probe_launches = phase_probe(torch)
    train = phase_train(torch)
    val = phase_val(torch, yolo)

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
        "bf16": bf16, "train_launches": train["launches"]["fused_enhance"],
        "val_launches": val["launches"]["fused_enhance"]}, {
        "name": "usm", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/usm.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/enhance_kernel.py:277",
        "launches": pred["reference_f32"]["launches"]["usm"],
        **{k: usm_timing["float32"][k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": [BATCH, IMGSZ, IMGSZ, 3], "dtype": "float32",
        "bf16": usm_timing["bfloat16"], "val_launches": val["launches"]["usm"],
        "val_reference_launches": val["reference_launches"]["usm"]}, {
        "name": "int8_conv", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/int8_conv.py:133",
        "launches": probe_launches["int8_conv"],
        **{k: int8_timing[k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": list(INT8_SHAPES[0]), "dtype": "int8",
        **{k: int8_timing[k] for k in ("act", "tops", "peak_pct")},
        "val_launches": val["launches"]["int8_conv"]}, {
        "name": "nms", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/nms.cu",
        "replaces": "dedark_yolo_tpu/ops/nms.py:28",
        "launches": sum(pred[key]["launches"]["nms"]
                        for key, _, _ in PREDICT_RUNS),
        # ms: device time of a call among calls back to back; ms_alone: one
        # call between CUDA events, the wrapper's host time included
        "ms": nms_timing["queued_ms"], "ms_alone": nms_timing["ms"],
        **{k: nms_timing[k] for k in
           ("max_abs_err", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "library": "none: no torchvision on the card",
        **{k: nms_timing[k] for k in
           ("mask_ms", "scan_ms", "walk_depth", "shape", "max_det")},
        "val_launches": val["launches"]["nms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
