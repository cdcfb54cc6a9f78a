#!/usr/bin/env python3
"""Smoke run of the torch port (dedark_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device. Phases,
each printed as one JSON line; any failure exits non-zero without the final
line:

  env      card name and power limit (nvidia-smi), torch/CUDA versions, TF32;
           g++, the native letterbox library's build, libjpeg (header and
           library: the native decode's build), whether tensorboard imports
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
  predict_resize  predict f32 b16/640 on 16 frames of 1080x1920, 768x1024,
           721x1280 and 1000x1500 (the native letterbox resizes them), cv2
           blocked: images/s, speed, the letterbox's ms a batch, beside the
           480x640 run; one 721x1280 frame on the card against the CPU
  predict_extras  predict f32 b16/640 on the predict phase's frames:
           plain, TTA (augment=True: fused_enhance 3 and nms 1 a batch) and
           a two-member ensemble YOLO([a.npz, b.npz]) (2 and 1), images/s
           of each in turns; TTA in reference mode for a batch (usm 3, nms
           1); TTA and the ensemble on one frame against the CPU, paired;
           save_enhanced and visualize on one frame (one forward): the
           enhanced image within the kernel's TOL of the CPU's, the
           captures layer by layer; OpenCV, Pillow and matplotlib: which
           import, and each one's saving call writes or raises naming it
  serve    InferenceServer(max_batch=16) on the flagship's checkpoint (the
           predict weights as an .npz), TF32, the predict frames plus four
           721x1280: the warmup, two windows of closed-loop clients (3 s
           and 50 batches at least) at each of 1, 4 and 16 threads
           (images/s, p50/p95 latency, occupancy, batches, the windows'
           spread), every response bit-equal to or paired with
           YOLO.predict(batch=16) of its frame at one of the 16 places of
           a batch, /healthz and /stats over HTTP and POST /predict with a
           PNG where OpenCV imports; fused_enhance and nms once a batch,
           the warmup included, no plain version reached, every future
           resolved
  track    YOLO.track(persist=True) over 24 seeded low-light 720x1280 .npy
           frames of moving rectangles (the class logits lifted by one
           constant, see TRACK_RANK): ByteTrack, BoT-SORT with gmc none and,
           where OpenCV imports, sparseOptFlow, two passes each: frames/s,
           the trackers' host ms a frame against the predictor's, the
           passes' spread, fused_enhance and nms once a batch; the
           untracked detections of the same frames through a fresh host
           tracker give the same ids and boxes
  benchmark  YOLO.benchmark(imgsz=640) twice: fp32 and bf16 rows at
           b1/8/32 (5 warm-up and 30 timed calls a row), the two runs'
           spread, no "error" row, fused_enhance and nms once a call
           (warm-ups included)
  export   the predict phase's flagship exported on the card (pt2, b16/640:
           f32, half, contrast_mode 'reference'; seconds and MB, no launch
           during an export) and reloaded through AutoBackend: each
           artifact on the 16 frames against the live model (TF32 off;
           f32 and reference against eval_outputs at 1e-3 px / 1e-5, half
           against AutoBackend(npz, half=True) at one bf16 ulp), the
           detections after nms paired, fused_enhance (usm in reference
           mode) once a call; YOLO(pt2).predict against the live predict
           (images/s of both over 4 timed batches, paired); YOLO(pt2).val
           at 128, b3 on val_parity's 8 images against the live val, paired,
           metrics within 1e-6; InferenceServer(pt2) answering 8 requests
           of one client, each paired with predict of its frame;
           benchmark(formats=("live", "pt2")) without an error row; the
           tiny architecture exported on the CPU run on the card against
           the CPU; `python -m dedark_yolo_tpu_torch export` of its npz
  zoo      the other detect architectures at full width (nc=3, seeded
           weights, BN set from the predict frames): predict f32 b16/640
           with yolov8n/s/m/x and, at scale l, each of the fork's variants
           (-dedark, -faster, -faster-twohead, -rbf, -rbf-asff,
           -mfru-rbf-asff, -asff-threehead, -p2, -p6): a warm-up and 2
           timed batches, fused_enhance once a batch where the model has
           layer 0 and nms once a batch, one frame on the card against the
           CPU, paired; yolov8n also in reference mode (usm once a batch);
           train steps at b16/640 (a warm-up and 3 timed micro-steps) and
           a 128 step on the card against the CPU for yolov8n,
           yolov8l-mfru-rbf-asff, yolov8l-faster-twohead and yolov8l-p6,
           each also with amp=True (bf16): its loss items against f32 at
           the same weights (train_amp's bar) and a warm-up and 3 timed
           micro-steps beside the f32 numbers, yolov8n's fused_enhance once
           a micro-step on a bf16 image, the state f32 after;
           yolov8n-faster-twohead's val on the small set, card against CPU
  classify yolov8l-cls at full width (nc 10 from the data) on a seeded
           class-folder tree of .npy sidecars (16 train and 4 val images a
           class, mixed sizes, cv2 blocked): YOLO(...).train at 224, b32,
           two epochs (images/s an epoch, top-1/top-5, best.npz); a 128, b4
           micro-step on the card against the CPU (TF32 off, the train
           phase's bars); YOLO(best.npz).val and predict of 16 frames on
           the card against the CPU (top-1/top-5 equal, probabilities
           within CLS_PROBS_TOL; predict's images/s); a pt2 export at
           b16/224 through AutoBackend against the live eval_outputs at
           1e-5, YOLO(pt2).predict/val against live; `python -m
           dedark_yolo_tpu_torch classify val` in a subprocess against
           YOLO(npz).val(); no kernel launched and no plain version reached
           with a CUDA tensor
  segment  yolov8l-seg at full width (nc 3 from the data) on a seeded
           polygon dataset of .npy sidecars (64 train and 16 val images of
           mixed sizes up to 640, 1-6 often overlapping instances each, cv2
           blocked): YOLO(...).train at 640, b16, two epochs with
           copy_paste=0.5 (images/s an epoch, the loader's wait against the
           step, peak memory, the four loss items, best.npz); a 128, b2
           micro-step on the card against the CPU (TRAIN_TOL, TF32 off);
           YOLO(best.npz).val and predict of 16 frames on the card against
           the CPU (val's pairing with box and mask TP rows, the four mAPs
           within VAL_METRIC_RTOL; predict's pairs above a gap conf, each
           pair's mask within SEG_MASK_PIXELS plus a box-perimeter band,
           and the mask logits of 8 frames within SEG_LOGIT_RTOL); predict
           images/s in f32 and
           half and one retina_masks batch; a pt2 export at b16/640 through
           AutoBackend against the live eval_outputs, YOLO(pt2).val and
           predict against live; `python -m dedark_yolo_tpu_torch segment
           val` in a subprocess against YOLO(npz).val(); then
           yolov8-seg.yaml's rows under a layer-0 row at scale l predicting
           the 16 low-light frames (one frame card vs CPU); nms once a
           predict or val batch, fused_enhance once a batch of the layer-0
           graph only
  probe    tools.int8_probe at its default shape (24 layers, b32, 80x80,
           C=Co=256): bf16 cuDNN chain vs the int8_conv kernel's chain
  train    DetectionTrainer: at imgsz 128, b2, one micro-step on the card
           against the CPU (loss items, gradients, updated parameters, BN
           stats, EMA, the assigner's choices counted; TF32 off;
           tools/c14_split.py's train_parity); then yolov8l at b16, imgsz 640, f32,
           default precision: a warm-up window and two timed accumulation
           windows (8 micro-steps, 2 applied updates), fused_enhance
           launched once per micro-step and nms never
  val      YOLO(...).val on seeded synthetic datasets written as .npy
           sidecars (cache='disk', data as a dict), BN calibrated on each
           set's own images: 8 images of 3 shapes at imgsz 128 on the card
           against the CPU image by image (counts, classes, TP matrices,
           boxes, scores), by metrics and by the plots' confusion matrix
           (plain, save_hybrid, with_loss; TF32 off; fused_enhance and nms
           once a batch), then
           contrast_mode 'reference' (usm and nms once a batch); then 64
           images of 4 shapes, longest side 640, at the val defaults (b16,
           conf 0.001): a warm-up call and a timed one, fused_enhance and
           nms once a batch, no plain version reached with a CUDA tensor
  val_resize  val of .npy sidecars of 720x1280, 1080x1920 and 300x500
           (resized max-side by data/imgops.py) at 128 and 640, cv2
           blocked: the card against the CPU as in val, and the images
           the dataset loaded equal in both runs
  darkset  the fork's data path: 48 clean frames (16 each at 480x640,
           720x1280, 1080x1920) through the low-light maker's core on the
           card at 7.5 and 5 (b16; the 256-level lookup against the CPU's,
           5 bit-equal to the CPU; images/s a resolution with each call's
           CUDA-event span), the 7.5 frames written as the dark split that
           the packaged tielu.yaml names, autosplit, calc_dataset_info and
           DatasetStats counted against the labels, then the flagship's val
           of it (b16/640, f32) with plots=False and plots=True: launches
           fused_enhance 3 and nms 3 each, equal results, the confusion
           matrix equal to one rebuilt from the detections, the plot files
           (none where matplotlib does not import); cv2 blocked
  train_loop  YOLO(...).train() on seeded low-light .npy sidecars (data a
           dict, cache='disk', longest side = imgsz): the flagship at 128,
           b2, two epochs on the card against the CPU from one seeded .npz
           (TF32 off, default augmentation; loss rows and val metrics per
           epoch); then at b16/640 two epochs with mosaic and
           close_mosaic=1 and resume=True for a third (images/s, the
           loader's wait against each step's device span, val and
           checkpoint seconds, peak memory, the files written), each run
           launching fused_enhance once a micro-step and a val batch and
           nms once a val batch; then YOLO("best.npz") predicts one batch
  loop_mp  loop_full's settings at b16/640 on sidecars that need a resize:
           one epoch with 8 loader threads, one with 8 forked processes
           (loader_mp), twice in turns, cv2 blocked; the processes' epochs
           with profile=True: the trace of micro-step 2 and the device's
           idle share in it
  autobatch  batch=-1 at 640 for one epoch: the two trial peaks, the batch
           fitted, each real micro-step's peak under 0.67 of the card
  c10      the tiny architecture at imgsz 96: YOLO(...).val() and then
           .train() for two micro-steps in this process (ROADMAP C10: a
           cache filled under val's inference mode once broke the step)
  train_amp  amp=True (bf16) at b16/640: the loss items against f32 at the
           same weights and batch, then timed windows beside train's f32
           numbers; fused_enhance once a micro-step on a bf16 image, the
           masters, EMA and BN stats f32
  cli      python -m dedark_yolo_tpu_torch val and train in subprocesses,
           val's printed metrics against YOLO(npz).val() here

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
# strip and a segment; then TTA's two smaller passes at 640 (531 and 428
# padded to 544 and 448: neither a multiple of the 72-column strip)
KERNEL_SHAPES = [(16, 640, 640), (3, 481, 643), (1, 64, 96), (1, 13, 13),
                 (2, 37, 45), (16, 544, 544), (16, 448, 448)]
# usm: the reference-mode predict shape, a ragged one, the smallest side,
# TTA's two smaller passes
USM_SHAPES = [(16, 640, 640), (3, 481, 643), (1, 13, 13), (16, 544, 544),
              (16, 448, 448)]
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


def host_env():
    """The host side the port needs beyond torch: g++ and the native
    letterbox library it builds (predict needs it), whether libjpeg's
    header and library exist (the native decode needs both; where they
    are missing its build raises, and nothing on the main path decodes),
    and whether the TensorBoard writer can import."""
    import ctypes.util
    import subprocess
    from dedark_yolo_tpu_torch import native
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    rec = {"gxx": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None,
           "libjpeg": ctypes.util.find_library("jpeg")}
    t0 = time.perf_counter()
    native.load("letterbox")
    rec["native_letterbox_build_s"] = time.perf_counter() - t0
    try:
        native.load("decode")
        rec["jpeglib_h"], rec["native_decode"] = True, "built"
    except RuntimeError as e:
        rec["jpeglib_h"] = "jpeglib.h" not in str(e)
        rec["native_decode"] = str(e).splitlines()[0]
    try:
        import tensorboard
        rec["tensorboard"] = tensorboard.__version__
    except Exception as e:      # the writer is then skipped, as in JAX
        rec["tensorboard"] = f"not importable: {type(e).__name__}: {e}"
    return rec


def phase_env(torch):
    from dedark_yolo_tpu_torch.tools._ab import nvidia_smi
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          **host_env()})
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
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
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
        parts["kernel"] = lambda: K.fused_enhance(x, feats, A, ica)
        return parts
    params = E.regress_filter_params(feats)
    point = lambda: E.apply_point_filters(x, params, A, ica, m.contrast_mode)
    y = point()
    parts.update(regress=lambda: E.regress_filter_params(feats),
                 point_filters=point,
                 kernel=lambda: K.usm(y, params["usm"]))
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
    reaches them: on the card the forward goes through the kernels. The
    one exception is the backward of the `fused_enhance` and `usm` ops, which
    recomputes through the plain chain by design (as the JAX package's
    custom VJP does through XLA; ops/enhance_kernel.py)."""

    def __enter__(self):
        import torch
        from dedark_yolo_tpu_torch.nn import enhance as E
        from dedark_yolo_tpu_torch.ops import enhance_kernel as K
        from dedark_yolo_tpu_torch.ops import nms as N
        self.in_backward = 0   # the autograd engine runs it on its own thread

        def guard(mod, name):
            fn = getattr(mod, name)

            def checked(*args, **kwargs):
                if not self.in_backward and any(
                        isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"{name} reached with a CUDA tensor")
                return fn(*args, **kwargs)
            setattr(mod, name, checked)
            return mod, name, fn

        recompute = K._recompute_backward

        def backward(*args, **kwargs):
            self.in_backward += 1
            try:
                return recompute(*args, **kwargs)
            finally:
                self.in_backward -= 1
        K._recompute_backward = backward
        self.saved = [guard(N, "_greedy"), guard(E, "apply_filter_chain"),
                      guard(E, "usm_filter"), (K, "_recompute_backward", recompute)]
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


def train_full(torch):
    """yolov8l, nc=3, b16, imgsz 640, f32, default precision (TF32 on):
    one warm-up window, then two timed accumulation windows of 4."""
    from dedark_yolo_tpu_torch.tools.c14_split import train_batch
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
    from dedark_yolo_tpu_torch.tools.c14_split import train_parity
    small = train_parity()
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


def scene(rng, h, w):
    """One seeded scene of (h, w): dark 32-px colour blocks with noise and
    1-8 filled boxes of class colours, no two of them overlapping at IoU
    above 0.5; (the image in [0, 1], its YOLO label rows, 6 decimals)."""
    import numpy as np
    import torch
    from dedark_yolo_tpu_torch.ops.boxes import box_iou_matrix
    colours = np.array([(255, 64, 64), (64, 255, 64), (64, 64, 255)], np.float32)
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
    return np.clip(img / 255 + rng.normal(0, 0.03, img.shape), 0, 1), rows


def write_sidecar(img_dir, lbl_dir, stem, img, rows):
    """One image of the .npy-sidecar layout: the BGR array as `stem.npy`
    beside an empty placeholder `stem.jpg` (the card has no image decoder:
    the datasets read the sidecar with cache='disk'), and its label file
    unless `rows` is None."""
    import numpy as np
    np.save(img_dir / f"{stem}.npy", img)
    (img_dir / f"{stem}.jpg").write_bytes(b"")
    if rows is not None:
        (lbl_dir / f"{stem}.txt").write_text("\n".join(rows) + "\n")


def val_dataset(root, n, shapes, seed, split="val"):
    """A seeded YOLO-layout val split under `root`: low-light images (a
    `scene` each, then (u8/255)**DARK_PARAM) of the given (h, w) shapes in
    turns, written as .npy sidecars with their label files. No two boxes
    of an image overlap at IoU above 0.5, so NMS keeps every label of
    save_hybrid. Returns the dataset dict."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img_dir, lbl_dir = root / "images" / split, root / "labels" / split
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for k in range(n):
        img, rows = scene(rng, *shapes[k % len(shapes)])
        write_sidecar(img_dir, lbl_dir, k,
                      (img ** DARK_PARAM * 255).astype(np.uint8), rows)
    return {"path": str(root), split: f"images/{split}", "names": dict(VAL_NAMES)}


def val_images(data, n):
    """The first n images of a val_dataset, BGR uint8."""
    import numpy as np
    return [np.load(Path(data["path"]) / "images" / "val" / f"{k}.npy")
            for k in range(n)]


class record_detections:
    """Within the block, each image the validator matched, in processing
    order: (native xyxy boxes, classes, TP matrix) from its wrapped
    `match_predictions`, with the image's labels (native xyxy boxes,
    classes) in `gts`, and all images' scores in the same order from its
    wrapped `DetMetrics.process`."""

    def __enter__(self):
        import numpy as np
        from dedark_yolo_tpu_torch.engine import validator as V
        self.module, self.match = V, V.match_predictions
        self.process = V.DetMetrics.process
        self.images, self.gts = [], []
        self.scores = np.zeros(0, np.float32)

        def recorded(pred_boxes, pred_cls, gt_boxes, gt_cls):
            tp = self.match(pred_boxes, pred_cls, gt_boxes, gt_cls)
            self.images.append((np.array(pred_boxes), np.array(pred_cls), tp))
            self.gts.append((np.array(gt_boxes), np.array(gt_cls)))
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


def pair_detections(g, c, box_tol=BOX_TOL_PX, score_tol=SCORE_TOL):
    """Pairs each of the CPU's detections of an image (in its score order)
    with a card detection of the same class and TP row, its box within
    box_tol and its score within score_tol; (card index for each, box
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
            if (gc[j] == cc[i] and db <= box_tol and ds <= score_tol
                    and np.array_equal(gtp[j], ctp[i])):
                free.remove(j)
                order.append(j)
                box_err.append(db)
                score_err.append(ds)
                break
        else:
            return None
    return order, box_err, score_err


def compare_images(gpu, cpu, box_tol=BOX_TOL_PX, score_tol=SCORE_TOL):
    """The card's records (record_detections) against the CPU's, image by
    image: equal counts, and every detection paired (pair_detections) with
    one of the same class and TP row, box within box_tol and score within
    score_tol. `reordered` counts the pairs listed at another rank."""
    same = [len(g[1]) == len(c[1]) for g, c in zip(gpu.images, cpu.images)]
    rec = {"images": [len(gpu.images), len(cpu.images)],
           "images_equal_counts": sum(same) / max(len(same), 1),
           "dets_per_image": [min(gpu.counts, default=0),
                              max(gpu.counts, default=0)],
           "cpu_tp50": int(sum(tp[:, 0].sum() for _, _, tp in cpu.images))}
    rec["ok"] = rec["images"][0] == rec["images"][1] and all(same)
    if not rec["ok"]:
        return rec
    pairs = [pair_detections(g, c, box_tol, score_tol)
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


def confusion_of(dets, gts, nc):
    """The validator's ConfusionMatrix (conf 0.25, IoU 0.45) rebuilt on the
    host from per-image detections (boxes, classes, TP, scores) and
    labels, as the validator feeds it: one (k, 6) f32 [xyxy, conf, cls]
    array an image."""
    import numpy as np
    from dedark_yolo_tpu_torch.utils.metrics import ConfusionMatrix
    cm = ConfusionMatrix(nc=nc)
    for (boxes, cls, _, scores), (gb, gc) in zip(dets, gts):
        det = np.concatenate([np.reshape(boxes, (-1, 4)), np.reshape(scores, (-1, 1)),
                              np.reshape(cls, (-1, 1))], 1).astype(np.float32)
        cm.process_batch(det, gb, gc)
    return cm.matrix


def compare_confusion(gpu, cpu, cm_gpu, cm_cpu, nc):
    """The card's confusion matrix against the CPU's through the pairing of
    compare_images: equal; or, where a pair lies on the two sides of the
    matrix's conf (0.25) or of its IoU (0.45) with a label of its image,
    equal to the matrix of the CPU's detections each replaced by its card
    partner. Each side's matrix must also equal the one rebuilt from its
    own recorded detections."""
    import numpy as np
    import torch
    from dedark_yolo_tpu_torch.ops.boxes import box_iou_matrix
    from dedark_yolo_tpu_torch.utils.metrics import ConfusionMatrix
    probe = ConfusionMatrix(nc=nc)
    g_dets, c_dets = gpu.detections(), cpu.detections()
    rec = {"cm_equal": bool(np.array_equal(cm_gpu, cm_cpu)),
           "cm_max_cell_diff": float(np.abs(cm_gpu - cm_cpu).max()),
           "cm_labels": float(cm_cpu[:, :nc].sum()),
           "cm_own": [bool(np.array_equal(cm_gpu, confusion_of(g_dets, gpu.gts, nc))),
                      bool(np.array_equal(cm_cpu, confusion_of(c_dets, cpu.gts, nc)))]}
    straddles, swapped = 0, []
    for g, c, (gb, _) in zip(g_dets, c_dets, cpu.gts):
        order, _, _ = pair_detections(g, c)
        partner = tuple(np.asarray(x)[order] for x in g)
        swapped.append(partner)
        conf_side = (partner[3] > probe.conf) != (np.asarray(c[3]) > probe.conf)
        straddles += int(conf_side.sum())
        if len(gb) and len(order):
            iou = [box_iou_matrix(torch.from_numpy(np.asarray(gb, np.float32)),
                                  torch.from_numpy(np.asarray(b, np.float32))
                                  ).numpy() > probe.iou_thres
                   for b in (partner[0], c[0])]
            straddles += int((iou[0] != iou[1]).any(0).sum())
    rec["cm_straddles"] = straddles
    rec["cm_paired_equal"] = bool(np.array_equal(
        cm_gpu, confusion_of(swapped, cpu.gts, nc)))
    rec["cm_ok"] = all(rec["cm_own"]) and (
        rec["cm_equal"] or (straddles > 0 and rec["cm_paired_equal"]))
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
    image (compare_images), by the results dict and by the confusion
    matrix that plots=True fills (compare_confusion); the card's runs launch
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
        res, recs, cms = {}, {}, {}
        for dev, model in (("cuda", yolo), ("cpu", cpu)):
            v = DetectionValidator(args=get_cfg({**kw, **extra, "device": dev}))
            zero_launches()
            with no_plain_on_cuda(), record_detections() as recs[dev]:
                res[dev] = {k: float(x) for k, x in
                            v(model=model.model, with_loss=with_loss).items()}
            cms[dev] = v.confusion_matrix.matrix
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
        if rec["ok"]:   # the plots' confusion matrix, through the pairing
            rec.update(compare_confusion(recs["cuda"], recs["cpu"], cms["cuda"],
                                         cms["cpu"], len(VAL_NAMES)))
            rec["ok"] = rec["cm_ok"]
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


# train_loop phase: YOLO(...).train() through the port's loop. Small: the
# flagship at LOOP_SMALL's size on the card and on the CPU from one seeded
# .npz, TF32 off, the default augmentation (made on the host from the same
# seeds, so both see the same batches), two epochs. Full: the flagship at
# b16/640 for two epochs with mosaic (close_mosaic=1), then resume=True for
# a third, then YOLO("best.npz") predicts one batch. Datasets: low-light
# .npy sidecars, longest side exactly imgsz (the card has no OpenCV: no
# image is resized).
LOOP_SMALL = {"n_train": 4, "n_val": 8, "imgsz": 128, "batch": 2,
              "shapes": [(96, 128), (128, 128), (128, 80)]}
LOOP_FULL = {"n_train": 64, "n_val": 16, "imgsz": 640, "batch": BATCH,
             "shapes": VAL_FULL["shapes"]}
# Card against CPU over two epochs of the small loop (4 micro-steps, 2 SGD
# updates), TF32 off, from one seeded .npz whose BN stats are set from the
# val images (calibrate_bn, as the val phase does; the val split is the val
# phase's small one, on which such a model finds a few labels, so that the
# metrics read more than 0). Up to the first update both sides see the
# same weights and batches. The first update itself is precise only to a
# few percent: 80% of its norm is the biases of layer 0's parameter CNN
# and of the first BN layers, whose gradients are sums over every pixel
# that mostly cancel, so the sum order moves them (the CPU at 8, 3 and 1
# threads against 4, from these seeds: 0.42%, 2.2% and 14% of the move's
# norm; PERF.md section 6). After it the task-aligned assigner turns that
# difference into another choice of positives: tools/assign_probe.py
# records the choices, counts the anchors assigned otherwise and the least
# margin of each call. The same loop on the CPU at one thread against the
# CPU at its default threads runs beside the card as the second witness.
# Bars:
# - the micro-steps before the first update: loss items within TRAIN_TOL's
#   one-step bar (same weights, same batches);
# - the state after the first update, against the CPU's: the norm of the
#   difference of the two moves within LOOP_MOVE_RTOL of the move's norm
#   (twice the one-thread CPU's reading: it sees a missing, doubled or
#   early update, not a small one; train_parity holds the step's math) and
#   BN stats within TRAIN_TOL's;
# - val after epoch 0 (the EMA after that update): each metric within
#   LOOP_METRIC_ATOL (the one-thread CPU read 1.2e-3; one label more or
#   less found in a class of 9 moves the mean recall by 1/27);
# - every micro-step after the first update: loss items within
#   LOOP_ITEMS_RTOL, a bar on size only (the one-thread CPU read 5.5e-2
#   with 62 anchors assigned otherwise). The second epoch's metrics follow
#   the weights apart and are reported, not held.
LOOP_MOVE_RTOL, LOOP_METRIC_ATOL, LOOP_ITEMS_RTOL = 0.3, 5e-3, 0.2


def loop_data(root, cfg, seed, val_seed):
    """A train and a val split of seeded low-light .npy sidecars."""
    train = val_dataset(root, cfg["n_train"], cfg["shapes"], seed, "train")
    val = val_dataset(root, cfg["n_val"], cfg["shapes"], val_seed, "val")
    return {**train, **val}


def seeded_npz(path, frames, imgsz):
    """The flagship's seeded weights, BN set from `frames` at imgsz, as a
    checkpoint (params, batch_stats, model_yaml): the warm start of every
    side of a comparison."""
    import torch
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from dedark_yolo_tpu_torch.utils.weights import state_dict_to_jax
    y = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
    calibrate_bn(torch, y.model, frames, imgsz)
    trees = state_dict_to_jax(y.state_dict(), y.model)
    save_checkpoint(path, params=trees["params"],
                    batch_stats=trees["batch_stats"], model_yaml=y.model.yaml)
    return str(path)


class count_val_calls:
    """Within the block, how often the trainer validated."""

    def __enter__(self):
        from dedark_yolo_tpu_torch.engine import trainer as T
        self.cls, self.fn, self.calls = T.DetectionTrainer, T.DetectionTrainer._validate, 0

        def counted(tr, state=None):
            self.calls += 1
            return self.fn(tr, state)
        self.cls._validate = counted
        return self

    def __exit__(self, *exc):
        self.cls._validate = self.fn


class train_steps:
    """Within the block, every DetectionTrainer.step call: its host ms, its
    loss items, and on CUDA the device span of its work (CUDA events
    before and after the call, read after the run). With `snapshot`, the
    model's state and EMA on the CPU before the first step ("start") and
    after the step that made the first update ("first_update")."""

    def __init__(self, torch, snapshot=False):
        self.torch, self.snapshot = torch, snapshot

    def __enter__(self):
        from dedark_yolo_tpu_torch.engine import trainer as T
        self.cls, self.fn = T.DetectionTrainer, T.DetectionTrainer.step
        self.host, self.items, self.events = [], [], []
        self.states = {}
        torch = self.torch

        def keep(tr, name):
            if self.snapshot and name not in self.states:
                cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
                self.states[name] = (cpu(tr.model.state_dict()), cpu(tr.ema))

        def timed(tr, batch, step_index):
            keep(tr, "start")
            cuda = tr.device.type == "cuda"
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            out = self.fn(tr, batch, step_index)
            self.host.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                ev[1].record()
                self.events.append(ev)
            self.items.append(out[1].detach())
            if tr.opt_state.step == 1:
                keep(tr, "first_update")
            return out
        self.cls.step = timed
        return self

    def __exit__(self, *exc):
        self.cls.step = self.fn

    def device_ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def item_list(self):
        return [[float(x) for x in it.cpu()] for it in self.items]


def loop_rows(run):
    import csv
    with open(Path(run) / "results.csv") as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def loop_run(torch, npz, kw, dev, name, threads=None):
    """One YOLO(npz).train(**kw) on `dev` (the CPU at `threads` when
    given): its rows, trainer, val calls, per-step loss items, state
    snapshots, assigner record and launches (on the card)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools import assign_probe
    prev = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        y = YOLO(npz, device=dev)
        zero_launches()
        with no_plain_on_cuda(), count_val_calls() as vc, \
                train_steps(torch, snapshot=True) as st, \
                assign_probe.record() as calls:
            y.train(**kw, device=dev, name=name)
        if dev == "cuda":
            torch.cuda.synchronize()
    finally:
        torch.set_num_threads(prev)
    return {"rows": loop_rows(y.trainer.save_dir), "trainer": y.trainer,
            "val_calls": vc.calls, "items": st.item_list(),
            "states": st.states, "assign": calls,
            "launches": dict(_build.LAUNCHES) if dev == "cuda" else None}


def state_errors(a, b, start):
    """The state (model state_dict, EMA) of run a against run b's: the
    norm of the difference of the two moves from `start` over all params
    (and over the EMA) as a share of the norm of b's move, and the BN
    stats' largest absolute error."""
    out = {"bn_stats_abs_err": 0.0}
    for name, mine, theirs, begin in zip(("params", "ema"), a, b, start):
        diff = moved = 0.0
        for k, w in theirs.items():
            if not w.is_floating_point():
                continue
            if "running_" in k:
                out["bn_stats_abs_err"] = max(out["bn_stats_abs_err"],
                                              float((mine[k] - w).abs().max()))
                continue
            diff += float(((mine[k] - w) ** 2).sum())
            moved += float(((w - begin[k]) ** 2).sum())
        out[f"{name}_move_norm_rel_err"] = (diff / moved) ** 0.5 if moved else 0.0
    return out


def loop_compare(a, b):
    """Readings of run a against run b: per micro-step the loss items'
    relative error, the anchors assigned otherwise and b's least margins;
    per epoch the loss rows' and val metrics' errors; the state after the
    first update."""
    from dedark_yolo_tpu_torch.tools import assign_probe
    ra, rb = a["rows"], b["rows"]
    loss_keys = [k for k in rb[0] if k.endswith("_loss")]
    metric_keys = [k for k in rb[0] if k.startswith("metrics/")]
    return {"step_items_rel_err": [max(abs(x - y) / abs(y) for x, y in zip(xs, ys))
                                   for xs, ys in zip(a["items"], b["items"])],
            "step_assign_flips": assign_probe.flips(a["assign"], b["assign"]),
            "step_topk_margin": [c["topk"] for c in b["assign"]],
            "step_claim_margin": [c["claim"] for c in b["assign"]],
            "epoch_items_rel_err": [max(abs(x[k] - y[k]) / abs(y[k])
                                        for k in loss_keys)
                                    for x, y in zip(ra, rb)],
            "epoch_metric_abs_err": [max(abs(x[k] - y[k]) for k in metric_keys)
                                     for x, y in zip(ra, rb)],
            "metrics": [{k: y[k] for k in metric_keys} for y in rb],
            "first_update": state_errors(a["states"]["first_update"],
                                         b["states"]["first_update"],
                                         b["states"]["start"])}


def loop_small(torch, tmp):
    """Two epochs of the flagship at LOOP_SMALL on the card, on the CPU,
    and on the CPU at one thread, from one seeded .npz (BN set from the val
    images), TF32 off, the default augmentation: the card against the CPU
    held to the bars above, the one-thread CPU against the CPU reported
    beside them; the card run's launches fused_enhance = micro-steps + val
    batches and nms = val batches."""
    from dedark_yolo_tpu_torch.tools.c14_split import TRAIN_TOL
    cfg = LOOP_SMALL
    data = loop_data(tmp / "small", cfg, SEED + 2, SEED)
    npz = seeded_npz(tmp / "small_seed.npz",
                     val_images(data, cfg["n_val"]), cfg["imgsz"])
    kw = {"data": data, "imgsz": cfg["imgsz"], "batch": cfg["batch"],
          "epochs": 2, "nbs": 4, "optimizer": "SGD", "cache": "disk",
          "workers": 4, "matmul_precision": "float32", "verbose": False,
          "project": str(tmp / "runs")}
    g = loop_run(torch, npz, kw, "cuda", "small_cuda")
    c = loop_run(torch, npz, kw, "cpu", "small_cpu")
    c1 = loop_run(torch, npz, kw, "cpu", "small_cpu1", threads=1)
    gt, ct = g["trainer"], c["trainer"]
    micro = sum(e["batches"] for e in gt.epoch_stats)
    val_batches = g["val_calls"] * -(-cfg["n_val"] // cfg["batch"])
    check_launches("train_loop small", g["launches"],
                   {"fused_enhance": micro + val_batches, "nms": val_batches})
    card = loop_compare(g, c)
    n = gt.accumulate
    err = card["step_items_rel_err"]
    first, after = max(err[:n]), max(err[n:])
    fu = card["first_update"]
    out = {"imgsz": cfg["imgsz"], "batch": cfg["batch"], "epochs": 2,
           "n_train": cfg["n_train"], "n_val": cfg["n_val"],
           "micro_steps": micro, "updates": gt.ema_updates,
           "val_calls": g["val_calls"], "launches": g["launches"],
           "threads": torch.get_num_threads(),
           "rows_cuda": g["rows"], "rows_cpu": c["rows"],
           "step_items_cuda": g["items"], "step_items_cpu": c["items"],
           "card_vs_cpu": card, "cpu1_vs_cpu": loop_compare(c1, c),
           "first_window_max_rel_err": first, "after_max_rel_err": after,
           "tol": {"first_window_items_rel": TRAIN_TOL["items_rel"],
                   "move_norm_rel": LOOP_MOVE_RTOL,
                   "stats_abs": TRAIN_TOL["stats_abs"],
                   "epoch0_metric_abs": LOOP_METRIC_ATOL,
                   "after_items_rel": LOOP_ITEMS_RTOL},
           "transferred": gt.transferred}
    out["ok"] = (len(g["rows"]) == len(c["rows"]) == 2
                 and len(err) == micro == gt.ema_updates * n
                 and first <= TRAIN_TOL["items_rel"]
                 and fu["params_move_norm_rel_err"] <= LOOP_MOVE_RTOL
                 and fu["ema_move_norm_rel_err"] <= LOOP_MOVE_RTOL
                 and fu["bn_stats_abs_err"] <= TRAIN_TOL["stats_abs"]
                 and card["epoch_metric_abs_err"][0] <= LOOP_METRIC_ATOL
                 and after <= LOOP_ITEMS_RTOL
                 and gt.ema_updates == ct.ema_updates == 2
                 and gt.transferred == ct.transferred
                 and gt.transferred[0] == gt.transferred[1])
    return out


def loop_full(torch, tmp):
    """yolov8l nc 3 at b16/640 (f32, TF32 on): two epochs with mosaic and
    close_mosaic=1, then resume=True for a third, each run's launches
    counted (fused_enhance = micro-steps + val batches, nms = val
    batches); then YOLO("best.npz") predicts one batch."""
    import numpy as np
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools._ab import CLOCKS_QUERY, nvidia_smi
    cfg = LOOP_FULL
    data = loop_data(tmp / "full", cfg, SEED + 4, SEED + 5)
    kw = {"data": data, "imgsz": cfg["imgsz"], "batch": cfg["batch"],
          "cache": "disk", "close_mosaic": 1, "verbose": False,
          "project": str(tmp / "runs"), "name": "full", "workers": 8}
    val_batches = -(-cfg["n_val"] // cfg["batch"])
    out = {"model": "yolov8l.yaml", "nc": 3, **{k: cfg[k] for k in
           ("n_train", "n_val", "imgsz", "batch")}, "runs": []}
    y = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    for epochs, resume in ((2, False), (3, True)):
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        with no_plain_on_cuda(), count_val_calls() as vc, \
                train_steps(torch) as st:
            t0 = time.perf_counter()
            y.train(**kw, epochs=epochs, resume=resume)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        tr = y.trainer
        stats = tr.epoch_stats
        micro = sum(e["batches"] for e in stats)
        check_launches(f"train_loop epochs={epochs}", launches,
                       {"fused_enhance": micro + vc.calls * val_batches,
                        "nms": vc.calls * val_batches})
        rows = loop_rows(tr.save_dir)
        wdir = tr.wdir
        run = {"epochs": epochs, "resume": resume,
               "start_epoch": stats[0]["epoch"], "seconds": secs,
               "epoch_stats": stats,
               "images_per_s": [e["batches"] * cfg["batch"] / e["train_s"]
                                for e in stats],
               "loader_wait_ms_per_batch": [1e3 * e["loader_wait_s"] / e["batches"]
                                            for e in stats],
               "step_host_ms": st.host, "step_device_ms": st.device_ms(),
               "accumulate": tr.accumulate, "optimizer": tr.opt_name,
               "updates": tr.ema_updates, "val_calls": vc.calls,
               "rows": rows, "launches": launches,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "files": sorted(p.name for p in wdir.iterdir()),
               "last_npz_mib": (wdir / "last.npz").stat().st_size / 2 ** 20,
               "nvidia_smi": nvidia_smi(CLOCKS_QUERY)}
        losses = [r[k] for r in rows for k in r if k.endswith("_loss")]
        if not (all(np.isfinite(losses)) and len(rows) == epochs
                and run["start_epoch"] == (2 if resume else 0)
                and {"last.npz", "best.npz"} <= set(run["files"])
                and (tr.save_dir / "args.yaml").is_file()):
            raise AssertionError(f"train_loop: {run}")
        out["runs"].append(run)
    best = YOLO(str(wdir / "best.npz"))
    frames = synthetic_frames(BATCH)
    zero_launches()
    with no_plain_on_cuda():
        res = best.predict(frames, imgsz=cfg["imgsz"], batch=BATCH, conf=CONF)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check_launches("train_loop best.npz predict", launches,
                   {"fused_enhance": 1, "nms": 1})
    out["best_predict"] = {"images": len(res), "launches": launches,
                           "boxes": int(sum(len(r.boxes) for r in res))}
    return out


def phase_train_loop(torch):
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        small = loop_small(torch, tmp)
        full = loop_full(torch, tmp)
    emit({"phase": "train_loop", "small": small, "full": full})
    if not small["ok"]:
        raise AssertionError(f"train_loop: card and CPU disagree: {small}")
    return full


# c10 phase: the tiny test architecture (tests/tiny_model.yaml, written
# here as JSON: the card has no PyYAML) at an image side no earlier phase
# used, so that val builds the shape-keyed caches first, under its
# inference mode; then train at the same side (ROADMAP C10).
TINY_ARCH = {
    "nc": 3, "scales": {"n": [0.33, 0.25, 1024]},
    "backbone": [[-1, 1, "lowlight_recovery", [3]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "C2f", [64, True]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "SPPF", [128, 5]]],
    "head": [[-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 5], 1, "Concat", [1]], [-1, 1, "C2f", [64]],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 4], 1, "Concat", [1]], [-1, 1, "C2f", [64]],
             [[13, 10, 7], 1, "Detect", ["nc"]]]}
C10 = {"n_train": 4, "n_val": 4, "imgsz": 96, "batch": 2,
       "shapes": [(96, 96), (72, 96)]}


def phase_c10(torch):
    """YOLO(tiny).val() and then .train() for two micro-steps at the same
    imgsz in this process on the card: the step must not raise, and the
    anchors val cached must not be inference tensors; fused_enhance once a
    val batch and a micro-step, nms once a val batch."""
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops.anchors import make_anchors
    cfg = C10
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = loop_data(tmp / "data", cfg, SEED + 30, SEED + 31)
        arch = tmp / "tiny.json"
        arch.write_text(json.dumps(TINY_ARCH))
        y = YOLO(str(arch), seed=SEED)
        kw = {"data": data, "imgsz": cfg["imgsz"], "batch": cfg["batch"],
              "cache": "disk", "workers": 2, "verbose": False}
        zero_launches()
        with no_plain_on_cuda():
            metrics = y.val(**kw)
            feats = [(cfg["imgsz"] // s,) * 2 for s in y.model.strides]
            cached = make_anchors(feats, y.model.strides, 0.5, "cuda")
            with train_steps(torch) as st:
                y.train(**kw, epochs=1, nbs=cfg["batch"], mosaic=0.0,
                        val=False, save=False, project=str(tmp / "runs"))
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    val_batches = -(-cfg["n_val"] // cfg["batch"])
    micro = len(st.items)
    items = st.item_list()
    rec = {"imgsz": cfg["imgsz"], "val_batches": val_batches,
           "micro_steps": micro, "step_items": items,
           "val_fitness": float(metrics["fitness"]),
           "anchors_inference": [t.is_inference() for t in cached],
           "launches": launches}
    emit({"phase": "c10", **rec})
    check_launches("c10", launches, {"fused_enhance": val_batches + micro,
                                     "nms": val_batches})
    import math
    if not (micro == 2 and not any(rec["anchors_inference"])
            and all(math.isfinite(x) for it in items for x in it)):
        raise AssertionError(f"c10: {rec}")
    return rec


# train_amp phase: bf16 training (amp=True) of the flagship at b16/640. At
# the same weights and batch the bf16 loss items are held to the f32 ones
# within AMP_ITEMS_RTOL of each item: tests/test_torch_amp.py's yardstick
# is the JAX package's own bf16-vs-f32 gap, which on the CPU test's tiny
# model reads 0.19 of items near 4.5, 162 and 2.8 (4.3% of the box item).
AMP_ITEMS_RTOL = 0.05


def phase_train_amp(torch, f32):
    """yolov8l nc 3, b16/640: the loss items of amp=True against f32 (TF32
    off) at the same weights and batch; then amp=True training as
    train_full (default precision): a warm-up window and two timed
    windows, fused_enhance once a micro-step, each on a bf16 image; the
    masters, the EMA and the BN stats f32 after. `f32` is train_full's
    record of this call, printed beside."""
    from dedark_yolo_tpu_torch.tools.c14_split import train_batch
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
    from dedark_yolo_tpu_torch.tools._ab import CLOCKS_QUERY, nvidia_smi
    yolo = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    start = {k: v.clone() for k, v in yolo.state_dict().items()}
    batches = [train_batch(BATCH, IMGSZ, SEED + i) for i in range(3)]
    items = {}
    with matmul_precision("float32"):
        for amp in (False, True):
            tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64,
                                               "amp": amp}, nb=1000)
            tr.model.train()
            with torch.no_grad():
                items[amp] = torch.stack(list(tr.loss(tr.to_device(
                    batches[0]))[1])).float().cpu()
            tr.model.eval()
            yolo.model.load_state_dict(start)
    rel = ((items[True] - items[False]).abs() / items[False].abs()).tolist()

    dtypes = []
    fused = K.fused_enhance

    def recorded(img, *args):
        dtypes.append(str(img.dtype))
        return fused(img, *args)
    tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64, "amp": True},
                          nb=1000)
    K.fused_enhance = recorded
    try:
        with matmul_precision("default"), no_plain_on_cuda():
            for i in range(tr.accumulate):                   # warm-up window
                tr.step(batches[i % 3], i)
            torch.cuda.synchronize()
            zero_launches()
            dtypes.clear()
            torch.cuda.reset_peak_memory_stats()
            windows_ms, step_items = [], []
            for w in range(2):
                t0 = time.perf_counter()
                for j in range(tr.accumulate):
                    i = tr.accumulate * (w + 1) + j
                    step_items.append(tr.step(batches[i % 3], i)[1])
                torch.cuda.synchronize()
                windows_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(_build.LAUNCHES)
    finally:
        K.fused_enhance = fused
    peak = torch.cuda.max_memory_allocated()
    step_items = torch.stack(step_items).cpu()
    micro = len(step_items)
    f32_dtypes = {str(v.dtype) for d in (tr.model.state_dict(), tr.ema,
                                         tr.opt_state.buf, tr.opt_state.buf2,
                                         tr.opt_state.acc) for v in d.values()
                  if v.is_floating_point()}
    rec = {"model": "yolov8l.yaml", "nc": 3, "batch": BATCH, "imgsz": IMGSZ,
           "items_f32": items[False].tolist(), "items_bf16": items[True].tolist(),
           "items_rel_err": rel, "tol_rel": AMP_ITEMS_RTOL,
           "optimizer": tr.opt_name, "accumulate": tr.accumulate,
           "micro_steps": micro, "window_ms": windows_ms,
           "micro_step_ms": sum(windows_ms) / micro,
           "images_per_s": BATCH * micro / (sum(windows_ms) / 1e3),
           "peak_memory_gib": peak / 2 ** 30,
           "f32": {k: f32[k] for k in ("micro_step_ms", "images_per_s",
                                       "peak_memory_gib")},
           "loss_items": step_items.tolist(),
           "finite": bool(torch.isfinite(step_items).all()),
           "enhance_image_dtypes": sorted(set(dtypes)),
           "enhance_calls": len(dtypes), "state_dtypes": sorted(f32_dtypes),
           "launches": launches, "nvidia_smi": nvidia_smi(CLOCKS_QUERY)}
    emit({"phase": "train_amp", **rec})
    check_launches("train_amp", launches, {"fused_enhance": micro})
    if not (rec["finite"] and max(rel) <= AMP_ITEMS_RTOL
            and dtypes == ["torch.bfloat16"] * micro
            and f32_dtypes == {"torch.float32"}):
        raise AssertionError(f"train_amp: {rec}")
    return rec


def phase_cli(torch):
    """`python -m dedark_yolo_tpu_torch val model=<npz> data=<json>` in a
    subprocess (the flagship at 128, BN set from the val images), its
    printed metrics against YOLO(npz).val() here under the subprocess's
    TF32 defaults (cuDNN on, matmuls off); then `train ... epochs=1` on 4
    train images. Both must exit 0."""
    import os
    import subprocess
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    cfg = {**LOOP_SMALL, "n_train": 4}
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT),
                                          os.environ.get("PYTHONPATH", "")])}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = loop_data(tmp / "cli", cfg, SEED + 40, SEED)
        data_json = tmp / "cli" / "data.json"
        data_json.write_text(json.dumps(data))
        npz = seeded_npz(tmp / "cli_seed.npz", val_images(data, cfg["n_val"]),
                         cfg["imgsz"])
        common = [f"model={npz}", f"data={data_json}", f"imgsz={cfg['imgsz']}",
                  "cache=disk", "workers=2", "verbose=False"]
        cmds = {"val": ["val", *common, "batch=4"],
                "train": ["train", *common, "epochs=1", f"batch={cfg['batch']}",
                          f"project={tmp / 'runs'}", "name=cli"]}
        for key, args in cmds.items():
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "dedark_yolo_tpu_torch",
                                *args], capture_output=True, text=True,
                               cwd=str(ROOT), env=env, timeout=600)
            lines = [ln for ln in p.stdout.splitlines()
                     if ln.startswith("results ")]
            out[key] = {"rc": p.returncode,
                        "seconds": time.perf_counter() - t0,
                        "results": json.loads(lines[-1][8:]) if lines else None}
            if p.returncode or not lines:
                raise AssertionError(f"cli {key}: rc {p.returncode}\n"
                                     f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with no_plain_on_cuda():
                want = YOLO(npz).val(data=str(data_json), imgsz=cfg["imgsz"],
                                     batch=4, cache="disk", workers=2,
                                     verbose=False)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        best = (tmp / "runs" / "cli" / "weights" / "best.npz").is_file()
    got = out["val"]["results"]
    err = {k: abs(got[k] - float(v)) / max(abs(float(v)), 1e-12)
           for k, v in want.items()}
    rec = {**out, "facade_val": {k: float(v) for k, v in want.items()},
           "val_rel_err": err, "tol_rel": VAL_METRIC_RTOL,
           "train_best_npz": best}
    emit({"phase": "cli", **rec})
    if not (set(got) == set(want) and max(err.values()) <= VAL_METRIC_RTOL
            and want["metrics/mAP50(B)"] > 0 and best):
        raise AssertionError(f"cli: {rec}")
    return rec


# predict_resize, val_resize, loop_mp, autobatch: frames and sidecars that
# need a resize, letterboxed by the native library (predict) or resized by
# data/imgops.py (the datasets), with cv2 blocked (`no_cv2`); the loader's
# process workers with the profiler's trace of one step; batch=-1.
RESIZE_SHAPES = [(1080, 1920), (768, 1024), (721, 1280), (1000, 1500)]
VAL_RESIZE = {"n": 6, "batch": 4, "shapes": [(720, 1280), (1080, 1920),
                                             (300, 500)]}
# the card-vs-CPU pairing of predict_resize runs at a conf between two of
# the card's scores that lie far apart (pair_conf), so that neither side's
# list is cut at max_det or at a score the other side rounds across
PAIR_RANKS, MAX_DET = (20, 100), 300
# val_resize holds the card's mAP50 and mAP50-95 to the CPU's within
# VAL_METRIC_RTOL (they read the scores only through their order) and P
# and R within VAL_RESIZE_PR_RTOL: these read each score through a linear
# interpolation on the conf grid, so the card's score error (5.0e-5 at 640,
# H100 80GB HBM3, 700 W) moves them by its product with the local slope,
# which with 0-3 detections an image read 1.3e-5 of P.
VAL_RESIZE_PR_RTOL = 1e-3
LOOP_MP = {"n_train": 64, "n_val": 16, "imgsz": 640, "batch": BATCH,
           "shapes": [(720, 1280), (1080, 1920), (768, 1024), (1000, 1500)]}


class no_cv2:
    """Within the block, `import cv2` fails (the card's host has none; a
    path that reached for it would fail there too)."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2", False)
        sys.modules["cv2"] = None
        return self

    def __exit__(self, *exc):
        if self.saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = self.saved


def lowlight_frames(shapes, n, seed):
    """n seeded low-light BGR frames of the (h, w) shapes in turns (blocks
    of 32 px, as synthetic_frames)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        h, w = shapes[k % len(shapes)]
        base = rng.integers(0, 256, (-(-h // 32), -(-w // 32), 3)) / 255
        img = np.kron(base, np.ones((32, 32, 1)))[:h, :w]
        img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
        out.append((img ** DARK_PARAM * 255).astype(np.uint8))
    return out


def letterbox_ms(frames, reps=5):
    """Median host ms of one native letterbox_batch call over `frames`."""
    import numpy as np
    from dedark_yolo_tpu_torch import native
    ms = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        native.letterbox_batch(frames, IMGSZ, fill=114, swap_rb=True)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:]))


def pair_conf(res):
    """The conf midway across the widest gap between two consecutive
    scores of a card result (at a low conf) among ranks PAIR_RANKS."""
    import numpy as np
    s = np.sort(np.asarray(res.boxes.conf))[::-1]
    lo, hi = PAIR_RANKS
    if len(s) <= lo:
        raise AssertionError(f"predict_resize: {len(s)} detections to pair")
    gaps = s[lo - 1:min(hi, len(s)) - 1] - s[lo:min(hi, len(s))]
    k = lo - 1 + int(np.argmax(gaps))
    return float((s[k] + s[k + 1]) / 2)


def pair_results(g, c, box_tol=BOX_TOL_PX, score_tol=SCORE_TOL):
    """Each CPU detection of one image paired with a card detection of the
    same class, box within box_tol and score within score_tol; (box
    errors, score errors) or None. g and c are Results or (k, 6) arrays
    (x1, y1, x2, y2, conf, cls)."""
    import numpy as np
    g, c = (np.asarray(r.boxes.data if hasattr(r, "boxes") else r)
            for r in (g, c))
    gb, gs, gc = g[:, :4], g[:, 4], g[:, 5]
    free, box_err, score_err = list(range(len(gc))), [], []
    for i in range(len(c)):
        for j in free:
            db = float(np.abs(gb[j] - c[i, :4]).max())
            ds = abs(float(gs[j] - c[i, 4]))
            if gc[j] == c[i, 5] and db <= box_tol and ds <= score_tol:
                free.remove(j)
                box_err.append(db)
                score_err.append(ds)
                break
        else:
            return None
    return box_err, score_err


def phase_predict_resize(torch, yolo, pred, frames640):
    """Flagship predict at b16/640 f32 on 16 frames of four sizes that
    need a resize (the native letterbox), with cv2 blocked, BN set from
    these frames: 4 timed batches, fused_enhance and nms once a batch,
    beside the predict phase's 480x640 f32 run of this call; then one
    721x1280 frame on the card (TF32 off) against the port on the CPU."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    frames = lowlight_frames(RESIZE_SHAPES, BATCH, SEED + 50)
    reps = 4
    kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, half=False)
    with no_cv2():
        # BN from these frames, as the predict phase's from its own (set
        # from the 480x640 frames, most scores of these saturate)
        calibrate_bn(torch, yolo.model, frames)
        yolo.predict(frames, **kw)                   # warm-up batch
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_on_cuda():
            res = yolo.predict(frames * reps, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        speed = dict(yolo.predictor.speed)
        lb = {"resize": letterbox_ms(frames), "480x640": letterbox_ms(frames640)}
        one = frames[2]                              # 721x1280
        pair_kw = dict(imgsz=IMGSZ, batch=1, matmul_precision="float32")
        conf = pair_conf(yolo.predict([one], conf=0.001, **pair_kw)[0])
        pair_kw["conf"] = conf
        gpu = yolo.predict([one], **pair_kw)[0]
        cpu_model = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   yolo.state_dict().items()})
        cpu = cpu_model.predict([one], device="cpu", **pair_kw)[0]
    check_launches("predict_resize", launches,
                   {"fused_enhance": reps, "nms": reps})
    counts = [len(r) for r in res]
    pairs = pair_results(gpu, cpu) if len(gpu) == len(cpu) else None
    rec = {"phase": "predict_resize", "frames": [list(s) for s in RESIZE_SHAPES],
           "batch": BATCH, "imgsz": IMGSZ, "images": len(res),
           "seconds": secs, "images_per_s": len(res) / secs,
           "speed_ms_per_image": speed,
           "native_letterbox_ms_per_batch": lb,
           "beside_480x640": {"images_per_s": pred["f32"]["images_per_s"],
                              "speed_ms_per_image": pred["f32"]["stage_ms"]},
           "launches": launches, "dets_per_image": [min(counts), max(counts)],
           "orig_shapes_ok": all(r.orig_shape == f.shape[:2]
                                 for r, f in zip(res, frames * reps)),
           "cpu_pair": {"frame": list(one.shape[:2]), "conf": conf,
                        "gpu_count": len(gpu),
                        "cpu_count": len(cpu), "paired": pairs is not None,
                        "box_max_abs_err_px": max(pairs[0], default=0.0)
                        if pairs else None,
                        "score_max_abs_err": max(pairs[1], default=0.0)
                        if pairs else None,
                        "box_tol_px": BOX_TOL_PX, "score_tol": SCORE_TOL}}
    emit(rec)
    if not (max(counts) > 0 and rec["orig_shapes_ok"]
            and 0 < len(cpu) < MAX_DET and pairs is not None):
        raise AssertionError(f"predict_resize: {rec}")
    return rec


class record_loads:
    """Within the block, a digest of every image the datasets load (after
    the max-side resize), in call order."""

    def __enter__(self):
        import hashlib
        from dedark_yolo_tpu_torch.data import dataset as D
        self.cls, self.fn, self.digests = D.YOLODataset, D.YOLODataset.__call__, []

        def call(ds, index, imgsz=None):
            s = self.fn(ds, index, imgsz)
            self.digests.append((index, s.img.shape,
                                 hashlib.sha256(s.img.tobytes()).hexdigest()))
            return s
        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.fn


def val_pair_conf(scores, keep=150):
    """A val conf for the card-vs-CPU pairing from the card's per-image
    scores at the default conf: at most `keep` detections an image above
    it (no list cut at max_det), midway across the widest gap between two
    consecutive scores of all images pooled above that floor (no score
    within the card's error of it)."""
    import numpy as np
    floor = max((float(np.sort(x)[::-1][keep - 1]) for x in scores
                 if len(x) >= keep), default=0.001)
    pool = np.sort(np.concatenate([x[x >= floor] for x in scores]))[::-1]
    if len(pool) < 2:
        return floor
    k = int(np.argmax(pool[:-1] - pool[1:]))
    return float((pool[k] + pool[k + 1]) / 2)


def phase_val_resize(torch, yolo):
    """Val of sidecars of 720x1280, 1080x1920 and 300x500 (each resized
    max-side by data/imgops.py, the 720x1280 one at 2x down to 640) at 128
    and 640, cv2 blocked, BN set from the images: the card at the val
    defaults (conf 0.001), then the card (TF32 off) against the CPU image
    by image and by metrics as val_parity does (P and R to
    VAL_RESIZE_PR_RTOL), at a conf that leaves
    each image's list short of max_det (val_pair_conf: a random-weight
    flagship at 640 fills max_det on every image, and where the list is
    cut the two sides may keep other detections); the images the dataset
    loaded equal in all runs."""
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.cfg import get_cfg
    from dedark_yolo_tpu_torch.engine.validator import DetectionValidator
    from dedark_yolo_tpu_torch.ops import _build
    cfg = VAL_RESIZE
    batches = -(-cfg["n"] // cfg["batch"])
    out = {"shapes": [list(s) for s in cfg["shapes"]], "n": cfg["n"],
           "batch": cfg["batch"]}
    ok, total = True, {}
    with tempfile.TemporaryDirectory() as tmp, no_cv2():
        data = val_dataset(Path(tmp) / "rs", cfg["n"], cfg["shapes"], SEED + 60)
        cpu = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
        for imgsz in (128, 640):
            calibrate_bn(torch, yolo.model, val_images(data, cfg["n"]), imgsz)
            cpu.load_state_dict({k: v.cpu() for k, v in yolo.state_dict().items()})
            kw = {"data": data, "imgsz": imgsz, "batch": cfg["batch"],
                  "cache": "disk", "matmul_precision": "float32",
                  "verbose": False}
            res, recs, loads, secs = {}, {}, {}, {}
            for run, dev, model in (("default", "cuda", yolo),
                                    ("cuda", "cuda", yolo), ("cpu", "cpu", cpu)):
                if run == "cuda":
                    kw["conf"] = val_pair_conf(
                        [d[3] for d in recs["default"].detections()])
                v = DetectionValidator(args=get_cfg({**kw, "device": dev}))
                zero_launches()
                t0 = time.perf_counter()
                with no_plain_on_cuda(), record_detections() as recs[run], \
                        record_loads() as loads[run]:
                    res[run] = {k: float(x) for k, x in v(model=model.model).items()}
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches = dict(_build.LAUNCHES)
                    check_launches(f"val_resize {imgsz} {run}", launches,
                                   {"fused_enhance": batches, "nms": batches})
                    for k, n in launches.items():
                        total[k] = total.get(k, 0) + n
                secs[run] = time.perf_counter() - t0
            g, c = res["cuda"], res["cpu"]
            rec = {"default_conf": {"results": res["default"],
                                    "dets_per_image": [
                                        min(recs["default"].counts),
                                        max(recs["default"].counts)]},
                   "pair_conf": kw["conf"], "cuda": g, "cpu": c,
                   "seconds": secs, "launches": launches,
                   **compare_images(recs["cuda"], recs["cpu"]),
                   "metric_max_rel_err": max(abs(g[k] - c[k]) / abs(c[k])
                                             if c[k] else abs(g[k])
                                             for k in METRICS),
                   "loaded": sorted(loads["cuda"].digests),
                   "loads_equal": all(sorted(x.digests) == sorted(
                       loads["cpu"].digests) for x in loads.values())}
            rec["loaded_sides"] = sorted({max(s[:2]) for _, s, _ in rec["loaded"]})
            rec["ok"] = (rec["ok"] and rec["images"][1] == cfg["n"]
                         and rec["metric_max_rel_err"] <= VAL_RESIZE_PR_RTOL
                         and all(abs(g[k] - c[k]) <= VAL_METRIC_RTOL * abs(c[k])
                                 for k in METRICS[2:])
                         and rec["loads_equal"]
                         and rec["loaded_sides"] == [imgsz])
            out[str(imgsz)] = rec
            ok = ok and rec["ok"]
    out["launches"] = total
    emit({"phase": "val_resize", **out})
    if not ok:
        raise AssertionError(f"val_resize: card and CPU disagree: {out}")
    return out


# darkset phase: the fork's data path (its offline tools, ROADMAP A13).
# Clean frames of three resolution groups go through the low-light maker's
# core on the card, at JAX's default exponent 7.5 and at 5; the 7.5 frames
# become the dark val split that the packaged card `tielu.yaml` names
# (`images/test_dark`), beside the clean frames as `images/train`, in a
# directory laid out so that the card's relative `path` finds them; then
# autosplit, calc_dataset_info and DatasetStats count it, and the flagship
# validates on it with plots=True and with plots=False. A label file is
# left out for every LABELLESS-th frame, so that autosplit's annotated_only
# and the unlabelled counts read something.
DARKSET = {"shapes": [(480, 640), (720, 1280), (1080, 1920)], "per_shape": 16,
           "batch": BATCH, "imgsz": IMGSZ, "params": (7.5, 5.0),
           "split_param": 7.5, "labelless": 8, "reps": 3}
DARKSET_NAMES = {0: "person", 1: "debrisflow", 2: "rockfall"}   # tielu.yaml's
VAL_PLOTS = ["F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
             "confusion_matrix.png"]


def darkset_frames():
    """The phase's clean uint8 frames, `per_shape` of each shape in turn of
    groups, and their label rows (None for a frame left without a label
    file)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 90)
    frames, rows = [], []
    for h, w in DARKSET["shapes"]:
        for _ in range(DARKSET["per_shape"]):
            img, r = scene(rng, h, w)
            frames.append((img * 255).astype(np.uint8))
            rows.append(None if len(rows) % DARKSET["labelless"]
                        == DARKSET["labelless"] - 1 else r)
    return frames, rows


def maker_core(torch, frames):
    """lowlight_batches on the card at each exponent: the 256-level lookup
    against the CPU's (equal at every level; a level that differs may
    differ by one only, and is listed), every frame equal to the card's
    lookup of its input, the integer exponent's frames bit-equal to the
    CPU's; and each resolution group's images/s over `reps` calls
    (upload, degrade, quantise, readback) with the CUDA-event span of each
    call, and one batch's stages apart. Returns (the record, the card's
    frames at `split_param`)."""
    import numpy as np
    from dedark_yolo_tpu_torch.engine.predictor import resolve_device
    from dedark_yolo_tpu_torch.utils.lowlight_process import (degrade_u8,
                                                              lowlight_batches)
    levels = np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16, 1), 3, 2)
    n, b = DARKSET["per_shape"], DARKSET["batch"]
    out, dark = {"batch": b}, None
    for p in DARKSET["params"]:
        lut = {dev: lowlight_batches([levels], p, device=dev)[0].reshape(-1, 3)
               for dev in ("cuda", "cpu")}
        diff = lut["cuda"].astype(int) - lut["cpu"].astype(int)
        rec = {"levels_differ": sorted({int(i) for i in np.nonzero(diff)[0]}),
               "max_level_diff": int(np.abs(diff).max()),
               "lut_channels_equal": bool((lut["cuda"] == lut["cuda"][:, :1]).all())}
        card = lowlight_batches(frames, p, b)
        rec["frames_match_lut"] = all(np.array_equal(o, lut["cuda"][f, 0])
                                      for o, f in zip(card, frames))
        if float(p).is_integer():
            cpu = lowlight_batches(frames, p, b, device="cpu")
            rec["frames_bit_equal_cpu"] = all(np.array_equal(x, y)
                                              for x, y in zip(card, cpu))
            rec["ok"] = (rec["frames_bit_equal_cpu"] and not rec["levels_differ"])
        else:
            rec["ok"] = rec["max_level_diff"] <= 1
        rec["ok"] = rec["ok"] and rec["frames_match_lut"] and rec["lut_channels_equal"]
        rates = {}
        for g, (h, w) in enumerate(DARKSET["shapes"]):
            group = frames[g * n:(g + 1) * n]
            lowlight_batches(group, p, b)                    # warm-up
            host, span = [], []
            for _ in range(DARKSET["reps"]):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t0 = time.perf_counter()
                ev[0].record()
                lowlight_batches(group, p, b)
                ev[1].record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                span.append(ev[0].elapsed_time(ev[1]))
            # one batch by stages: the host's stack, then CUDA events
            # around the upload, degrade_u8 and the readback
            t0 = time.perf_counter()
            x = np.stack(group[:b])
            stack_ms = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x = torch.from_numpy(x).to(resolve_device(None))
            ev[1].record()
            y = degrade_u8(x, p)
            ev[2].record()
            y.cpu()
            ev[3].record()
            torch.cuda.synchronize()
            rates[f"{h}x{w}"] = {
                "images_per_s": n / (sum(host) / len(host) / 1e3),
                "call_ms": host, "device_span_ms": span,
                "stages_ms": {"stack": stack_ms,
                              **{k: ev[i].elapsed_time(ev[i + 1]) for i, k in
                                 enumerate(("upload", "degrade", "readback"))}}}
        rec["rates"] = rates
        out[str(p)] = rec
        if p == DARKSET["split_param"]:
            dark = card
    return out, dark


def label_stats(rows):
    """Independent counts of the phase's labels, parsed as the dataset
    reads them (f32): images with a label file; per class its instances,
    images and small/medium/large objects (relative area below 0.005,
    above 0.10)."""
    import numpy as np
    classes = {c: {"images": 0, "instances": 0, "small": 0, "medium": 0,
                   "large": 0} for c in range(len(DARKSET_NAMES))}
    for r in rows:
        lb = np.array([[float(x) for x in line.split()] for line in r or []],
                      np.float32).reshape(-1, 5)
        for c in {int(x) for x in lb[:, 0]}:
            classes[c]["images"] += 1
        for row in lb:
            k = classes[int(row[0])]
            k["instances"] += 1
            area = float(row[3] * row[4])
            k["small" if area < 0.005 else "large" if area > 0.10 else "medium"] += 1
    return {"labelled": sum(r is not None for r in rows), "classes": classes,
            "unlabelled": sum(not r for r in rows)}



def dataset_tools(rows):
    """autosplit (annotated_only and not), calc_dataset_info and
    DatasetStats on the dark split through the packaged card, each count
    against label_stats of the rows."""
    from dedark_yolo_tpu_torch.data.dataset import check_det_dataset
    from dedark_yolo_tpu_torch.data.split import autosplit
    from dedark_yolo_tpu_torch.data.stats import DatasetStats
    from dedark_yolo_tpu_torch.utils.dataset_info import calc_dataset_info
    want = label_stats(rows)
    d = check_det_dataset("tielu.yaml")
    rec = {"data": {k: d[k] for k in ("path", "train", "val", "nc")}}
    dark_dir = Path(d["val"])
    for only in (False, True):
        files = autosplit(dark_dir, (0.8, 0.2, 0.0), annotated_only=only, seed=SEED)
        listed = [len(f.read_text().splitlines()) if f.is_file() else 0
                  for f in files]
        rec[f"autosplit_annotated_only_{only}"] = listed
        rec["ok_autosplit_" + str(only)] = sum(listed) == (
            want["labelled"] if only else len(rows))
    info = calc_dataset_info("tielu.yaml", split="val")
    got = {c: info["classes"][DARKSET_NAMES[c]] for c in DARKSET_NAMES}
    rec["info"] = {"total_images": info["total_images"], "classes": got}
    rec["ok_info"] = (info["total_images"] == len(rows)
                      and got == want["classes"]
                      and (Path(d["path"]) / "dataset_status.json").is_file())
    st = DatasetStats("tielu.yaml").get_json()
    counts = {s: {"instances": st[s]["instance_stats"]["total"],
                  "images": st[s]["image_stats"]["total"],
                  "unlabelled": st[s]["image_stats"]["unlabelled"]}
              for s in ("train", "val")}
    instances = sum(c["instances"] for c in want["classes"].values())
    rec["stats"] = counts
    rec["ok_stats"] = all(c == {"instances": instances, "images": len(rows),
                                "unlabelled": want["unlabelled"]}
                          for c in counts.values()) and st["test"] is None
    rec["expected"] = want
    rec["ok"] = all(v for k, v in rec.items() if k.startswith("ok_"))
    return rec


def darkset_val(torch, yolo):
    """The flagship's val of the dark split (data='tielu.yaml', b16/640,
    f32, cache='disk') with plots=False, then plots=True: each run's
    launches (fused_enhance and nms once a batch), images/s and files; the
    two results dicts equal, and the plots=True run's confusion matrix
    equal to the one rebuilt from the plots=False run's detections."""
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.utils.plotting import matplotlib_available
    n = len(DARKSET["shapes"]) * DARKSET["per_shape"]
    batches = -(-n // DARKSET["batch"])
    kw = {"data": "tielu.yaml", "imgsz": DARKSET["imgsz"],
          "batch": DARKSET["batch"], "cache": "disk", "verbose": False}
    runs, recs = {}, {}
    for plots in (False, True):
        zero_launches()
        with no_plain_on_cuda(), record_detections() as recs[plots]:
            t0 = time.perf_counter()
            res = yolo.val(plots=plots, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check_launches(f"darkset val plots={plots}", launches,
                       {"fused_enhance": batches, "nms": batches})
        save_dir = yolo.validator.save_dir
        runs[plots] = {"results": {k: float(x) for k, x in res.items()},
                       "images": len(recs[plots].counts), "seconds": secs,
                       "images_per_s": len(recs[plots].counts) / secs,
                       "launches": launches,
                       "files": sorted(p.name for p in save_dir.iterdir())
                       if save_dir.is_dir() else [],
                       "cm": yolo.validator.confusion_matrix.matrix}
    mpl = matplotlib_available()
    cm = runs[True].pop("cm")
    runs[False].pop("cm")
    out = {"images": n, "batches": batches, "matplotlib": mpl,
           "plots_false": runs[False], "plots_true": runs[True],
           "results_equal": runs[True]["results"] == runs[False]["results"],
           "cm_equal_rebuilt": bool((cm == confusion_of(
               recs[False].detections(), recs[False].gts, len(DARKSET_NAMES))).all()),
           "cm_labels": float(cm[:, :len(DARKSET_NAMES)].sum()),
           "launches": {k: runs[False]["launches"][k] + runs[True]["launches"][k]
                        for k in runs[True]["launches"]}}
    out["ok"] = (out["results_equal"] and out["cm_equal_rebuilt"]
                 and runs[False]["files"] == []
                 and runs[True]["files"] == (VAL_PLOTS if mpl else [])
                 and all(r["images"] == n for r in runs.values()))
    return out


def phase_darkset(torch, yolo):
    """The fork's data path on the card (see DARKSET): clean frames, the
    maker's core, the dark split on disk, the tools' counts, the flagship's
    val of the split through the packaged card with and without plots.
    Runs with OpenCV blocked, in a temporary directory that is also the
    working directory of the val (its runs/ land there)."""
    import os
    import tempfile
    frames, rows = darkset_frames()
    maker, dark = maker_core(torch, frames)
    out = {"shapes": [list(s) for s in DARKSET["shapes"]],
           "per_shape": DARKSET["per_shape"], "maker": maker}
    with tempfile.TemporaryDirectory() as tmp, no_cv2():
        root = Path(tmp) / "datasets" / "tielu-yolo"
        for split, imgs in (("train", frames), ("test_dark", dark)):
            img_dir, lbl_dir = root / "images" / split, root / "labels" / split
            img_dir.mkdir(parents=True)
            lbl_dir.mkdir(parents=True)
            for k, (img, r) in enumerate(zip(imgs, rows)):
                write_sidecar(img_dir, lbl_dir, k, img, r)
        work = Path(tmp) / "work"
        work.mkdir()
        os.chdir(work)          # tielu.yaml's path is ../datasets/tielu-yolo
        try:
            out["tools"] = dataset_tools(rows)
            calibrate_bn(torch, yolo.model, dark[::3], DARKSET["imgsz"])
            out["val"] = darkset_val(torch, yolo)
        finally:
            os.chdir(ROOT)
    out["launches"] = out["val"]["launches"]
    out["ok"] = (all(out["maker"][str(p)]["ok"] for p in DARKSET["params"])
                 and out["tools"]["ok"] and out["val"]["ok"])
    emit({"phase": "darkset", **out})
    if not out["ok"]:
        raise AssertionError(f"darkset: {out}")
    return out


def idle_share(trace_path):
    """From a torch.profiler Chrome trace of one step: the step's window
    (first to last event of any kind), the union of the device's kernel,
    memcpy and memset intervals in it, and the idle share 1 - union /
    window."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    start, end = min(s for s, _ in spans), max(t for _, t in spans)
    busy, cur = 0.0, None
    for s, t in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    return {"window_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
            "device_kernels": len(dev),
            "idle_share": (1.0 - busy / (end - start)
                           if dev and end > start else None)}


def loop_mp_run(torch, data, tmp, name, processes):
    """One epoch of yolov8l at b16/640 from the seeded weights, the loader's
    8 workers threads or forked processes (then the profiler traces
    micro-step 2), cv2 blocked; its loader wait, step host ms and device
    spans, images/s, val, launches and trace."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    cfg = LOOP_MP
    y = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    zero_launches()
    with no_cv2(), no_plain_on_cuda(), count_val_calls() as vc, \
            train_steps(torch) as st:
        t0 = time.perf_counter()
        y.train(data=data, imgsz=cfg["imgsz"], batch=cfg["batch"], epochs=1,
                cache="disk", workers=8, loader_mp=processes,
                profile=processes, verbose=False, project=str(tmp / "runs"),
                name=name)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    tr = y.trainer
    (e,) = tr.epoch_stats
    launches = dict(_build.LAUNCHES)
    val_batches = -(-cfg["n_val"] // cfg["batch"])
    check_launches(f"loop_mp {name}", launches,
                   {"fused_enhance": e["batches"] + vc.calls * val_batches,
                    "nms": vc.calls * val_batches})
    run = {"workers": "processes" if processes else "threads",
           "seconds": secs, "batches": e["batches"],
           "images_per_s": e["batches"] * cfg["batch"] / e["train_s"],
           "loader_wait_ms_per_batch": 1e3 * e["loader_wait_s"] / e["batches"],
           "step_host_ms": st.host, "step_device_ms": st.device_ms(),
           "val_s": e["val_s"], "val": {k: float(v) for k, v in tr.metrics.items()},
           "launches": launches, "pool_closed": tr.train_dl._mp_pool is None}
    if processes:
        run["trace"] = str(tr.profile_trace)
        run["traced_step"] = idle_share(tr.profile_trace)
    return run


def phase_loop_mp(torch):
    """loop_full's settings at b16/640 on sidecars that need a resize:
    one epoch with 8 loader threads, then one with 8 processes, twice in
    turns, the processes' epochs with profile=True; then the autobatch
    phase on the same data. Where the profiler records no device work (its
    CUPTI tracing untried on the card's machine), the idle share is
    reported as None, not failed."""
    import tempfile
    cfg = LOOP_MP
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = loop_data(tmp / "mp", cfg, SEED + 70, SEED + 71)
        for k, processes in enumerate((False, True, False, True)):
            runs.append(loop_mp_run(torch, data, tmp, f"mp{k}", processes))
        launches = {key: sum(r["launches"].get(key, 0) for r in runs)
                    for key in runs[0]["launches"]}
        emit({"phase": "loop_mp", **{k: cfg[k] for k in
              ("n_train", "n_val", "imgsz", "batch")},
              "shapes": [list(s) for s in cfg["shapes"]], "runs": runs,
              "launches": launches})
        for r in runs:
            if not (r["pool_closed"]
                    and r["batches"] == cfg["n_train"] // cfg["batch"]
                    and all(0.0 <= r["val"][k] <= 1.0 for k in METRICS)
                    and (r["workers"] == "threads"
                         or Path(r["trace"]).is_file())):
                raise AssertionError(f"loop_mp: {r}")
        ab = phase_autobatch(torch, data, tmp)
    return {"launches": launches, "autobatch": ab}


def phase_autobatch(torch, data, tmp):
    """batch=-1 at 640 through YOLO(...).train() for one epoch: the two
    trial peaks, the batch fitted, and the peak of the first real
    micro-step at that batch, which must stay under 0.67 of the card's
    memory (mem_get_info's total)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine import trainer as T
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.utils.autobatch import FRACTION
    cfg = LOOP_MP
    peaks, step = [], T.DetectionTrainer.step

    def measured(tr, batch, i):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(tr, batch, i)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        return out
    y = YOLO("yolov8l.yaml", nc=3, seed=SEED)
    zero_launches()
    T.DetectionTrainer.step = measured
    try:
        with no_cv2(), no_plain_on_cuda(), count_val_calls() as vc:
            y.train(data=data, imgsz=cfg["imgsz"], batch=-1, epochs=1,
                    cache="disk", workers=8, verbose=False,
                    project=str(tmp / "runs"), name="autobatch")
            torch.cuda.synchronize()
    finally:
        T.DetectionTrainer.step = step
    tr = y.trainer
    info = tr.autobatch_info
    total = torch.cuda.mem_get_info()[1]
    launches = dict(_build.LAUNCHES)
    val_batches = -(-cfg["n_val"] // tr.args.batch)
    check_launches("autobatch", launches,
                   {"fused_enhance": 2 + len(peaks) + vc.calls * val_batches,
                    "nms": vc.calls * val_batches})
    rec = {"phase": "autobatch", "imgsz": cfg["imgsz"],
           "trial_batches": [8, 16], "trial_peaks_gib": [p / 2 ** 30 for p in
                                                         info["peaks"]],
           "fixed_gib": info["fixed"] / 2 ** 30,
           "per_image_mib": info["per_image"] / 2 ** 20,
           "batch": tr.args.batch, "micro_steps": len(peaks),
           "step_peak_gib": [p / 2 ** 30 for p in peaks],
           "total_gib": total / 2 ** 30, "fraction": FRACTION,
           "launches": launches}
    emit(rec)
    if not (peaks and max(peaks) < FRACTION * total and tr.args.batch % 8 == 0):
        raise AssertionError(f"autobatch: {rec}")
    return rec


# predict_extras: captured activations, the card against the CPU (TF32
# off): layer 0 within the enhance kernel's TOL; every later layer within
# CAP_RTOL of that layer's largest magnitude (cuDNN's sum order, grown
# through the random-weight network as the decoded boxes' is; 1.7e-4 on
# an H100 at 700 W)
CAP_RTOL = 2e-3
HOST_PACKAGES = ("cv2", "PIL", "matplotlib")


def npz_of(torch, yolo, path):
    """The facade's weights as a checkpoint (params, batch_stats,
    model_yaml), as `YOLO([...])` loads its members."""
    from dedark_yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from dedark_yolo_tpu_torch.utils.weights import state_dict_to_jax
    trees = state_dict_to_jax({k: v.cpu() for k, v in
                               yolo.state_dict().items()}, yolo.model)
    save_checkpoint(path, params=trees["params"],
                    batch_stats=trees["batch_stats"],
                    model_yaml=yolo.model.yaml)
    return str(path)


def timed_predict(torch, model, frames, reps, expected, name, **kw):
    """A warm-up batch, then `reps` batches timed, under no_plain_on_cuda,
    each kernel launched as `expected` says a batch: (results, record)."""
    from dedark_yolo_tpu_torch.ops import _build
    model.predict(frames, **kw)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_on_cuda():
        res = model.predict(frames * reps, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_launches(name, launches, {k: n * reps for k, n in expected.items()})
    counts = [len(r) for r in res]
    if max(counts) == 0:
        raise AssertionError(f"{name}: no detections at conf={CONF}")
    return res, {"images": len(res), "seconds": secs,
                 "images_per_s": len(res) / secs, "launches": launches,
                 "launches_per_batch": {k: v / reps for k, v in
                                        launches.items()},
                 "stage_ms": dict(model.predictor.speed),
                 "dets_per_image": [min(counts), max(counts)]}


def card_vs_cpu(gpu_model, cpu_model, frame, **kw):
    """One frame on the card (TF32 off) and on the CPU at a conf in a wide
    gap of the card's scores: the two Results and their pairing record."""
    pair_kw = dict(imgsz=IMGSZ, batch=1, matmul_precision="float32", **kw)
    conf = pair_conf(gpu_model.predict([frame], conf=0.001, **pair_kw)[0])
    gpu = gpu_model.predict([frame], conf=conf, **pair_kw)[0]
    cpu = cpu_model.predict([frame], conf=conf, device="cpu", **pair_kw)[0]
    pairs = pair_results(gpu, cpu) if len(gpu) == len(cpu) else None
    return gpu, cpu, {
        "conf": conf, "gpu_count": len(gpu), "cpu_count": len(cpu),
        "paired": pairs is not None and 0 < len(cpu) < MAX_DET,
        "box_max_abs_err_px": max(pairs[0], default=0.0) if pairs else None,
        "score_max_abs_err": max(pairs[1], default=0.0) if pairs else None,
        "box_tol_px": BOX_TOL_PX, "score_tol": SCORE_TOL}


def compare_captures(torch, gpu, cpu):
    """visualize's captures, card against CPU, layer by layer."""
    from dedark_yolo_tpu_torch.tools.enhance_ab import compare
    import numpy as np
    rec = {"layers": sorted(gpu) == sorted(cpu) and len(gpu) > 0,
           "layer0": compare(torch.from_numpy(gpu[0]),
                             torch.from_numpy(cpu[0]), torch.float32)}
    worst = 0.0
    for k in cpu:
        if k == 0 or gpu[k].shape != cpu[k].shape:
            rec["layers"] = rec["layers"] and k == 0
            continue
        worst = max(worst, float(np.abs(gpu[k] - cpu[k]).max()
                                 / max(float(np.abs(cpu[k]).max()), 1e-12)))
    rec.update(max_rel_err_after_layer0=worst, rel_tol=CAP_RTOL,
               ok=rec["layers"] and rec["layer0"]["ok"] and worst <= CAP_RTOL)
    return rec


def saving_calls(yolo, frame, tmp):
    """OpenCV, Pillow and matplotlib on this host, and their calls: where a
    package imports, its saving call writes its files; where it does not,
    that call raises an ImportError naming it. OpenCV's call saves the
    annotated image, the enhanced one and the crops; matplotlib's the
    feature grids (written before the annotated image, which needs OpenCV
    too); Pillow's only call is a PIL source, which needs Pillow to exist."""
    import importlib
    import numpy as np
    have = {}
    for module in HOST_PACKAGES:
        try:
            importlib.import_module(module)
            have[module] = True
        except ImportError:
            have[module] = False
    kw = dict(imgsz=IMGSZ, batch=1, conf=CONF, project=str(tmp), save=True)
    out = {"present": have}
    try:
        yolo.predict([frame], save_enhanced=True, save_crop=True, name="cv2",
                     **kw)
        err = ""
    except ImportError as e:
        err = str(e)
    files = sorted(str(p.relative_to(tmp / "cv2")) for p in
                   (tmp / "cv2").rglob("*.jpg"))
    out["cv2"] = {"import_error": err, "files": files[:20]}
    ok = ({"image.jpg", "image_enhanced.jpg"} <= set(files)
          and any(f.startswith("crops/") for f in files)) \
        if have["cv2"] else "OpenCV" in err
    try:
        yolo.predict([frame], visualize=True, name="mpl", **kw)
        err = ""
    except ImportError as e:
        err = str(e)
    grids = len(list((tmp / "mpl").rglob("stage*_features.png")))
    out["matplotlib"] = {"import_error": err, "grids": grids}
    ok = ok and (grids == len(yolo.model.specs) - 1 if have["matplotlib"]
                 else "matplotlib" in err)
    if have["PIL"]:
        from PIL import Image
        pil = Image.fromarray(np.ascontiguousarray(frame[..., ::-1]))
        a = yolo.predict(pil, imgsz=IMGSZ, conf=CONF)[0].boxes.data
        b = yolo.predict(frame, imgsz=IMGSZ, conf=CONF)[0].boxes.data
        out["PIL"] = {"pil_source_equals_array": bool(np.array_equal(a, b))}
        ok = ok and out["PIL"]["pil_source_equals_array"]
    return out, ok


def phase_predict_extras(torch, yolo, frames, pred):
    """Predict's paths beyond plain inference at b16/640, f32, on the
    predict phase's frames (BN set from them again): plain predict timed
    beside TTA (fused_enhance 3 and nms 1 a batch) and a two-member
    ensemble of seeded checkpoints through YOLO([a.npz, b.npz]) (2 and 1);
    TTA in reference mode for one batch (usm 3, nms 1); each of TTA and the
    ensemble on one frame against the CPU, paired; one frame with
    save_enhanced and visualize (fused_enhance 1, nms 1): the enhanced
    image against the CPU's within the kernel's TOL, the captures layer by
    layer; then OpenCV, Pillow and matplotlib: present or not, and each
    saving call either writes or raises naming the package."""
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.tools.enhance_ab import compare
    reps = 4
    kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, half=False)
    calibrate_bn(torch, yolo.model, frames)
    rec = {"phase": "predict_extras", "batch": BATCH, "imgsz": IMGSZ,
           "conf": CONF, "matmul_precision": "default"}
    _, rec["plain"] = timed_predict(torch, yolo, frames, reps,
                                    {"fused_enhance": 1, "nms": 1},
                                    "predict_extras plain", **kw)
    _, rec["tta"] = timed_predict(torch, yolo, frames, reps,
                                  {"fused_enhance": 3, "nms": 1},
                                  "predict_extras tta", augment=True, **kw)
    _, rec["tta_reference"] = timed_predict(
        torch, yolo, frames[:BATCH], 1, {"usm": 3, "nms": 1},
        "predict_extras tta reference", augment=True,
        contrast_mode="reference", **kw)
    cpu_model = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=SEED)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               yolo.state_dict().items()})
    one = frames[0]
    _, _, rec["tta"]["cpu_pair"] = card_vs_cpu(yolo, cpu_model, one,
                                               augment=True)
    gpu, cpu, rec["memory_outputs"] = card_vs_cpu(
        yolo, cpu_model, one, save_enhanced=True, visualize=True)
    rec["memory_outputs"]["enhanced"] = compare(
        torch.from_numpy(gpu.enhanced_img), torch.from_numpy(cpu.enhanced_img),
        torch.float32)
    rec["memory_outputs"]["enhanced_shape"] = list(gpu.enhanced_img.shape)
    rec["memory_outputs"]["captures"] = compare_captures(
        torch, gpu.features, cpu.features)
    zero_launches()
    yolo.predict([one], imgsz=IMGSZ, batch=1, conf=CONF, save_enhanced=True,
                 visualize=True)
    check_launches("predict_extras save_enhanced+visualize",
                   dict(_build.LAUNCHES), {"fused_enhance": 1, "nms": 1})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        second = YOLO("yolov8l.yaml", nc=3, seed=SEED + 1)
        calibrate_bn(torch, second.model, frames)
        paths = [npz_of(torch, yolo, tmp / "a.npz"),
                 npz_of(torch, second, tmp / "b.npz")]
        del second
        ens = YOLO(paths)
        _, rec["ensemble"] = timed_predict(torch, ens, frames, reps,
                                           {"fused_enhance": 2, "nms": 1},
                                           "predict_extras ensemble", **kw)
        _, _, rec["ensemble"]["cpu_pair"] = card_vs_cpu(
            ens, YOLO(paths, device="cpu"), one)
        del ens
        rec["host_packages"], packages_ok = saving_calls(yolo, one,
                                                         tmp / "saves")
    rec["beside_predict_f32"] = {"images_per_s": pred["f32"]["images_per_s"]}
    rec["launches"] = {k: sum(rec[r]["launches"].get(k, 0) for r in
                              ("plain", "tta", "tta_reference", "ensemble"))
                       for k in ("fused_enhance", "usm", "nms")}
    emit(rec)
    mem = rec["memory_outputs"]
    if not (rec["tta"]["cpu_pair"]["paired"]
            and rec["ensemble"]["cpu_pair"]["paired"] and mem["paired"]
            and mem["enhanced"]["ok"] and mem["captures"]["ok"]
            and mem["enhanced_shape"] == [IMGSZ, IMGSZ, 3] and packages_ok):
        raise AssertionError(f"predict_extras: {rec}")
    return rec


# zoo phase: the detect architectures beyond the flagship, at full width
# (nc=3, seeded weights, BN set from the frames). Predict f32 b16/640 on the
# predict phase's frames: the flagship at its other scales, then each
# variant of the fork at scale l; a warm-up batch and 2 timed ones each,
# fused_enhance once a batch where the model has layer 0, nms once a batch
# in every model; one frame on the card against the CPU (card_vs_cpu).
# Train: DetectionTrainer.step at b16/640 f32 on four models that cover the
# zoo's modules (align convs; SCConv, CRU, RFB, MFRU; PConv, AsffDoubLevel,
# AsffDetect; C2 on four levels), a warm-up micro-step then 3 timed, and
# each one's train_parity at 128 against the CPU. Val: the AsffDetect
# model on the val phase's small set, card against CPU.
ZOO_PREDICT = (["yolov8n.yaml", "yolov8s.yaml", "yolov8m.yaml",
                "yolov8x.yaml"]
               + [f"yolov8l-{v}.yaml" for v in
                  ("dedark", "faster", "faster-twohead", "rbf", "rbf-asff",
                   "mfru-rbf-asff", "asff-threehead", "p2", "p6")])
ZOO_TRAIN = ("yolov8n.yaml", "yolov8l-mfru-rbf-asff.yaml",
             "yolov8l-faster-twohead.yaml", "yolov8l-p6.yaml")
ZOO_VAL = "yolov8n-faster-twohead.yaml"
ZOO_TRAIN_STEPS = 3


def zoo_train(torch, yolo):
    """A warm-up micro-step and ZOO_TRAIN_STEPS timed ones of `yolo`'s
    model at b16/640, f32, default precision (the fourth call of the
    window of 4 applies the update): ms a micro-step, peak memory, loss
    items, fused_enhance once a micro-step where layer 0 exists."""
    from dedark_yolo_tpu_torch.tools.c14_split import train_batch
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
    from dedark_yolo_tpu_torch.ops import _build
    tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64}, nb=1000)
    batches = [train_batch(BATCH, IMGSZ, SEED + i) for i in range(2)]
    has_l0 = yolo.model.specs[0].name == "lowlight_recovery"
    with matmul_precision("default"), no_plain_on_cuda():
        tr.step(batches[0], 0)
        torch.cuda.synchronize()
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        items = [tr.step(batches[(i + 1) % 2], i + 1)[1]
                 for i in range(ZOO_TRAIN_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ZOO_TRAIN_STEPS
    launches = dict(_build.LAUNCHES)
    check_launches(f"zoo train {yolo.model.yaml['yaml_file']}", launches,
                   {"fused_enhance": ZOO_TRAIN_STEPS} if has_l0 else {})
    items = torch.stack(items).cpu()
    rec = {"batch": BATCH, "imgsz": IMGSZ, "micro_steps": ZOO_TRAIN_STEPS,
           "micro_step_ms": ms, "images_per_s": BATCH / ms * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss_items": items.tolist(),
           "finite": bool(torch.isfinite(items).all()),
           "applied": tr.opt_state.step, "launches": launches}
    if not (rec["finite"] and rec["applied"] == 1):
        raise AssertionError(f"zoo train: {rec}")
    return rec


def zoo_train_amp(torch, yolo):
    """amp=True (bf16) on `yolo`'s model at b16/640: the loss items against
    f32 at the same weights and batch (TF32 off, each within
    AMP_ITEMS_RTOL, train_amp's bar), then a warm-up micro-step and
    ZOO_TRAIN_STEPS timed ones at the default precision as zoo_train:
    ms a micro-step, peak memory, fused_enhance once a micro-step on a
    bf16 image where layer 0 exists; the masters, the EMA and the BN stats
    f32 after."""
    from dedark_yolo_tpu_torch.tools.c14_split import train_batch
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.ops import enhance_kernel as K
    start = {k: v.clone() for k, v in yolo.state_dict().items()}
    batches = [train_batch(BATCH, IMGSZ, SEED + i) for i in range(2)]
    has_l0 = yolo.model.specs[0].name == "lowlight_recovery"
    items = {}
    with matmul_precision("float32"), no_plain_on_cuda():
        for amp in (False, True):
            tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64,
                                               "amp": amp}, nb=1000)
            tr.model.train()
            with torch.no_grad():
                items[amp] = torch.stack(list(tr.loss(tr.to_device(
                    batches[0]))[1])).float().cpu()
            tr.model.eval()
            yolo.model.load_state_dict(start)
    rel = ((items[True] - items[False]).abs() / items[False].abs()).tolist()
    dtypes = []
    fused = K.fused_enhance

    def recorded(img, *args):
        dtypes.append(str(img.dtype))
        return fused(img, *args)
    tr = DetectionTrainer(yolo.model, {"batch": BATCH, "nbs": 64, "amp": True},
                          nb=1000)
    K.fused_enhance = recorded
    try:
        with matmul_precision("default"), no_plain_on_cuda():
            tr.step(batches[0], 0)
            torch.cuda.synchronize()
            zero_launches()
            dtypes.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step_items = [tr.step(batches[(i + 1) % 2], i + 1)[1]
                          for i in range(ZOO_TRAIN_STEPS)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / ZOO_TRAIN_STEPS
            launches = dict(_build.LAUNCHES)
    finally:
        K.fused_enhance = fused
    check_launches(f"zoo train_amp {yolo.model.yaml['yaml_file']}", launches,
                   {"fused_enhance": ZOO_TRAIN_STEPS} if has_l0 else {})
    step_items = torch.stack(step_items).cpu()
    state_dtypes = {str(v.dtype) for d in (tr.model.state_dict(), tr.ema)
                    for v in d.values() if v.is_floating_point()}
    rec = {"batch": BATCH, "imgsz": IMGSZ, "micro_steps": ZOO_TRAIN_STEPS,
           "micro_step_ms": ms, "images_per_s": BATCH / ms * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "items_f32": items[False].tolist(),
           "items_bf16": items[True].tolist(), "items_rel_err": rel,
           "tol_rel": AMP_ITEMS_RTOL, "loss_items": step_items.tolist(),
           "finite": bool(torch.isfinite(step_items).all()),
           "enhance_image_dtypes": sorted(set(dtypes)),
           "state_dtypes": sorted(state_dtypes), "launches": launches}
    rec["ok"] = (rec["finite"] and max(rel) <= AMP_ITEMS_RTOL
                 and dtypes == ["torch.bfloat16"] * (ZOO_TRAIN_STEPS
                                                     if has_l0 else 0)
                 and state_dtypes == {"torch.float32"})
    return rec


def zoo_val(torch, tmp):
    """YOLO(ZOO_VAL).val on the val phase's small dataset (BN set from its
    images), on the card and on the CPU, TF32 off, with the loss: image by
    image (compare_images), metrics within VAL_METRIC_RTOL and loss items
    within VAL_LOSS_RTOL; the card's run launches nms once a batch and no
    other kernel."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.cfg import get_cfg
    from dedark_yolo_tpu_torch.engine.validator import DetectionValidator
    from dedark_yolo_tpu_torch.ops import _build
    data = val_dataset(tmp / "zoo_val", VAL_SMALL["n"], VAL_SMALL["shapes"],
                       SEED)
    gpu = YOLO(ZOO_VAL, nc=3, seed=SEED)
    calibrate_bn(torch, gpu.model, val_images(data, VAL_SMALL["n"]),
                 VAL_SMALL["imgsz"])
    cpu = YOLO(ZOO_VAL, nc=3, device="cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    kw = {"data": data, "imgsz": VAL_SMALL["imgsz"],
          "batch": VAL_SMALL["batch"], "cache": "disk",
          "matmul_precision": "float32", "verbose": False}
    batches = -(-VAL_SMALL["n"] // VAL_SMALL["batch"])
    res, recs = {}, {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        v = DetectionValidator(args=get_cfg({**kw, "device": dev}))
        zero_launches()
        with no_plain_on_cuda(), record_detections() as recs[dev]:
            res[dev] = {k: float(x) for k, x in
                        v(model=model.model, with_loss=True).items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            check_launches("zoo val", launches, {"nms": batches})
    g, c = res["cuda"], res["cpu"]
    rec = {"model": ZOO_VAL, "cuda": g, "cpu": c, "launches": launches,
           **compare_images(recs["cuda"], recs["cpu"]),
           "metric_max_rel_err": max(abs(g[k] - c[k]) / abs(c[k])
                                     if c[k] else abs(g[k]) for k in METRICS),
           "loss_max_rel_err": max(abs(g[k] - c[k]) / abs(c[k])
                                   for k in c if k.startswith("val/")),
           "metric_rtol": VAL_METRIC_RTOL, "loss_rtol": VAL_LOSS_RTOL}
    rec["ok"] = (rec["ok"] and rec["images"][1] == VAL_SMALL["n"]
                 and rec["metric_max_rel_err"] <= VAL_METRIC_RTOL
                 and rec["loss_max_rel_err"] <= VAL_LOSS_RTOL)
    return rec


def phase_zoo(torch, frames):
    """Every model of ZOO_PREDICT at full width: predict (timed_predict,
    card_vs_cpu), yolov8n also in contrast_mode 'reference' (usm once a
    batch); the ZOO_TRAIN models' train steps and train_parity; then
    zoo_val. One line a model, one for the val, one summary line; any
    failed check raises after the lines are printed."""
    from dedark_yolo_tpu_torch.tools.c14_split import train_parity
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    t0 = time.perf_counter()
    kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, half=False)
    summary = {"phase": "zoo", "batch": BATCH, "imgsz": IMGSZ,
               "images_per_s": {}, "micro_step_ms": {}, "peak_memory_gib": {},
               "amp_micro_step_ms": {}, "amp_peak_memory_gib": {},
               "launches": {"fused_enhance": 0, "usm": 0, "nms": 0},
               "amp_launches": {"fused_enhance": 0, "usm": 0, "nms": 0}}
    failed = []
    for name in ZOO_PREDICT:
        yolo = YOLO(name, nc=3, seed=SEED)
        calibrate_bn(torch, yolo.model, frames)
        has_l0 = yolo.model.specs[0].name == "lowlight_recovery"
        expected = {"nms": 1, **({"fused_enhance": 1} if has_l0 else {})}
        rec = {"phase": "zoo", "model": name, "nc": 3,
               "params": sum(p.numel() for p in yolo.model.parameters()),
               "strides": list(yolo.model.strides), "layer0": has_l0}
        _, rec["predict"] = timed_predict(torch, yolo, frames, 2, expected,
                                          f"zoo {name}", **kw)
        runs = [rec["predict"]]
        if name == "yolov8n.yaml":
            _, rec["predict_reference"] = timed_predict(
                torch, yolo, frames, 1, {"usm": 1, "nms": 1},
                f"zoo {name} reference", contrast_mode="reference", **kw)
            runs.append(rec["predict_reference"])
        cpu = YOLO(name, nc=3, device="cpu", seed=SEED)
        cpu.load_state_dict({k: v.cpu() for k, v in yolo.state_dict().items()})
        _, _, rec["cpu_pair"] = card_vs_cpu(yolo, cpu, frames[0])
        del cpu
        if not rec["cpu_pair"]["paired"]:
            failed.append(f"{name} predict card vs CPU")
        if name in ZOO_TRAIN:
            rec["train"] = zoo_train(torch, yolo)
            runs.append(rec["train"])
            rec["train_amp"] = amp = zoo_train_amp(torch, yolo)
            runs.append(amp)
            if not amp["ok"]:
                failed.append(f"{name} train_amp")
            rec["train_parity"] = train_parity(name)
            if not rec["train_parity"]["ok"]:
                failed.append(f"{name} train_parity")
            summary["micro_step_ms"][name] = rec["train"]["micro_step_ms"]
            summary["peak_memory_gib"][name] = rec["train"]["peak_memory_gib"]
            summary["amp_micro_step_ms"][name] = amp["micro_step_ms"]
            summary["amp_peak_memory_gib"][name] = amp["peak_memory_gib"]
            for k in summary["amp_launches"]:
                summary["amp_launches"][k] += amp["launches"].get(k, 0)
        for r in runs:
            for k in summary["launches"]:
                summary["launches"][k] += r["launches"].get(k, 0)
        summary["images_per_s"][name] = rec["predict"]["images_per_s"]
        emit(rec)
        del yolo
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        val = zoo_val(torch, Path(tmp))
    summary["launches"]["nms"] += val["launches"]["nms"]
    emit({"phase": "zoo", "val": val})
    if not val["ok"]:
        failed.append("val card vs CPU")
    summary.update(seconds=time.perf_counter() - t0, failed=failed)
    emit(summary)
    if failed:
        raise AssertionError(f"zoo: {failed}")
    return summary


# serve phase: the dynamic-batching InferenceServer on the flagship's
# checkpoint (the predict phase's weights, BN set from its frames), b16,
# imgsz 640, at the default precision (TF32 convolutions): the predict
# frames plus four 721x1280 frames. At each of SERVE_CLIENTS threads,
# SERVE_WINDOWS windows of closed-loop clients, each running until
# SERVE_WINDOW_S have passed and the server has read back
# SERVE_MIN_BATCHES batches; each figure is reported per window with the
# windows' spread. Under TF32, cuDNN need not give a frame the same bits
# at every place in a 16-frame batch (at places 14 and 15 of the predict
# frames' batch: up to 0.45 on a raw map and 4e-2 on a score of this
# random-weight flagship against place 0, on an NVIDIA H100 80GB HBM3 at
# 700 W), and the server places a frame wherever its batch has room. So a
# frame's reference is YOLO.predict(batch=16) of 16 copies of it, its
# detections at each place, and every response of every window is held to
# one of them: bit-equal (counted), else paired under the predict phase's
# bars. The conf is set midway across the widest gap between the predict
# run's pooled scores (ranked within the middle half, at conf CONF).
SERVE_CLIENTS = (1, 4, 16)
SERVE_WINDOWS, SERVE_WINDOW_S, SERVE_MIN_BATCHES = 2, 3.0, 50
SERVE_WAIT_MS = 5.0


def serve_conf(results):
    """A conf midway across the widest gap between two consecutive scores
    of the pooled detections of `results`, among the middle half of
    their ranks."""
    import numpy as np
    pool = np.sort(np.concatenate([r.boxes.conf for r in results]))[::-1]
    lo, hi = len(pool) // 4, 3 * len(pool) // 4
    k = lo + int(np.argmax(pool[lo:hi] - pool[lo + 1:hi + 1]))
    return float((pool[k] + pool[k + 1]) / 2)


def response_result(resp, frame, names):
    """A server response as a Results of its frame (for pair_results)."""
    from dedark_yolo_tpu_torch.engine.results import Results
    return Results(orig_img=frame[..., ::-1], path="serve", names=names,
                   boxes=resp["boxes"])


def serve_load(srv, frames, threads):
    """One window of closed-loop load: `threads` clients, each submitting
    the next frame (in turns over `frames`) when its last response arrives,
    until SERVE_WINDOW_S have passed and the server has read back
    SERVE_MIN_BATCHES batches. p50/p95 of the window's server-side
    latencies by stats()'s index rule. Returns (record, [(frame index,
    response)])."""
    import itertools
    import threading
    out, errors, lock = [], [], threading.Lock()
    turn, done = itertools.count(), threading.Event()

    def client():
        while not done.is_set():
            with lock:
                i = next(turn) % len(frames)
            try:
                r = srv.predict(frames[i], timeout=120)
            except Exception as e:      # any failed future fails the phase
                with lock:
                    errors.append(repr(e))
                done.set()
                return
            with lock:
                out.append((i, r))
            if (time.perf_counter() - t0 >= SERVE_WINDOW_S
                    and srv.stats()["batches"] >= SERVE_MIN_BATCHES):
                done.set()
    srv.reset_stats()
    pool = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.perf_counter()
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    secs = time.perf_counter() - t0
    st = srv.stats()
    lats = sorted(r["latency_ms"] for _, r in out)
    n = len(lats)
    return {"threads": threads, "requests": n, "seconds": secs,
            "images_per_s": n / secs,
            "latency_ms_p50": lats[n // 2] if n else 0.0,
            "latency_ms_p95": lats[min(n - 1, int(n * 0.95))] if n else 0.0,
            "mean_batch_occupancy": st["mean_batch_occupancy"],
            "batches": st["batches"], "errors": errors}, out


def spread(runs, keys):
    """(max - min) / mean over `runs` of each of `keys`."""
    out = {}
    for k in keys:
        v = [r[k] for r in runs]
        out[f"{k}_spread"] = (max(v) - min(v)) / (sum(v) / len(v))
    return out


def http_leg(srv, frame):
    """/healthz and /stats over HTTP; POST /predict with a PNG where this
    host imports OpenCV (the response equal to srv.predict of the frame),
    else the reason it was not run."""
    import http.client
    import numpy as np
    httpd, port = srv.serve(port=0)
    rec = {}

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()
    try:
        rec["healthz"] = request("GET", "/healthz")
        code, st = request("GET", "/stats")
        rec["stats"] = [code, {k: st[k] for k in ("requests", "max_batch")}]
        try:
            import cv2
        except ImportError as e:
            rec["post_predict"] = {"run": False, "why": "this host has no "
                                   f"OpenCV to encode the PNG ({e}); a host "
                                   "package, not the device, is missing"}
        else:
            ok, png = cv2.imencode(".png", frame)
            code, payload = request("POST", "/predict", png.tobytes())
            want = srv.predict(frame)["boxes"]
            got = np.asarray(payload.get("boxes", []), np.float32).reshape(-1, 6)
            rec["post_predict"] = {"run": True, "status": code,
                                   "detections": len(got),
                                   "equal": bool(np.array_equal(got, want))}
    finally:
        httpd.shutdown()
    post = rec["post_predict"]
    rec["ok"] = (rec["healthz"] == (200, {"status": "ok"})
                 and rec["stats"][0] == 200
                 and (not post["run"] or (post["status"] == 200
                                          and post["equal"])))
    return rec


def pair_responses(responses, load, refs):
    """Each (frame index, response) held to refs[frame], its frame's
    Results at every place of a batch: bit-equal to one of them, else
    paired with one (pair_results). {paired, bit_equal_responses, unpaired
    [frame, detections], the largest box and score differences of the
    paired ones, the frames whose detections differ between places}."""
    import numpy as np
    worst, unpaired, equal = [0.0, 0.0], [], 0
    for i, resp in responses:
        if any(np.array_equal(resp["boxes"], r.boxes.data) for r in refs[i]):
            equal += 1
            continue
        g = response_result(resp, load[i], refs[i][0].names)
        pairs = next((p for r in refs[i] if len(r) == len(g)
                      for p in [pair_results(g, r)] if p is not None), None)
        if pairs is None:
            unpaired.append([i, len(g)])
            continue
        worst = [max(worst[0], max(pairs[0], default=0.0)),
                 max(worst[1], max(pairs[1], default=0.0))]
    return {"responses": len(responses), "paired": not unpaired,
            "bit_equal_responses": equal, "unpaired": unpaired[:8],
            "box_max_abs_err_px": worst[0], "score_max_abs_err": worst[1],
            "box_tol_px": BOX_TOL_PX, "score_tol": SCORE_TOL,
            "frames_differing_by_place": [
                i for i, rs in enumerate(refs)
                if not all(np.array_equal(r.boxes.data, rs[0].boxes.data)
                           for r in rs)]}


def phase_serve(torch, yolo, frames):
    """InferenceServer(max_batch=16) on the flagship's checkpoint, device
    cuda, TF32, under no_plain_on_cuda: the warmup, then SERVE_WINDOWS
    windows of closed-loop clients at each of 1, 4 and 16 threads
    (images/s, p50/p95 latency, occupancy, batches, the windows' spread)
    and the HTTP front-end; every response paired with its frame's
    reference at some place of a batch; after close(), fused_enhance and
    nms launched once a batch, the warmup included."""
    import tempfile
    from dedark_yolo_tpu_torch.engine.server import InferenceServer
    from dedark_yolo_tpu_torch.ops import _build
    calibrate_bn(torch, yolo.model, frames)
    load = frames + lowlight_frames([(721, 1280)], 4, SEED + 70)
    kw = dict(imgsz=IMGSZ, batch=BATCH)
    conf = serve_conf(yolo.predict(load, conf=CONF, **kw))
    refs = [yolo.predict([f] * BATCH, conf=conf, **kw) for f in load]
    rec = {"phase": "serve", "max_batch": BATCH, "imgsz": IMGSZ,
           "conf": conf, "max_wait_ms": SERVE_WAIT_MS,
           "window_s": SERVE_WINDOW_S, "min_batches": SERVE_MIN_BATCHES,
           "frames": {"480x640": len(frames), "721x1280": 4}}
    keys = ("images_per_s", "latency_ms_p50", "latency_ms_p95")
    with tempfile.TemporaryDirectory() as tmp:
        npz = npz_of(torch, yolo, Path(tmp) / "flagship.npz")
        zero_launches()
        with no_plain_on_cuda():
            srv = InferenceServer(npz, imgsz=IMGSZ, max_batch=BATCH,
                                  max_wait_ms=SERVE_WAIT_MS, conf=conf)
            try:
                runs, responses = [], []
                for threads in SERVE_CLIENTS:
                    windows = []
                    for _ in range(SERVE_WINDOWS):
                        r, out = serve_load(srv, load, threads)
                        windows.append(r)
                        responses += out
                    runs.append({"threads": threads, "windows": windows,
                                 **spread(windows, keys)})
                rec["http"] = http_leg(srv, load[0])
                # the HTTP leg's batches (no reset_stats since the last window)
                extra = srv.stats()["batches"] - windows[-1]["batches"]
            finally:
                srv.close()
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    every = [w for r in runs for w in r["windows"]]
    batches = sum(w["batches"] for w in every) + extra + 1
    check_launches("serve", launches, {"fused_enhance": batches,
                                       "nms": batches})
    rec.update(runs=runs, launches=launches, batches_with_warmup=batches,
               pair=pair_responses(responses, load, refs))
    emit(rec)
    if not (rec["pair"]["paired"] and rec["http"]["ok"]
            and all(not w["errors"] and w["batches"] >= SERVE_MIN_BATCHES
                    for w in every)
            and sum(len(r) for rs in refs for r in rs) > 0):
        raise AssertionError(f"serve: {rec}")
    return rec


# track phase: YOLO.track with persist=True over a seeded sequence of
# TRACK_FRAMES low-light 720x1280 frames of moving rectangles, written as
# .npy files (one sequence across files), b16/640, conf CONF; ByteTrack,
# BoT-SORT with gmc_method none and, where OpenCV imports, sparseOptFlow,
# each at its default thresholds. The random weights' class scores sit far
# below those thresholds (a track is confirmed only where IoU x score
# reaches 0.3), so the phase adds one constant to the class logits (the
# Detect head's class-branch biases): the one that lifts the median over
# the frames of each frame's TRACK_RANK-th score (conf 0.001) to
# TRACK_TOP_SCORE; restored after. Each tracker runs TRACK_PASSES passes
# of the sequence, each with a new tracker: a pass is 24 frames (two
# batches, under a second), so its frames/s is a short window, reported
# per pass with the passes' spread.
TRACK_FRAMES, TRACK_HW, TRACK_PASSES = 24, (720, 1280), 2
TRACK_RANK, TRACK_TOP_SCORE = 5, 0.8


def track_frames(n=TRACK_FRAMES, hw=TRACK_HW, seed=SEED + 80):
    """Seeded low-light BGR frames: dark noise and six bright rectangles
    moving at constant velocity, darkened as (u8/255)**DARK_PARAM."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w = hw
    objs = [(rng.integers(0, h - 200), rng.integers(0, w - 300),
             rng.integers(60, 200), rng.integers(60, 300),
             rng.integers(-12, 13), rng.integers(-8, 9),
             rng.uniform(0.6, 1.0, 3)) for _ in range(6)]
    out = []
    for f in range(n):
        img = rng.uniform(0, 0.3, (h, w, 3))
        for y, x, bh, bw, vx, vy, c in objs:
            y0 = int(np.clip(y + vy * f, 0, h - 1))
            x0 = int(np.clip(x + vx * f, 0, w - 1))
            img[y0:y0 + bh, x0:x0 + bw] = c
        out.append((img ** DARK_PARAM * 255).astype(np.uint8))
    return out


class time_tracker_updates:
    """Within the block, the host ms of every tracker update (BYTETracker
    and BOTSORT share `update`)."""

    def __enter__(self):
        from dedark_yolo_tpu_torch.trackers.byte_tracker import BYTETracker
        self.cls, self.fn, self.ms = BYTETracker, BYTETracker.update, []

        def update(tr, dets, img=None):
            t0 = time.perf_counter()
            try:
                return self.fn(tr, dets, img)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)
        self.cls.update = update
        return self

    def __exit__(self, *exc):
        self.cls.update = self.fn


def track_pass(torch, yolo, seq, tracker, untracked, kw):
    """One YOLO.track(persist=True) pass over `seq` with a new `tracker`,
    under no_plain_on_cuda: frames/s, the trackers' host ms a frame, the
    predictor's ms an image, the launches, and whether a fresh host tracker
    fed the `untracked` detections of the same frames gives the same ids
    and boxes (`ok` also wants every frame and at least one identity)."""
    import numpy as np
    from dedark_yolo_tpu_torch.ops import _build
    from dedark_yolo_tpu_torch.trackers import make_tracker
    yolo._tracker = None
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_on_cuda(), time_tracker_updates() as tm:
        res = yolo.track(str(seq), persist=True, tracker=tracker, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    fresh = make_tracker(tracker)
    same = all(np.array_equal(
        fresh.update(u.boxes.data, img=u.orig_img[..., ::-1])[:, :7],
        r.boxes.data) for r, u in zip(res, untracked))
    ids = {int(i) for r in res for i in r.boxes.id}
    speed = dict(yolo.predictor.speed)
    return {"frames_per_s": len(res) / secs, "seconds": secs,
            "tracked_boxes": int(sum(len(r) for r in res)),
            "identities": len(ids),
            "tracker_host_ms_per_frame": sum(tm.ms) / len(tm.ms),
            "predictor_ms_per_image": sum(speed.values()),
            "predictor_speed": speed, "launches": launches,
            "fresh_tracker_equal": same,
            "ok": same and len(res) == TRACK_FRAMES and len(ids) > 0}


def phase_track(torch, yolo):
    """TRACK_PASSES passes of track_pass over the .npy sequence with each
    tracker (frames/s, the trackers' host ms a frame against the
    predictor's ms an image, the passes' spread), fused_enhance and nms
    once a batch."""
    import math
    import tempfile
    import numpy as np
    import scipy.optimize  # noqa: F401  (imported before the timed updates)
    from dedark_yolo_tpu_torch.trackers import load_tracker_cfg
    frames = track_frames()
    kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF)
    batches = -(-TRACK_FRAMES // BATCH)
    try:
        import cv2  # noqa: F401
        gmcs = ["none", "sparseOptFlow"]
    except ImportError:
        gmcs = ["none"]
    rec = {"phase": "track", "frames": TRACK_FRAMES, "hw": list(TRACK_HW),
           "batch": BATCH, "imgsz": IMGSZ, "conf": CONF, "runs": {},
           "launches": {"fused_enhance": 0, "nms": 0}}
    ok = True
    head = yolo.model.model[-1]
    with tempfile.TemporaryDirectory() as tmp:
        seq = Path(tmp) / "seq"
        seq.mkdir()
        for i, f in enumerate(frames):
            np.save(seq / f"f{i:03d}.npy", f)
        q = float(np.median([np.sort(r.boxes.conf)[::-1][TRACK_RANK - 1]
                             for r in yolo.predict(str(seq), **{
                                 **kw, "conf": 0.001})]))
        logit = lambda p: math.log(p / (1 - p))
        shift = logit(TRACK_TOP_SCORE) - logit(q)
        rec["class_logit_shift"] = shift
        with torch.no_grad():
            for branch in head.cv3:
                branch[-1].bias += shift
        try:
            untracked = yolo.predict(str(seq), **kw)
            cases = [("bytetrack", None)] + [("botsort", g) for g in gmcs]
            for name, gmc in cases:
                key = name if gmc is None else f"{name}_{gmc}"
                tracker = f"{name}.yaml"
                if gmc is not None:
                    cfg = {**vars(load_tracker_cfg(tracker)), "gmc_method": gmc}
                    tracker = str(Path(tmp) / f"{key}.json")
                    Path(tracker).write_text(json.dumps(cfg))
                passes = []
                for _ in range(TRACK_PASSES):
                    p = track_pass(torch, yolo, seq, tracker, untracked, kw)
                    check_launches(f"track {key}", p["launches"],
                                   {"fused_enhance": batches, "nms": batches})
                    for k in rec["launches"]:
                        rec["launches"][k] += p["launches"][k]
                    ok = ok and p.pop("ok")
                    passes.append(p)
                rec["runs"][key] = {"passes": passes, **spread(
                    passes, ("frames_per_s", "tracker_host_ms_per_frame"))}
        finally:
            with torch.no_grad():
                for branch in head.cv3:
                    branch[-1].bias -= shift
    emit(rec)
    if not ok:
        raise AssertionError(f"track: {rec}")
    return rec


# benchmark phase: YOLO.benchmark(imgsz=640) of the flagship, fp32 and
# bf16 at batches 1, 8 and 32, BENCH_WARMUP warm-up calls and BENCH_ITERS
# timed a row; the whole table BENCH_RUNS times, each row reported per run
# with the runs' spread.
BENCH_BATCHES, BENCH_WARMUP, BENCH_ITERS, BENCH_RUNS = (1, 8, 32), 5, 30, 2


def phase_benchmark(torch, yolo):
    """The precision x batch table BENCH_RUNS times: no "error" row, each
    row's images/s per run and the runs' spread, fused_enhance and nms
    once a call (warm-ups included) under no_plain_on_cuda."""
    from dedark_yolo_tpu_torch.ops import _build
    zero_launches()
    tables = []
    with no_plain_on_cuda():
        for _ in range(BENCH_RUNS):
            tables.append(yolo.benchmark(
                imgsz=IMGSZ, batch_sizes=BENCH_BATCHES, warmup=BENCH_WARMUP,
                iters=BENCH_ITERS))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    calls = BENCH_RUNS * 2 * len(BENCH_BATCHES) * (BENCH_WARMUP + BENCH_ITERS)
    bad = [r for t in tables for r in t if "error" in r]
    rows = [{"precision": rs[0]["precision"], "batch": rs[0]["batch"],
             "img_per_sec": [r.get("img_per_sec") for r in rs],
             **({} if bad else spread(rs, ("img_per_sec",)))}
            for rs in zip(*tables)]
    rec = {"phase": "benchmark", "imgsz": IMGSZ, "warmup": BENCH_WARMUP,
           "iters": BENCH_ITERS, "rows": rows, "launches": launches}
    emit(rec)
    check_launches("benchmark", launches, {"fused_enhance": calls,
                                           "nms": calls})
    if bad or any(len(t) != 2 * len(BENCH_BATCHES) for t in tables):
        raise AssertionError(f"benchmark: {tables}")
    return rec


# export phase: the flagship of the predict phase (its BN set from the
# predict frames) exported on the card as a torch.export program and run
# through AutoBackend, YOLO("model.pt2"), InferenceServer and
# benchmark(formats=). Artifact against the live model, TF32 off: the
# program runs the live graph's aten ops and the same enhance kernel on the
# same batch, so the two agree to the last bits; held at 1e-3 px and 1e-5.
# The half artifact (bf16 parameters and image) against AutoBackend(npz,
# half=True), the same function through functional_call on bf16 casts: one
# bf16 ulp of the outputs' range (4 px at 512-1024, 2**-8 at scores up to
# 1), the least difference a bf16 map can show, as the benchmark phase's
# bf16 rows run the same route. The tiny model exported on the CPU and run
# on the card: the cpu phase's bars.
EXPORT_BOX_TOL_PX, EXPORT_SCORE_TOL = 1e-3, 1e-5
EXPORT_HALF_BOX_TOL_PX, EXPORT_HALF_SCORE_TOL = 4.0, 2.0 ** -8
EXPORT_VAL_BATCH = 3        # VAL_SMALL's 8 images: batches 3, 3 and 2 + 1 pad
EXPORT_REQUESTS = 8         # serve: one client, one request at a time
EXPORT_REPS = 4             # predict: timed batches
EXPORT_TINY = {"imgsz": 64, "batch": 2}


def letterboxed(frames, imgsz=IMGSZ):
    """The frames letterboxed to imgsz, RGB uint8 (B, S, S, 3)."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    return np.stack([np.ascontiguousarray(letterbox(f, imgsz)[0][..., ::-1])
                     for f in frames])


class tally:
    """Launch counts summed over the export phase's checked runs: `take`
    adds the counts since the last `zero_launches` to the total."""

    def __init__(self):
        self.total = {}

    def take(self):
        from dedark_yolo_tpu_torch.ops import _build
        for k, v in _build.LAUNCHES.items():
            self.total[k] = self.total.get(k, 0) + v
        return dict(_build.LAUNCHES)


def artifact_call(torch, backend, u8, expected, name, counts):
    """One AutoBackend call under no_plain_on_cuda, TF32 off, with its
    launches held to `expected`: the outputs on the host."""
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    zero_launches()
    with no_plain_on_cuda(), matmul_precision("float32"):
        out = [t.cpu() for t in backend(u8)]
    check_launches(name, counts.take(), expected)
    return out


def archive_mb(path):
    """MB of a .pt2 archive's members by kind (model/data/weights,
    .../constants, the serialized program, ...)."""
    import zipfile
    out = {}
    with zipfile.ZipFile(path) as z:
        for i in z.infolist():
            parts = i.filename.split("/")
            key = "/".join(parts[1:3] if parts[1:2] == ["data"] else parts[1:2])
            out[key] = out.get(key, 0.0) + i.file_size / 1e6
    return out


def output_errors(got, want):
    return {"box_max_abs_err_px": float((got[0] - want[0]).abs().max()),
            "score_max_abs_err": float((got[1] - want[1]).abs().max())}


def nms_rows(torch, outs):
    """predict's NMS (conf CONF, iou 0.7, max_det 300) of (boxes, scores):
    per image the (k, 6) rows."""
    from dedark_yolo_tpu_torch.ops.nms import non_max_suppression
    dets, counts = non_max_suppression(
        outs[0].cuda(), outs[1].cuda(), conf_thres=CONF, iou_thres=0.7,
        max_det=300, max_nms=2048, multi_label=False)
    dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
    return [dets[i, :int(k)] for i, k in enumerate(counts)]


def paired_rows(gs, cs, box_tol, score_tol):
    """Each image's rows paired (pair_results): {paired, images, dets, the
    largest box and score differences}."""
    pairs = [pair_results(g, c, box_tol, score_tol) if len(g) == len(c)
             else None for g, c in zip(gs, cs)]
    return {"paired": len(gs) == len(cs) and None not in pairs,
            "images": len(gs), "dets": sum(len(c) for c in cs),
            "box_max_abs_err_px": max((e for p in pairs if p for e in p[0]),
                                      default=0.0),
            "score_max_abs_err": max((e for p in pairs if p for e in p[1]),
                                     default=0.0)}


def export_forward(torch, yolo, u8, tmp, counts):
    """Export f32, half and reference mode (seconds, MB, no launch); each
    artifact once on the batch against the live model (f32 and reference:
    eval_outputs; half: AutoBackend(npz, half=True)), its detections
    paired after nms."""
    from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    out = {}
    x = torch.from_numpy(u8).cuda()

    def live(mode):
        set_contrast_mode(yolo.model, mode)
        try:
            with torch.inference_mode(), matmul_precision("float32"):
                return [t.cpu() for t in
                        yolo.model.eval_outputs(x.float() / 255.0)]
        finally:
            set_contrast_mode(yolo.model, "channel")

    for key, kw in (("f32", {}), ("half", {"half": True}),
                    ("reference", {"contrast_mode": "reference"})):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = yolo.export(format="pt2", imgsz=IMGSZ, batch=BATCH,
                           project=str(tmp / key), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        set_contrast_mode(yolo.model, "channel")
        check_launches(f"export {key}", counts.take(), {})
        t0 = time.perf_counter()
        backend = AutoBackend(path)
        rec = {"export_s": secs, "load_s": time.perf_counter() - t0,
               "mb": Path(path).stat().st_size / 1e6, "path": path,
               "archive_mb": archive_mb(path)}
        kernel = {"usm": 1} if key == "reference" else {"fused_enhance": 1}
        got = artifact_call(torch, backend, u8, kernel,
                            f"export {key} artifact", counts)
        if key == "half":
            npz = npz_of(torch, yolo, tmp / "flagship.npz")
            want = artifact_call(torch, AutoBackend(npz, half=True), u8,
                                 kernel, "export half live", counts)
            bars = (EXPORT_HALF_BOX_TOL_PX, EXPORT_HALF_SCORE_TOL)
        else:
            want = live(key if key == "reference" else "channel")
            bars = (EXPORT_BOX_TOL_PX, EXPORT_SCORE_TOL)
        rec.update(output_errors(got, want), box_tol_px=bars[0],
                   score_tol=bars[1], dtypes=[str(t.dtype) for t in got])
        rec["nms"] = paired_rows(nms_rows(torch, got), nms_rows(torch, want),
                                 *bars)
        rec["ok"] = (rec["box_max_abs_err_px"] <= bars[0]
                     and rec["score_max_abs_err"] <= bars[1]
                     and rec["nms"]["paired"] and rec["nms"]["dets"] > 0)
        out[key] = rec
    return out


def export_predict_val(torch, yolo, art, frames, tmp, counts):
    """YOLO(pt2) (`art`) predict against the live predict on the frames
    (TF32 off; a warm-up and EXPORT_REPS timed batches each, the first
    batch paired); then YOLO(pt2 at 128, b3).val on val_parity's small set
    against the live val at b3, image by image, metrics within
    VAL_METRIC_RTOL."""
    from dedark_yolo_tpu_torch import YOLO
    kw = dict(imgsz=IMGSZ, batch=BATCH, conf=CONF, matmul_precision="float32")
    per_batch = {"fused_enhance": 1, "nms": 1}
    res_a, rec_a = timed_predict(torch, art, frames, EXPORT_REPS, per_batch,
                                 "export predict artifact", **kw)
    counts.take()
    res_l, rec_l = timed_predict(torch, yolo, frames, EXPORT_REPS, per_batch,
                                 "export predict live", **kw)
    counts.take()
    pairs = paired_rows([r.boxes.data for r in res_a[:BATCH]],
                        [r.boxes.data for r in res_l[:BATCH]],
                        EXPORT_BOX_TOL_PX, EXPORT_SCORE_TOL)
    out = {"predict": {"artifact": rec_a, "live": rec_l, **pairs}}

    data = val_dataset(tmp / "val", VAL_SMALL["n"], VAL_SMALL["shapes"], SEED)
    vkw = {"data": data, "imgsz": VAL_SMALL["imgsz"],
           "batch": EXPORT_VAL_BATCH, "cache": "disk",
           "matmul_precision": "float32", "verbose": False, "plots": False}
    pt2_val = yolo.export(format="pt2", imgsz=VAL_SMALL["imgsz"],
                          batch=EXPORT_VAL_BATCH, project=str(tmp / "val_pt2"))
    batches = -(-VAL_SMALL["n"] // EXPORT_VAL_BATCH)
    res, recs = {}, {}
    for key, model in (("artifact", YOLO(pt2_val)), ("live", yolo)):
        zero_launches()
        with no_plain_on_cuda(), record_detections() as recs[key]:
            res[key] = {k: float(v) for k, v in model.val(**vkw).items()}
        check_launches(f"export val {key}", counts.take(),
                       {"fused_enhance": batches, "nms": batches})
    g, c = res["artifact"], res["live"]
    rec = {"artifact": g, "live": c, "batches": batches,
           **compare_images(recs["artifact"], recs["live"], EXPORT_BOX_TOL_PX,
                            EXPORT_SCORE_TOL),
           "metric_max_rel_err": max(abs(g[k] - c[k]) / abs(c[k]) if c[k]
                                     else abs(g[k]) for k in METRICS)}
    rec["ok"] = (rec["ok"] and rec["images"][1] == VAL_SMALL["n"]
                 and rec["metric_max_rel_err"] <= VAL_METRIC_RTOL)
    out["val"] = rec
    out["ok"] = pairs["paired"] and pairs["dets"] > 0 and rec["ok"]
    return out


def export_serve_bench(torch, yolo, art, frames, tmp, counts):
    """InferenceServer(pt2) answering EXPORT_REQUESTS requests of one
    client one at a time, each paired with YOLO(pt2).predict of its frame
    (TF32 as the server runs it); then benchmark(formats=("live", "pt2"))."""
    from dedark_yolo_tpu_torch.engine.server import InferenceServer
    want = [art.predict([f], imgsz=IMGSZ, conf=CONF)[0].boxes.data
            for f in frames[:EXPORT_REQUESTS]]
    zero_launches()
    with no_plain_on_cuda():
        srv = InferenceServer(art._backend_spec, conf=CONF)
        try:
            shape = (srv.imgsz, srv.max_batch)
            got = [srv.predict(f, timeout=120)["boxes"]
                   for f in frames[:EXPORT_REQUESTS]]
        finally:
            srv.close()
    torch.cuda.synchronize()
    calls = EXPORT_REQUESTS + 1                 # the warmup's batch too
    check_launches("export serve", counts.take(),
                   {"fused_enhance": calls, "nms": calls})
    serve = {"imgsz_batch": list(shape), **paired_rows(
        got, want, EXPORT_BOX_TOL_PX, EXPORT_SCORE_TOL),
        "bit_equal": sum(g.shape == w.shape and bool((g == w).all())
                         for g, w in zip(got, want))}

    warmup, iters = 1, 3
    zero_launches()
    with no_plain_on_cuda():
        rows = yolo.benchmark(formats=("live", "pt2"), imgsz=IMGSZ,
                              batch=BATCH, warmup=warmup, iters=iters,
                              export_dir=str(tmp / "bench"))
    torch.cuda.synchronize()
    check_launches("export benchmark", counts.take(),
                   {"fused_enhance": 2 * (warmup + iters)})
    ok = (serve["paired"] and serve["dets"] > 0 and shape == (IMGSZ, BATCH)
          and [r.get("format") for r in rows] == ["live", "pt2"]
          and not any("error" in r for r in rows))
    return {"serve": serve, "benchmark": rows, "ok": ok}


def export_tiny(torch, tmp, counts):
    """The tiny architecture exported on the CPU, run on the card through
    AutoBackend (fused_enhance launched) against the CPU at the cpu phase's
    bars; then `python -m dedark_yolo_tpu_torch export` of its npz."""
    import subprocess
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend
    arch = tmp / "tiny.json"
    arch.write_text(json.dumps(TINY_ARCH))
    y = YOLO(str(arch), device="cpu", seed=SEED)
    cfg = EXPORT_TINY
    pt2 = y.export(format="pt2", device="cpu", project=str(tmp / "tiny"),
                   **cfg)
    u8 = letterboxed(synthetic_frames(cfg["batch"]), cfg["imgsz"])
    got = artifact_call(torch, AutoBackend(pt2), u8, {"fused_enhance": 1},
                        "export cross-device", counts)
    want = [t.cpu() for t in AutoBackend(pt2, device="cpu")(u8)]
    rec = {**output_errors(got, want), "box_tol_px": BOX_TOL_PX,
           "score_tol": SCORE_TOL, **cfg}
    npz = npz_of(torch, y, tmp / "tiny.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dedark_yolo_tpu_torch", "export",
         f"model={npz}", "format=pt2", f"imgsz={cfg['imgsz']}",
         f"batch={cfg['batch']}", f"project={tmp / 'cli'}"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    cli = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
           "written": (tmp / "cli" / "model.pt2").is_file()}
    if proc.returncode:
        cli["stderr"] = proc.stderr[-2000:]
    rec["cli"] = cli
    rec["ok"] = (rec["box_max_abs_err_px"] <= BOX_TOL_PX
                 and rec["score_max_abs_err"] <= SCORE_TOL
                 and cli["rc"] == 0 and cli["written"])
    return rec


def phase_export(torch, yolo, frames, smi):
    """The deployment path on the card (see EXPORT_*): export, the
    artifact against the live model (f32, half, reference mode), predict,
    val, serve and benchmark(formats=) of the artifact, the cross-device
    run and the CLI's export. Each artifact call launches its kernel once,
    the exports none, nms once a predict or val batch."""
    import tempfile
    from dedark_yolo_tpu_torch import YOLO
    counts = tally()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fwd = export_forward(torch, yolo, letterboxed(frames), tmp, counts)
        art = YOLO(fwd["f32"]["path"])
        pv = export_predict_val(torch, yolo, art, frames, tmp, counts)
        sb = export_serve_bench(torch, yolo, art, frames, tmp, counts)
        tiny = export_tiny(torch, tmp, counts)
    rec = {"phase": "export", "card": smi, "model": "yolov8l.yaml",
           "imgsz": IMGSZ, "batch": BATCH, "forward": fwd,
           "predict": pv["predict"], "val": pv["val"], "serve": sb["serve"],
           "benchmark": sb["benchmark"], "tiny": tiny,
           "launches": counts.total,
           "ok": (all(r["ok"] for r in fwd.values()) and pv["ok"]
                  and sb["ok"] and tiny["ok"])}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("export: a check failed (see the record)")
    return rec


# classify phase: yolov8l-cls at full width, nc from the data, on a seeded
# class-folder tree of .npy sidecars beside empty .jpg placeholders (the
# classes' mean colours apart, noise within; mixed sizes, cv2 blocked).
# The card's probabilities against the CPU's (TF32 off) within
# CLS_PROBS_TOL: f32 logits whose convolutions sum in another order than
# the CPU's, through a softmax over 10 classes; top-1 and top-5 equal. An
# exported .pt2 against the live model at CLS_EXPORT_TOL (the program
# against eager on one card).
CLS = {"model": "yolov8l-cls.yaml", "classes": 10, "train": 16, "val": 4,
       "imgsz": 224, "batch": 32, "epochs": 2, "predict": 16,
       "parity_imgsz": 128, "parity_batch": 4}
CLS_PROBS_TOL, CLS_EXPORT_TOL = 1e-4, 1e-5
CLS_METRICS = ("metrics/accuracy_top1", "metrics/accuracy_top5")


def cls_dataset(root, seed):
    """root/{train,val}/class{c}/{k}.npy (+ k.jpg placeholders): a class's
    images its own mean colour plus noise, each of its own size."""
    import numpy as np
    rng = np.random.default_rng(seed)
    means = rng.integers(40, 216, (CLS["classes"], 3))
    for split in ("train", "val"):
        for c in range(CLS["classes"]):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for k in range(CLS[split]):
                h, w = (int(v) for v in rng.integers(160, 400, 2))
                img = means[c] + rng.normal(0, 30, (h, w, 3))
                write_sidecar(d, None, str(k),
                              np.clip(img, 0, 255).astype(np.uint8), None)
    return root


def probs_compare(gpu, cpu):
    """Two lists of classify Results: the largest probability error and
    whether every image's top-1 and top-5 agree."""
    import numpy as np
    err = max(float(np.abs(g.probs.data - c.probs.data).max())
              for g, c in zip(gpu, cpu))
    same = len(gpu) == len(cpu) and all(
        g.probs.top1 == c.probs.top1 and g.probs.top5 == c.probs.top5
        for g, c in zip(gpu, cpu))
    return err, same


def classify_parity(torch):
    """One SGD micro-step of yolov8l-cls at 128, b4 (nbs = batch: the
    update applies) on the card and on the CPU from one seeded state and
    batch, TF32 off: loss, gradients, update, BN stats and EMA held to the
    train phase's TRAIN_TOL (tools/c14_split.step_errors)."""
    import numpy as np
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.engine.classify import ClassificationTrainer
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.tools.c14_split import step_errors
    n, sz = CLS["parity_batch"], CLS["parity_imgsz"]
    over = {"batch": n, "nbs": n, "optimizer": "SGD", "imgsz": sz}
    gpu = YOLO(CLS["model"], nc=CLS["classes"], seed=SEED)
    cpu = YOLO(CLS["model"], nc=CLS["classes"], device="cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    start = {k: v.cpu().clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(SEED + 91)
    batch = {"img": rng.integers(0, 256, (n, sz, sz, 3), np.uint8),
             "cls": rng.integers(0, CLS["classes"], n).astype(np.int32)}
    got = {}
    with matmul_precision("float32"), no_plain_on_cuda():
        for key, yolo, dev in (("gpu", gpu, None), ("cpu", cpu, "cpu")):
            tr = ClassificationTrainer(yolo.model, over, nb=1000, device=dev)
            names = list(tr.params)
            tr.model.train()
            total, items = tr.loss(tr.to_device(batch))
            grads = torch.autograd.grad(
                total, [tr.params[k] for k in names], allow_unused=True)
            tr.model.eval()
            tr.model.load_state_dict(start)
            _, step_items = tr.step(batch, 1500)
            got[key] = {"items": items, "step_items": step_items,
                        "grads": {k: g for k, g in zip(names, grads)
                                  if g is not None},
                        "state": tr.model.state_dict(), "ema": tr.ema,
                        "updates": (tr.opt_state.step, tr.ema_updates)}
    return {"model": CLS["model"], "imgsz": sz, "batch": n,
            **step_errors(got["gpu"], got["cpu"], start)}


def cls_cli_val(torch, best, root):
    """`python -m dedark_yolo_tpu_torch classify val model=<best>` in a
    subprocess, its printed metrics against YOLO(best).val() here under the
    subprocess's TF32 defaults (cuDNN on, matmuls off)."""
    import os
    import subprocess
    from dedark_yolo_tpu_torch import YOLO
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT),
                                          os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dedark_yolo_tpu_torch",
                        "classify", "val", f"model={best}", f"data={root}",
                        "cache=disk", "batch=16"], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("results ")]
    if p.returncode or not lines:
        raise AssertionError(f"classify cli: rc {p.returncode}\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    got = json.loads(lines[-1][8:])
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = YOLO(str(best)).val(data=str(root), cache="disk", batch=16)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return {"rc": p.returncode, "seconds": time.perf_counter() - t0,
            "results": got, "facade_val": want, "equal": got == want}


def phase_classify(torch):
    """The classify task end to end at full width (see CLS): train, the
    micro-step's parity, val and predict card against CPU, the pt2
    artifact, the CLI; zero kernel launches on every card run."""
    import tempfile
    import numpy as np
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.data import imgops
    from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend
    from dedark_yolo_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    launches = {k: 0 for k in ("fused_enhance", "usm", "int8_conv", "nms")}
    failed = []

    def card(name, fn):
        """fn() on the card with the launches counted (none expected)."""
        zero_launches()
        with no_plain_on_cuda():
            out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        check_launches(f"classify {name}", got, {})
        for k in launches:
            launches[k] += got.get(k, 0)
        return out

    with tempfile.TemporaryDirectory() as tmp, no_cv2():
        tmp = Path(tmp)
        root = cls_dataset(tmp / "cls", SEED + 90)
        data = str(root)
        # train at full width, nc from the data
        yolo = YOLO(CLS["model"], seed=SEED)
        t0 = time.perf_counter()
        res = card("train", lambda: yolo.train(
            data=data, imgsz=CLS["imgsz"], batch=CLS["batch"],
            epochs=CLS["epochs"], cache="disk", workers=8,
            project=str(tmp / "runs"), name="cls", plots=False,
            verbose=False))
        train_s = time.perf_counter() - t0
        tr = yolo.trainer
        best = tmp / "runs" / "cls" / "weights" / "best.npz"
        train = {"seconds": train_s, "metrics": res,
                 "images_per_s": [e["batches"] * CLS["batch"] / e["train_s"]
                                  for e in tr.epoch_stats],
                 "epoch_train_s": [e["train_s"] for e in tr.epoch_stats],
                 "params": sum(p.numel() for p in tr.model.parameters()),
                 "nc": tr.model.nc, "best_npz": best.is_file()}
        if not (best.is_file() and tr.model.nc == CLS["classes"]
                and len(tr.epoch_stats) == CLS["epochs"]):
            failed.append("train")
        emit({"phase": "classify", "train": train})
        parity = classify_parity(torch)
        emit({"phase": "classify", "parity": parity})
        if not parity["ok"]:
            failed.append("parity")

        # val and predict of best.npz, card against CPU (TF32 off)
        gpu, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
        vkw = {"data": data, "cache": "disk", "batch": 16}
        val_g = card("val", lambda: gpu.val(**vkw))
        val_c = cpu.val(device="cpu", **vkw)
        frames = [np.load(f) for f in
                  sorted((root / "val").rglob("*.npy"))[:CLS["predict"]]]
        pkw = {"batch": CLS["predict"], "imgsz": CLS["imgsz"]}
        pred_g = card("predict", lambda: gpu.predict(list(frames), **pkw))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            card("predict", lambda: gpu.predict(list(frames), **pkw))
            times.append(time.perf_counter() - t0)
        pred_c = cpu.predict(list(frames), device="cpu", **pkw)
        perr, psame = probs_compare(pred_g, pred_c)
        vp = {"val_cuda": val_g, "val_cpu": val_c,
              "val_equal": all(val_g[k] == val_c[k] for k in CLS_METRICS),
              "predict_images_per_s": [len(frames) / t for t in times],
              "predict_max_abs_err": perr, "predict_top_equal": psame,
              "tol": CLS_PROBS_TOL}
        emit({"phase": "classify", "val_predict": vp})
        if not (vp["val_equal"] and psame and perr <= CLS_PROBS_TOL):
            failed.append("val/predict card vs CPU")

        # the pt2 artifact at b16/224 against the live model
        t0 = time.perf_counter()
        path = card("export", lambda: gpu.export(
            format="pt2", imgsz=CLS["imgsz"], batch=CLS["predict"],
            project=str(tmp / "export")))
        export_s = time.perf_counter() - t0
        be = AutoBackend(path)
        u8 = np.stack([imgops.resize_linear(f, (CLS["imgsz"], CLS["imgsz"]))
                       [..., ::-1] for f in frames])
        (art,) = card("artifact", lambda: be.forward(u8))
        with torch.no_grad():
            (live,) = gpu.model.eval_outputs(
                torch.from_numpy(np.ascontiguousarray(u8)).cuda().float()
                / 255.0)
        aerr = float((art - live).abs().max())
        art_yolo = YOLO(path)
        pred_a = card("artifact predict",
                      lambda: art_yolo.predict(list(frames)))
        perr_a, psame_a = probs_compare(pred_a, pred_g)
        val_a = card("artifact val", lambda: art_yolo.val(data=data,
                                                          cache="disk"))
        ex = {"seconds": export_s, "mb": Path(path).stat().st_size / 1e6,
              "task": be.task, "probs_max_abs_err": aerr,
              "predict_max_abs_err": perr_a, "predict_top_equal": psame_a,
              "val": val_a,
              "val_equal": all(val_a[k] == val_g[k] for k in CLS_METRICS),
              "tol": CLS_EXPORT_TOL}
        emit({"phase": "classify", "export": ex})
        if not (be.task == "classify" and aerr <= CLS_EXPORT_TOL
                and perr_a <= CLS_EXPORT_TOL and psame_a and ex["val_equal"]):
            failed.append("export")
        cli = cls_cli_val(torch, best, root)
        emit({"phase": "classify", "cli": cli})
        if not cli["equal"]:
            failed.append("cli")
    summary = {"phase": "classify", "model": CLS["model"],
               "train_images_per_s": train["images_per_s"],
               "val_top1_top5": [val_g[k] for k in CLS_METRICS],
               "predict_images_per_s": vp["predict_images_per_s"],
               "launches": launches, "seconds": time.perf_counter() - t_phase,
               "failed": failed}
    emit(summary)
    if failed:
        raise AssertionError(f"classify: {failed}")
    return summary


# ------------------------------------------------------------------ segment
# The segment task at full width (yolov8l-seg, nc 3 from the data) on a
# seeded polygon dataset of .npy sidecars, cv2 blocked. Bars, TF32 off for
# every card-against-CPU check: the 128 b2 micro-step to the train phase's
# TRAIN_TOL; val card vs CPU as the val phase holds detect's (counts equal,
# detections paired within BOX_TOL_PX and SCORE_TOL with equal box TP rows,
# the four mAPs within VAL_METRIC_RTOL) and each pair's mask TP row equal;
# predict card vs CPU: per image, the detections above a conf in a wide gap
# of the card's scores paired at the same bars and each pair's mask at the
# original size differing in at most SEG_MASK_PIXELS pixels beyond a band
# one proto pixel wide along its box's perimeter (a box edge within its
# error of a proto pixel's centre crops or keeps that whole row), and on
# the first SEG["logit_frames"] frames each pair's mask logits within
# SEG_LOGIT_RTOL of the largest sum of |coefficient x proto| inside both
# boxes (a pixel flips only where its logit is within that error of 0);
# the pt2 artifact's four
# outputs against the live eval_outputs (boxes EXPORT_BOX_TOL_PX, the rest
# SEG_EXPORT_TOL), its val equal to live and its predict paired at the
# export phase's bars; the CLI's `segment val` equal to the facade's.
SEG = {"model": "yolov8l-seg.yaml", "classes": 3, "train": 64, "val": 16,
       "imgsz": 640, "batch": 16, "epochs": 2, "copy_paste": 0.5,
       "sides": (320, 641), "instances": (1, 7), "parity_imgsz": 128,
       "parity_batch": 2, "predict_reps": 2, "logit_frames": 8}
SEG_MASK_PIXELS = 256
SEG_LOGIT_RTOL = 1e-3
SEG_EXPORT_TOL = 1e-5
SEG_METRICS = ("metrics/mAP50(B)", "metrics/mAP50-95(B)",
               "metrics/mAP50(M)", "metrics/mAP50-95(M)")


def seg_dataset(root, seed):
    """root/{images,labels}/{train,val}: SEG's counts of images of mixed
    sizes (each side in SEG["sides"]), each with 1-6 polygon instances
    (star-shaped, 5-11 vertices, often overlapping) painted in their class
    colour, written as .npy sidecars with `cls x1 y1 ...` label rows.
    Returns the dataset dict."""
    import numpy as np
    from dedark_yolo_tpu_torch.data import imgops
    rng = np.random.default_rng(seed)
    colors = rng.integers(40, 230, (SEG["classes"], 3))
    for split in ("train", "val"):
        img_dir, lbl_dir = root / "images" / split, root / "labels" / split
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        for k in range(SEG[split]):
            h, w = (int(v) for v in rng.integers(*SEG["sides"], 2))
            img = rng.integers(60, 120, (h, w, 3)).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(*SEG["instances"]))):
                c = int(rng.integers(0, SEG["classes"]))
                cx, cy = rng.uniform(0.15, 0.85, 2) * (w, h)
                ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(5, 12))))
                rad = rng.uniform(0.08, 0.3) * min(h, w) * rng.uniform(
                    0.55, 1.0, len(ang))
                pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                               1).clip(0, (w - 1, h - 1))
                m = imgops.fill_poly(np.zeros((h, w), np.uint8),
                                     pts.astype(np.int32), 1)
                img[m > 0] = colors[c]
                rows.append(f"{c} " + " ".join(
                    f"{v:.5f}" for v in (pts / (w, h)).reshape(-1)))
            img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
            write_sidecar(img_dir, lbl_dir, str(k), img.astype(np.uint8), rows)
    return {"path": str(root), "train": "images/train", "val": "images/val",
            "names": {i: f"s{i}" for i in range(SEG["classes"])}}


class record_seg(record_detections):
    """record_detections of the segment validator: each image's box
    branch (native boxes, classes, TP matrix) in `images`, its mask TP
    matrix in `mask_tps`, the scores from the box branch's
    DetMetrics.process."""

    def __enter__(self):
        import numpy as np
        from dedark_yolo_tpu_torch.engine import segment as S
        self.module, self.match = S, S.match_predictions
        self.match_iou, self.process = S.match_from_iou, S.DetMetrics.process
        self.images, self.gts, self.mask_tps = [], [], []
        self.scores, self.n_process = np.zeros(0, np.float32), 0

        def recorded(pred_boxes, pred_cls, gt_boxes, gt_cls):
            tp = self.match(pred_boxes, pred_cls, gt_boxes, gt_cls)
            self.images.append((np.array(pred_boxes), np.array(pred_cls), tp))
            self.gts.append((np.array(gt_boxes), np.array(gt_cls)))
            self.mask_tps.append(np.zeros((len(pred_cls), 10), bool))
            return tp

        def recorded_iou(iou, *args):
            tp = self.match_iou(iou, *args)
            self.mask_tps[-1] = tp
            return tp

        def processed(metrics, tp, conf, pred_cls, target_cls):
            if self.n_process == 0:
                self.scores = np.array(conf)
            self.n_process += 1
            return self.process(metrics, tp, conf, pred_cls, target_cls)
        S.match_predictions, S.match_from_iou = recorded, recorded_iou
        S.DetMetrics.process = processed
        return self

    def __exit__(self, *exc):
        self.module.match_predictions = self.match
        self.module.match_from_iou = self.match_iou
        self.module.DetMetrics.process = self.process


def seg_mask_pairs(g, c, conf, box_tol, score_tol, imgsz=IMGSZ):
    """Two segment Results of one image: the detections above `conf`
    paired as pair_results pairs them. A record: the counts, and where
    every one pairs the box and score errors, the most pixels in which a
    pair's masks differ, that count less its allowance (SEG_MASK_PIXELS
    plus a band one proto pixel wide along the box's perimeter, upsampled:
    a box edge within its error of a proto pixel's centre crops or keeps
    that whole row or column) and the pairs; else the first unpaired
    detection's nearest box and score gaps."""
    import numpy as np
    gk, ck = g.boxes.conf > conf, c.boxes.conf > conf
    gd, cd = g.boxes.data[gk], c.boxes.data[ck]
    gm, cm = g.masks.data[gk], c.masks.data[ck]
    rec = {"counts": [len(gd), len(cd)], "paired": False}
    if len(gd) != len(cd):
        return rec
    h0, w0 = c.orig_shape
    up = 4 / min(imgsz / h0, imgsz / w0)      # a proto pixel, native px
    free, box_err, score_err, diff, excess = list(range(len(gd))), [], [], [], []
    for i in range(len(cd)):
        for j in free:
            db = float(np.abs(gd[j, :4] - cd[i, :4]).max())
            ds = abs(float(gd[j, 4] - cd[i, 4]))
            if gd[j, 5] == cd[i, 5] and db <= box_tol and ds <= score_tol:
                free.remove(j)
                box_err.append(db)
                score_err.append(ds)
                n = int((gm[j] != cm[i]).sum())
                bw, bh = cd[i, 2] - cd[i, 0], cd[i, 3] - cd[i, 1]
                diff.append(n)
                excess.append(n - SEG_MASK_PIXELS - 2 * (bw + bh + 2) * up)
                break
        else:
            near = min(free, key=lambda j: float(np.abs(gd[j, :4] - cd[i, :4]).max()))
            rec.update(unpaired_rank=i, nearest_box_px=float(
                np.abs(gd[near, :4] - cd[i, :4]).max()), nearest_score=abs(
                float(gd[near, 4] - cd[i, 4])), same_class=bool(
                gd[near, 5] == cd[i, 5]))
            return rec
    rec.update(paired=True, box_max_abs_err_px=max(box_err, default=0.0),
               score_max_abs_err=max(score_err, default=0.0),
               mask_max_diff_px=max(diff, default=0),
               mask_max_excess_px=float(max(excess, default=-SEG_MASK_PIXELS)),
               pairs=len(cd))
    return rec


def seg_logit_parity(torch, gpu, cpu, frames, conf):
    """The predictor's mask logits on the card against the CPU's for the
    letterboxed frames (eval_outputs, NMS with return_idx at `conf`,
    `engine.segment.mask_logits`, TF32 off): detections paired (box
    BOX_TOL_PX, score SCORE_TOL), then for each pair inside both boxes in
    proto space the largest logit error over the largest sum of |coefficient
    x proto| of the 32 terms a logit adds (the size of the sum's rounding,
    which cancellation in the logit itself does not shrink; a pixel flips
    only where its logit is within that error of 0), and whether the
    pixels inside one box only lie within one proto pixel of a box edge."""
    import numpy as np
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.engine import segment as S
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.ops.nms import non_max_suppression
    s = SEG["imgsz"]
    u8 = np.ascontiguousarray(np.stack([letterbox(f, s)[0][..., ::-1]
                                        for f in frames]))
    got = {}
    for key, y, dev in (("gpu", gpu, "cuda"), ("cpu", cpu, "cpu")):
        with torch.no_grad(), matmul_precision("float32"):
            b, sc, cf, pr = y.model.eval_outputs(
                torch.from_numpy(u8).to(dev).float() / 255.0)
            dets, counts, aidx = non_max_suppression(
                b.float(), sc.float(), conf_thres=conf, iou_thres=0.7,
                max_det=MAX_DET, max_nms=2048, multi_label=False,
                return_idx=True)
            got[key] = [t.cpu().numpy() for t in
                        (dets, counts, S.mask_logits(dets, aidx, cf, pr),
                         S.mask_logits(dets, aidx, cf.abs(), pr.abs()))]
    (gd, gn, gl, _), (cd, cn, cl, cs) = got["gpu"], got["cpu"]
    mh = gl.shape[2]
    k = mh / s
    grid = np.arange(mh, dtype=np.float32)
    rec = {"conf": conf, "pairs": 0, "logit_max_rel_err": 0.0,
           "edge_only": True, "sign_flips": 0, "images_paired": 0}
    for i in range(len(frames)):
        if gn[i] != cn[i]:
            continue
        n = int(cn[i])
        free, ok = list(range(n)), True
        for a in range(n):
            for j in free:
                if (gd[i, j, 5] == cd[i, a, 5]
                        and np.abs(gd[i, j, :4] - cd[i, a, :4]).max() <= BOX_TOL_PX
                        and abs(gd[i, j, 4] - cd[i, a, 4]) <= SCORE_TOL):
                    free.remove(j)
                    break
            else:
                ok = False
                break
            inbox = []
            for box in (gd[i, j, :4] * k, cd[i, a, :4] * k):
                inbox.append(((grid[None, :] >= box[0]) & (grid[None, :] < box[2])
                              & (grid[:, None] >= box[1]) & (grid[:, None] < box[3])))
            both = inbox[0] & inbox[1]
            lg, lc = gl[i, j], cl[i, a]
            if both.any():
                rel = float(np.abs(lg - lc)[both].max()
                            / max(cs[i, a][both].max(), 1e-12))
                rec["logit_max_rel_err"] = max(rec["logit_max_rel_err"], rel)
                rec["sign_flips"] += int(((lg > 0) != (lc > 0))[both].sum())
            box = cd[i, a, :4] * k
            near = ((np.abs(grid - box[0]) < 1) | (np.abs(grid - box[2]) < 1))[None, :] \
                | ((np.abs(grid - box[1]) < 1) | (np.abs(grid - box[3]) < 1))[:, None]
            rec["edge_only"] &= bool(near[inbox[0] != inbox[1]].all())
            rec["pairs"] += 1
        rec["images_paired"] += ok
    rec["ok"] = (rec["images_paired"] == len(frames) and rec["pairs"] > 0
                 and rec["edge_only"]
                 and rec["logit_max_rel_err"] <= SEG_LOGIT_RTOL)
    return rec


def seg_pair_conf(scores, lo=20, hi=60):
    """A conf for the card-vs-CPU pairing from the card's per-image scores
    at conf 0.001: midway across the widest gap between two consecutive
    scores of all images pooled, among the gaps that leave lo to hi
    detections an image on average (no list cut at max_det, and enough
    detections to pair)."""
    import numpy as np
    pool = np.sort(np.concatenate([np.asarray(x) for x in scores]))[::-1]
    n = len(scores)
    a, b = min(lo * n, len(pool) - 2), min(hi * n, len(pool) - 1)
    if b <= a:
        return 0.001
    gaps = pool[a:b] - pool[a + 1:b + 1]
    k = a + int(np.argmax(gaps))
    return float((pool[k] + pool[k + 1]) / 2)


def seg_predict_pairs(gpu, cpu, conf, box_tol, score_tol):
    """seg_mask_pairs of every image at one conf, folded: images paired,
    pairs, the largest errors, the first failing image's record."""
    recs = [seg_mask_pairs(g, c, conf, box_tol, score_tol)
            for g, c in zip(gpu, cpu)]
    good = [r for r in recs if r["paired"]]
    out = {"conf": conf, "images": len(recs), "paired": len(good),
           "pairs": sum(r["pairs"] for r in good),
           "box_max_abs_err_px": max((r["box_max_abs_err_px"] for r in good),
                                     default=0.0),
           "score_max_abs_err": max((r["score_max_abs_err"] for r in good),
                                    default=0.0),
           "mask_max_diff_px": max((r["mask_max_diff_px"] for r in good),
                                   default=0),
           "mask_max_excess_px": max((r["mask_max_excess_px"] for r in good),
                                     default=-SEG_MASK_PIXELS),
           "mask_tol_px": SEG_MASK_PIXELS}
    bad = [(k, r) for k, r in enumerate(recs) if not r["paired"]]
    if bad:
        out["first_unpaired"] = {"image": bad[0][0], **bad[0][1]}
    return out


def seg_loader_split(data, max_boxes):
    """The loader's work for one train batch on this host, one thread: the
    batch's 16 items through SegTrainTransforms (mosaic, copy-paste,
    affine, photometric, HSV, flip), then `collate_segment`, whose
    ground-truth raster (`imgops.fill_poly` and `resize_linear` of every
    instance, numpy) is the part a native port would take."""
    import random
    from dedark_yolo_tpu_torch.cfg import get_cfg
    from dedark_yolo_tpu_torch.data.dataset import check_det_dataset
    from dedark_yolo_tpu_torch.data.segment import (
        SegmentDataset, SegTrainTransforms, collate_segment)
    from dedark_yolo_tpu_torch.engine.segment import SEG_AUGMENT_KEYS
    s = SEG["imgsz"]
    ds = SegmentDataset(check_det_dataset(data)["train"], imgsz=s,
                        nc=SEG["classes"], cache="disk")
    a = get_cfg({"copy_paste": SEG["copy_paste"]})
    tf = SegTrainTransforms({k: getattr(a, k) for k in SEG_AUGMENT_KEYS}, s)
    t0 = time.perf_counter()
    items = [tf(ds, i, random.Random(SEED + i)) for i in range(SEG["batch"])]
    t1 = time.perf_counter()
    collate_segment(items, max_boxes, 4)
    t2 = time.perf_counter()
    return {"instances": int(sum(min(len(p), max_boxes)
                                 for _, _, _, p in items)),
            "items_ms": (t1 - t0) * 1000, "collate_ms": (t2 - t1) * 1000}


def seg_parity(torch, data):
    """One SGD micro-step of yolov8l-seg at 128, b2 (nbs = batch: the
    update applies) on the card and on the CPU from one seeded state and a
    batch of the val split's items, TF32 off: TRAIN_TOL
    (tools/c14_split.step_errors)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.data.dataset import check_det_dataset
    from dedark_yolo_tpu_torch.data.segment import (SegmentDataset,
                                                    collate_segment)
    from dedark_yolo_tpu_torch.engine.predictor import matmul_precision
    from dedark_yolo_tpu_torch.engine.segment import SegmentationTrainer
    from dedark_yolo_tpu_torch.tools.c14_split import step_errors
    n, sz = SEG["parity_batch"], SEG["parity_imgsz"]
    over = {"batch": n, "nbs": n, "optimizer": "SGD", "imgsz": sz,
            "max_boxes": 8}
    gpu = YOLO(SEG["model"], nc=SEG["classes"], seed=SEED)
    cpu = YOLO(SEG["model"], nc=SEG["classes"], device="cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    start = {k: v.cpu().clone() for k, v in cpu.state_dict().items()}
    ds = SegmentDataset(check_det_dataset(data)["val"], imgsz=sz,
                        nc=SEG["classes"], cache="disk")
    batch = collate_segment([ds.load(i) for i in range(n)], max_boxes=8,
                            mask_ratio=4)
    got = {}
    with matmul_precision("float32"), no_plain_on_cuda():
        for key, yolo, dev in (("gpu", gpu, None), ("cpu", cpu, "cpu")):
            tr = SegmentationTrainer(yolo.model, over, nb=1000, device=dev)
            names = list(tr.params)
            tr.model.train()
            total, items = tr.loss(tr.to_device(batch))
            grads = torch.autograd.grad(
                total, [tr.params[k] for k in names], allow_unused=True)
            tr.model.eval()
            tr.model.load_state_dict(start)
            _, step_items = tr.step(batch, 1500)
            got[key] = {"items": items, "step_items": step_items,
                        "grads": {k: g for k, g in zip(names, grads)
                                  if g is not None},
                        "state": tr.model.state_dict(), "ema": tr.ema,
                        "updates": (tr.opt_state.step, tr.ema_updates)}
    return {"model": SEG["model"], "imgsz": sz, "batch": n,
            "instances": int(batch["mask_gt"].sum()),
            **step_errors(got["gpu"], got["cpu"], start)}


def seg_cli_val(torch, best, data_json):
    """`python -m dedark_yolo_tpu_torch segment val model=<best>` in a
    subprocess, its printed metrics against YOLO(best).val() here under the
    subprocess's TF32 defaults (cuDNN on, matmuls off)."""
    import os
    import subprocess
    from dedark_yolo_tpu_torch import YOLO
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT),
                                          os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dedark_yolo_tpu_torch",
                        "segment", "val", f"model={best}",
                        f"data={data_json}", "cache=disk", "batch=16",
                        "plots=False"], capture_output=True, text=True,
                       cwd=str(ROOT), env=env, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("results ")]
    if p.returncode or not lines:
        raise AssertionError(f"segment cli: rc {p.returncode}\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    got = json.loads(lines[-1][8:])
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = YOLO(str(best)).val(data=str(data_json), cache="disk",
                                   batch=16, plots=False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    want = {k: float(v) for k, v in want.items()}
    return {"rc": p.returncode, "seconds": time.perf_counter() - t0,
            "results": got, "facade_val": want, "equal": got == want}


def seg_layer0_graph(path):
    """yolov8-seg.yaml's rows under a lowlight_recovery row 0 (every later
    index shifted by one), written as JSON at `path` (a scaled name, so
    model_yaml_load takes its scale from it)."""
    import copy
    from dedark_yolo_tpu_torch.cfg.models import MODELS
    d = copy.deepcopy(MODELS["yolov8-seg.yaml"])

    def shift(f):
        if isinstance(f, list):
            return [x if x == -1 else x + 1 for x in f]
        return f if f == -1 else f + 1
    d["backbone"] = [[-1, 1, "lowlight_recovery", [3]]] + [
        [shift(f), n, m, a] for f, n, m, a in d["backbone"]]
    d["head"] = [[shift(f), n, m, a] for f, n, m, a in d["head"]]
    Path(path).write_text(json.dumps(d))
    return str(path)


def phase_segment(torch):
    """The segment task end to end at full width (see SEG): train, the
    micro-step's parity, val and predict card against CPU, predict's
    images/s (f32, half) and a retina_masks batch, the pt2 artifact, the
    CLI's val, then a segment graph under layer 0 predicting low-light
    frames. nms launches once a predict or val batch, fused_enhance once a
    batch of the layer-0 graph only, no plain version reached with a CUDA
    tensor."""
    import math
    import tempfile
    import numpy as np
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.data.dataset import check_det_dataset
    from dedark_yolo_tpu_torch.engine import segment as S
    from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend
    from dedark_yolo_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    launches = {k: 0 for k in ("fused_enhance", "usm", "int8_conv", "nms")}
    failed = []
    val_calls = [0]
    val_call = S.SegmentationValidator.__call__

    def counted(self, model=None):
        val_calls[0] += 1
        return val_call(self, model)

    def card(name, fn, expected=lambda: {}):
        """fn() on the card with the launches counted and checked against
        expected() (called after fn: how many val calls a run made)."""
        zero_launches()
        val_calls[0] = 0
        with no_plain_on_cuda():
            out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        check_launches(f"segment {name}", got, expected())
        for k in launches:
            launches[k] += got.get(k, 0)
        return out

    per_val = lambda n, b: {"nms": -(-n // b)}
    mark = [t_phase]

    def report(name, rec):
        """Emit one step's record with the seconds since the last one."""
        now = time.perf_counter()
        rec["step_s"], mark[0] = now - mark[0], now
        emit({"phase": "segment", name: rec})

    S.SegmentationValidator.__call__ = counted
    try:
        with tempfile.TemporaryDirectory() as tmp, no_cv2():
            tmp = Path(tmp)
            data = seg_dataset(tmp / "seg", SEED + 110)
            data_json = tmp / "seg.json"
            data_json.write_text(json.dumps(data))
            # train at full width, nc from the data
            yolo = YOLO(SEG["model"], seed=SEED)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = card("train", lambda: yolo.train(
                data=data, imgsz=SEG["imgsz"], batch=SEG["batch"],
                epochs=SEG["epochs"], copy_paste=SEG["copy_paste"],
                cache="disk", workers=8, project=str(tmp / "runs"),
                name="seg", plots=False, verbose=False),
                lambda: {"nms": val_calls[0]})
            train_s = time.perf_counter() - t0
            tr = yolo.trainer
            best = tmp / "runs" / "seg" / "weights" / "best.npz"
            rows = (tr.csv.read_text().splitlines()
                    if tr.csv.is_file() else [])
            head = rows[0].split(",") if rows else []
            items = [[float(v) for k, v in zip(head, r.split(","))
                      if k.startswith("train/")] for r in rows[1:]]
            train = {
                "seconds": train_s, "metrics": {k: float(v)
                                                for k, v in res.items()},
                "images_per_s": [e["batches"] * SEG["batch"] / e["train_s"]
                                 for e in tr.epoch_stats],
                "loader_wait_s": [e["loader_wait_s"] for e in tr.epoch_stats],
                "epoch_train_s": [e["train_s"] for e in tr.epoch_stats],
                "val_s": [e["val_s"] for e in tr.epoch_stats],
                "loss_items": dict(zip(tr.loss_names,
                                       zip(*items))) if items else {},
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "max_boxes": tr.args.max_boxes,
                "params": sum(p.numel() for p in tr.model.parameters()),
                "nc": tr.model.nc, "best_npz": best.is_file(),
                "loader_split": seg_loader_split(data, tr.args.max_boxes)}
            if not (best.is_file() and tr.model.nc == SEG["classes"]
                    and len(tr.epoch_stats) == SEG["epochs"]
                    and all(math.isfinite(v) for r in items for v in r)):
                failed.append("train")
            report("train", train)
            parity = seg_parity(torch, data)
            report("parity", parity)
            if not parity["ok"]:
                failed.append("parity")

            # val and predict of best.npz, card against CPU (TF32 off), its
            # BN statistics set from the val images first (two short epochs
            # leave the scores near the head's bias init, tied across the
            # letterbox padding; as the val phase calibrates its model)
            vroot = Path(check_det_dataset(data)["val"])
            frames = [np.load(vroot / f"{k}.npy") for k in range(SEG["val"])]
            gpu, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
            calibrate_bn(torch, gpu.model, frames, SEG["imgsz"])
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 gpu.state_dict().items()})
            vkw = {"data": data, "cache": "disk", "batch": SEG["batch"],
                   "plots": False, "matmul_precision": "float32"}
            with record_seg() as r0:
                val_g = card("val", lambda: gpu.val(**vkw),
                             lambda: per_val(SEG["val"], SEG["batch"]))
            val_g = {k: float(v) for k, v in val_g.items()}
            # card vs CPU at a conf that leaves each list short of max_det
            # (seg_pair_conf)
            pkw_val = {**vkw, "conf": seg_pair_conf(
                [d[3] for d in r0.detections()])}
            with record_seg() as rg:
                vg = card("val", lambda: gpu.val(**pkw_val),
                          lambda: per_val(SEG["val"], SEG["batch"]))
            with record_seg() as rc:
                vc = cpu.val(device="cpu", **pkw_val)
            vg = {k: float(v) for k, v in vg.items()}
            vc = {k: float(v) for k, v in vc.items()}
            vrec = {"default_conf": val_g, "pair_conf": pkw_val["conf"],
                    "cuda": vg, "cpu": vc, **compare_images(rg, rc),
                    "metric_max_abs_err": max(abs(vg[k] - vc[k])
                                              for k in SEG_METRICS)}
            if vrec["ok"]:
                pairs = [pair_detections(g, c) for g, c in
                         zip(rg.detections(), rc.detections())]
                vrec["mask_tp_equal"] = all(
                    np.array_equal(mg[j], mc[i])
                    for (order, _, _), mg, mc in zip(pairs, rg.mask_tps,
                                                     rc.mask_tps)
                    for i, j in enumerate(order))
                vrec["cpu_mask_tp50"] = int(sum(m[:, 0].sum()
                                                for m in rc.mask_tps))
            vrec["ok"] = (vrec["ok"] and vrec.get("mask_tp_equal", False)
                          and all(abs(vg[k] - vc[k])
                                  <= VAL_METRIC_RTOL * max(abs(vc[k]), 1e-12)
                                  or vg[k] == vc[k] for k in SEG_METRICS))
            report("val", vrec)
            if not vrec["ok"]:
                failed.append("val card vs CPU")

            pkw = {"batch": SEG["batch"], "imgsz": SEG["imgsz"],
                   "conf": 0.001, "matmul_precision": "float32"}
            batches = {"nms": -(-len(frames) // SEG["batch"])}
            pred_g = card("predict", lambda: gpu.predict(list(frames), **pkw),
                          lambda: batches)
            pred_c = cpu.predict(list(frames), device="cpu", **pkw)
            conf = seg_pair_conf([r.boxes.conf for r in pred_g])
            prec = seg_predict_pairs(pred_g, pred_c, conf, BOX_TOL_PX,
                                     SCORE_TOL)
            prec["logits"] = seg_logit_parity(torch, gpu, cpu,
                                              frames[:SEG["logit_frames"]], conf)
            prec["masks_at_original_size"] = all(
                r.masks.data.shape[1:] == r.orig_shape for r in pred_g)
            for key, half in (("f32", False), ("half", True)):
                times = []
                for _ in range(SEG["predict_reps"]):
                    t0 = time.perf_counter()
                    card(f"predict {key}", lambda: gpu.predict(
                        list(frames), batch=SEG["batch"], imgsz=SEG["imgsz"],
                        half=half), lambda: batches)
                    times.append(time.perf_counter() - t0)
                prec[f"{key}_images_per_s"] = [len(frames) / t for t in times]
            # retina_masks at the conf of the 160th best score of the batch
            # (about 10 masks an image, each upsampled on the host)
            scores = np.sort(np.concatenate([r.boxes.conf for r in pred_g]))
            rconf = float(scores[::-1][min(159, len(scores) - 1)])
            retina = card("predict retina", lambda: gpu.predict(
                list(frames), batch=SEG["batch"], imgsz=SEG["imgsz"],
                conf=rconf, retina_masks=True), lambda: batches)
            prec["retina_masks"] = {
                "conf": rconf, "masks": int(sum(len(r.masks) for r in retina)),
                "at_original_size": all(r.masks.data.shape[1:] == r.orig_shape
                                        for r in retina)}
            report("predict", prec)
            if not (prec["paired"] == len(frames) and prec["pairs"] > 0
                    and prec["mask_max_excess_px"] <= 0 and prec["logits"]["ok"]
                    and prec["masks_at_original_size"]
                    and prec["retina_masks"]["at_original_size"]
                    and prec["retina_masks"]["masks"] > 0):
                failed.append("predict card vs CPU")

            # the pt2 artifact at b16/640 against the live model
            t0 = time.perf_counter()
            path = card("export", lambda: gpu.export(
                format="pt2", imgsz=SEG["imgsz"], batch=SEG["batch"],
                project=str(tmp / "export")))
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            be = AutoBackend(path)
            load_s = time.perf_counter() - t0
            u8 = np.stack([letterbox(f, SEG["imgsz"])[0][..., ::-1]
                           for f in frames])
            art = card("artifact", lambda: be.forward(u8))
            with torch.no_grad():
                live = gpu.model.eval_outputs(
                    torch.from_numpy(np.ascontiguousarray(u8)).cuda().float()
                    / 255.0)
            errs = [float((a - b).abs().max()) for a, b in zip(art, live)]
            art_yolo = YOLO(path)
            val_a = card("artifact val", lambda: art_yolo.val(**vkw),
                         lambda: per_val(SEG["val"], SEG["batch"]))
            val_a = {k: float(v) for k, v in val_a.items()}
            pred_a = card("artifact predict", lambda: art_yolo.predict(
                list(frames), conf=0.001, matmul_precision="float32"),
                lambda: batches)
            apairs = seg_predict_pairs(pred_a, pred_g, 0.0, EXPORT_BOX_TOL_PX,
                                       EXPORT_SCORE_TOL)
            ex = {"seconds": export_s, "load_s": load_s,
                  "mb": Path(path).stat().st_size / 1e6, "task": be.task,
                  "outputs": [list(t.shape) for t in art],
                  "output_max_abs_err": dict(zip(
                      ("boxes", "scores", "coefs", "protos"), errs)),
                  "val": val_a, "val_equal": all(
                      abs(val_a[k] - val_g[k])
                      <= VAL_METRIC_RTOL * max(abs(val_g[k]), 1e-12)
                      for k in SEG_METRICS),
                  "predict": apairs}
            report("export", ex)
            if not (be.task == "segment" and len(art) == 4
                    and errs[0] <= EXPORT_BOX_TOL_PX
                    and max(errs[1:]) <= SEG_EXPORT_TOL and ex["val_equal"]
                    and apairs["paired"] == len(frames)
                    and apairs["mask_max_excess_px"] <= 0):
                failed.append("export")
            cli = seg_cli_val(torch, best, data_json)
            report("cli", cli)
            if not cli["equal"]:
                failed.append("cli")

            # a segment graph under layer 0: fused_enhance once a batch
            l0_path = seg_layer0_graph(tmp / "yolov8l-seg-dedark.json")
            l0 = YOLO(l0_path, nc=SEG["classes"], seed=SEED)
            l0_cpu = YOLO(l0_path, nc=SEG["classes"], device="cpu", seed=SEED)
            dark = synthetic_frames(BATCH)
            calibrate_bn(torch, l0.model, dark)
            l0_cpu.load_state_dict({k: v.cpu() for k, v in
                                    l0.state_dict().items()})
            both = {"fused_enhance": 1, "nms": 1}
            card("layer0 warm-up", lambda: l0.predict(
                list(dark), batch=BATCH), lambda: both)
            t0 = time.perf_counter()
            timed = card("layer0 predict", lambda: l0.predict(
                list(dark), batch=BATCH), lambda: both)
            l0_ips = len(dark) / (time.perf_counter() - t0)
            g1 = card("layer0 one frame", lambda: l0.predict(
                [dark[0]], batch=1, conf=0.001, matmul_precision="float32"),
                lambda: both)
            c1 = l0_cpu.predict([dark[0]], batch=1, conf=0.001, device="cpu",
                                matmul_precision="float32")
            lrec = {"model": "yolov8l-seg.yaml under lowlight_recovery",
                    "params": sum(q.numel() for q in l0.model.parameters()),
                    "images_per_s": l0_ips,
                    "dets_per_image": [min(len(r) for r in timed),
                                       max(len(r) for r in timed)],
                    **seg_predict_pairs(g1, c1, pair_conf(g1[0]), BOX_TOL_PX,
                                        SCORE_TOL)}
            report("layer0", lrec)
            if not (lrec["paired"] == 1 and lrec["pairs"] > 0
                    and lrec["mask_max_excess_px"] <= 0):
                failed.append("layer0 card vs CPU")
    finally:
        S.SegmentationValidator.__call__ = val_call
    summary = {"phase": "segment", "model": SEG["model"],
               "train_images_per_s": train["images_per_s"],
               "val_cuda": val_g,
               "predict_images_per_s": {"f32": prec["f32_images_per_s"],
                                        "half": prec["half_images_per_s"]},
               "launches": launches, "seconds": time.perf_counter() - t_phase,
               "failed": failed}
    emit(summary)
    if failed:
        raise AssertionError(f"segment: {failed}")
    return summary


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
    pred_rs = phase_predict_resize(torch, yolo, pred, frames)
    extras = phase_predict_extras(torch, yolo, frames, pred)
    serve = phase_serve(torch, yolo, frames)
    track = phase_track(torch, yolo)
    bench = phase_benchmark(torch, yolo)
    export = phase_export(torch, yolo, frames, smi)
    zoo = phase_zoo(torch, frames)
    cls = phase_classify(torch)
    seg = phase_segment(torch)
    probe_launches = phase_probe(torch)
    train = phase_train(torch)
    val = phase_val(torch, yolo)
    val_rs = phase_val_resize(torch, yolo)
    dark = phase_darkset(torch, yolo)
    loop = phase_train_loop(torch)
    loop_mp = phase_loop_mp(torch)
    c10 = phase_c10(torch)
    amp = phase_train_amp(torch, train)
    phase_cli(torch)

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
        "val_launches": val["launches"]["fused_enhance"],
        "train_loop_launches": sum(r["launches"]["fused_enhance"]
                                   for r in loop["runs"]),
        "c10_launches": c10["launches"]["fused_enhance"],
        "train_amp_launches": amp["launches"]["fused_enhance"],
        "predict_resize_launches": pred_rs["launches"]["fused_enhance"],
        "predict_extras_launches": extras["launches"]["fused_enhance"],
        "zoo_launches": zoo["launches"]["fused_enhance"],
        "zoo_amp_launches": zoo["amp_launches"]["fused_enhance"],
        "classify_launches": cls["launches"]["fused_enhance"],
        "segment_launches": seg["launches"]["fused_enhance"],
        "serve_launches": serve["launches"]["fused_enhance"],
        "track_launches": track["launches"]["fused_enhance"],
        "benchmark_launches": bench["launches"]["fused_enhance"],
        "export_launches": export["launches"]["fused_enhance"],
        "val_resize_launches": val_rs["launches"]["fused_enhance"],
        "darkset_launches": dark["launches"]["fused_enhance"],
        "loop_mp_launches": loop_mp["launches"]["fused_enhance"],
        "autobatch_launches":
            loop_mp["autobatch"]["launches"]["fused_enhance"]}, {
        "name": "usm", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/usm.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/enhance_kernel.py:277",
        "launches": pred["reference_f32"]["launches"]["usm"],
        **{k: usm_timing["float32"][k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": [BATCH, IMGSZ, IMGSZ, 3], "dtype": "float32",
        "bf16": usm_timing["bfloat16"], "val_launches": val["launches"]["usm"],
        "val_reference_launches": val["reference_launches"]["usm"],
        "predict_extras_launches": extras["launches"]["usm"],
        "zoo_launches": zoo["launches"]["usm"],
        "classify_launches": cls["launches"]["usm"],
        "segment_launches": seg["launches"]["usm"],
        "export_launches": export["launches"]["usm"]}, {
        "name": "int8_conv", "route": "cuda",
        "source": "dedark_yolo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "dedark_yolo_tpu/ops/pallas/int8_conv.py:133",
        "launches": probe_launches["int8_conv"],
        **{k: int8_timing[k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": list(INT8_SHAPES[0]), "dtype": "int8",
        **{k: int8_timing[k] for k in ("act", "tops", "peak_pct")},
        "val_launches": val["launches"]["int8_conv"],
        "classify_launches": cls["launches"]["int8_conv"],
        "segment_launches": seg["launches"]["int8_conv"]}, {
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
        "val_launches": val["launches"]["nms"],
        "train_loop_launches": sum(r["launches"]["nms"] for r in loop["runs"]),
        "c10_launches": c10["launches"]["nms"],
        "predict_resize_launches": pred_rs["launches"]["nms"],
        "predict_extras_launches": extras["launches"]["nms"],
        "zoo_launches": zoo["launches"]["nms"],
        "classify_launches": cls["launches"]["nms"],
        "segment_launches": seg["launches"]["nms"],
        "serve_launches": serve["launches"]["nms"],
        "track_launches": track["launches"]["nms"],
        "benchmark_launches": bench["launches"]["nms"],
        "export_launches": export["launches"]["nms"],
        "val_resize_launches": val_rs["launches"]["nms"],
        "darkset_launches": dark["launches"]["nms"],
        "loop_mp_launches": loop_mp["launches"]["nms"],
        "autobatch_launches": loop_mp["autobatch"]["launches"]["nms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
