"""W8A8 3x3 stride-1 SAME convolution: wrapper of `csrc/int8_conv.cu`.

Port of `dedark_yolo_tpu/ops/pallas/int8_conv.py`. The public function keeps
the JAX signature and layouts (NHWC input padded by the caller, HWIO weight,
per-output-channel f32 scale); the JAX `th` and `taps` arguments choose the
TPU kernel's VMEM tiling and have no counterpart here, so they are left out.
On a CUDA tensor the wrapper runs the kernel or raises; on a CPU tensor it
runs `conv3x3_s1_w8a8_reference`, the plain version the kernel is held
against. `kernel_plan` is the launch plan (K block, tile, grid, TMA boxes,
shared memory) in plain Python, so the CPU tests check it; the wrapper
passes its K block and ring depth to the launch. The tile constants and
`smem_bytes` mirror `csrc/int8_conv.cu`, which owns them: a CPU test reads
the constants from the source, and the card's smoke run holds `smem_bytes`
to the library's `int8_conv_smem_bytes`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from . import _build

NAME = "int8_conv"
_build.LAUNCHES.setdefault(NAME, 0)
ACTS = (None, "silu")

# The kernel's fixed tile (csrc/int8_conv.cu): 16 x 8 output pixels (two
# consumer warpgroups of 8 rows each) by 128 output channels.
TH, TW, BN = 16, 8, 128
BM = TH * TW
MAX_STAGES = 8
# two blocks share an SM: 228 KB of shared memory less 1 KB each the
# system reserves, halved
SMEM_LIMIT = 115_712
SMEM_ALIGN = 1024             # the 128-byte swizzle repeats every 1024 bytes


def smem_bytes(bk, stages):
    """Dynamic shared memory of a launch (the .cu's `smem_bytes`): two
    input halos of (TH+2)(TW+2) rows of bk bytes, each rounded up to
    SMEM_ALIGN, and the ring of weight stages, which the epilogue reuses for
    the int32 tile (BM rows of BN + 8 ints); a full and an empty mbarrier
    per stage and per halo; slack to align the first halo."""
    halo = -(-(TH + 2) * (TW + 2) * bk // SMEM_ALIGN) * SMEM_ALIGN
    return (SMEM_ALIGN + max(2 * halo + stages * BN * bk, BM * (BN + 8) * 4)
            + 16 * (stages + 2))


def kernel_plan(B, H, W, C, Co):
    """Launch plan of `csrc/int8_conv.cu` for an unpadded (B, H, W, C -> Co)
    conv: the K block, tile, grid, the two TMA boxes and shared memory.

    The M tile is a TH x TW rectangle of output pixels of one image (BM
    rows, row r = ty*TW + tx); the N tile BN output channels. Block i is
    N tile i % tiles_n of M tile i // tiles_n, M tiles in (b, ty, tx) order.
    K runs over C/BK channel blocks, each over the 9 taps: k = (dy*3 + dx)*C
    + c. A is one 4-D TMA box (BK, TW+2, TH+2, 1) of the padded input at
    (c0, x0, y0, b) per channel block, its halo zero-filled past the edge;
    tap (dy, dx) reads it from row dy, column dx. B is a 2-D box (BK, BN) of
    the (Co, 9C) weight repack at (tap*C + c0, n0) per tap. The swizzle span
    equals BK bytes, one shared row of a box.
    """
    if C % 32 or Co % 8:
        raise ValueError(f"the kernel needs C % 32 == 0 and Co % 8 == 0, got "
                         f"C={C}, Co={Co}")
    if min(B, H, W, C, Co) < 1:
        raise ValueError(f"empty conv shape {(B, H, W, C, Co)}")
    bk = 128 if C % 128 == 0 else 64 if C % 64 == 0 else 32
    tiles_y, tiles_x, tiles_n = -(-H // TH), -(-W // TW), -(-Co // BN)
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if smem_bytes(bk, s) <= SMEM_LIMIT)
    Hp, Wp = H + 2, W + 2
    return {
        "bk": bk, "swizzle_bytes": bk, "bm": BM, "bn": BN, "th": TH, "tw": TW,
        "tiles_y": tiles_y, "tiles_x": tiles_x, "tiles_n": tiles_n,
        "blocks": B * tiles_y * tiles_x * tiles_n,
        "c_blocks": C // bk, "stages": stages,
        "halo_bytes": (TH + 2) * (TW + 2) * bk, "stage_bytes": BN * bk,
        "epilogue_bytes": BM * (BN + 8) * 4,
        "smem_bytes": smem_bytes(bk, stages),
        # tensor maps, innermost dimension first; strides in bytes of dims 1..
        "x_dims": (C, Wp, Hp, B), "x_strides": (C, Wp * C, Hp * Wp * C),
        "x_box": (bk, TW + 2, TH + 2, 1),
        "w_dims": (9 * C, Co), "w_strides": (9 * C,), "w_box": (bk, BN),
        # one 8-row wgmma group is one halo row: the A descriptor's stride
        "a_group_stride": (TW + 2) * bk,
    }


def _check(x_padded, w, scale, act):
    if x_padded.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x_padded and w must be int8, got {x_padded.dtype} "
                         f"and {w.dtype}")
    if x_padded.dim() != 4 or x_padded.shape[1] < 3 or x_padded.shape[2] < 3:
        raise ValueError(f"x_padded must be (B, H+2, W+2, C), got "
                         f"{tuple(x_padded.shape)}")
    C = x_padded.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, Co), got {tuple(w.shape)}")
    if tuple(scale.shape) != (w.shape[3],):
        raise ValueError(f"scale must be ({w.shape[3]},), got "
                         f"{tuple(scale.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def conv3x3_s1_w8a8_reference(x_padded, w, scale, out_scale=1.0, act=None):
    """Plain version (JAX `conv3x3_s1_w8a8_reference`): the convolution in
    float64, which is exact for int8 values since |acc| <= 9*C*128^2 < 2^53;
    the requantisation as in JAX, rounding half to even."""
    acc = F.conv2d(x_padded.permute(0, 3, 1, 2).double(),
                   w.permute(3, 2, 0, 1).double())
    y = acc.permute(0, 2, 3, 1).float() * scale.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
        y = y / out_scale
    return torch.round(y).clamp(-128, 127).to(torch.int8)


# int8_conv_launch(x, wt, scale, out, B, H, W, C, Co, inv_out, silu, stream,
#                  bk, stages)
PLAN_ARGS = ("bk", "stages")
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * len(PLAN_ARGS))
# nonzero codes of int8_conv_launch that are not CUDA errors
LAUNCH_ERRORS = {-1: "cuTensorMapEncodeTiled not found in the driver",
                 -2: "cuTensorMapEncodeTiled refused a tensor map",
                 -3: "the plan is outside csrc/int8_conv.cu's variants or "
                     "shared memory"}


@lru_cache(maxsize=1)
def _launch_fn():
    fn = _build.load(NAME).int8_conv_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def conv3x3_s1_w8a8(x_padded, w, scale, out_scale=1.0, act=None):
    """int8 SAME 3x3 stride-1 conv with per-channel requantisation.

    x_padded (B, H+2, W+2, C) int8; w (3, 3, C, Co) int8; scale (Co,) f32.
    act=None: out = q(acc * scale); act='silu': out =
    q(silu(acc * scale) / out_scale), with q = clip(round_half_even, -128,
    127). Returns (B, H, W, Co) int8. The kernel needs C % 32 == 0 and
    Co % 8 == 0.
    """
    _check(x_padded, w, scale, act)
    if x_padded.device.type == "cpu":
        return conv3x3_s1_w8a8_reference(x_padded, w, scale, out_scale, act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"conv3x3_s1_w8a8 runs on cuda or cpu, not "
                         f"{x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    H, W, Co = Hp - 2, Wp - 2, w.shape[3]
    plan = kernel_plan(B, H, W, C, Co)
    if not x_padded.is_contiguous() or x_padded.data_ptr() % 16:
        raise ValueError("x_padded must be contiguous and 16-byte aligned")
    if any(t.device != x_padded.device for t in (w, scale)):
        raise ValueError("conv3x3_s1_w8a8 inputs must share one device")
    wt = w.permute(3, 0, 1, 2).reshape(Co, 9 * C).contiguous()  # K-contiguous
    s = scale.float().contiguous()
    if s.data_ptr() % 16:  # the kernel reads the scales 4 at a time
        s = s.clone()
    out = torch.empty((B, H, W, Co), dtype=torch.int8, device=x_padded.device)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        rc = _launch_fn()(x_padded.data_ptr(), wt.data_ptr(), s.data_ptr(),
                          out.data_ptr(), B, H, W, C, Co, 1.0 / out_scale,
                          int(act == "silu"), stream,
                          *(plan[k] for k in PLAN_ARGS))
    if rc != 0:
        raise RuntimeError(f"int8_conv launch failed: "
                           f"{LAUNCH_ERRORS.get(rc, f'CUDA error {rc}')}")
    _build.LAUNCHES[NAME] += 1
    return out
