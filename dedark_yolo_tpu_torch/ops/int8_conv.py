"""W8A8 3x3 stride-1 SAME convolution: wrapper of `csrc/int8_conv.cu`.

Port of `dedark_yolo_tpu/ops/pallas/int8_conv.py`. The public function keeps
the JAX signature and layouts (NHWC input padded by the caller, HWIO weight,
per-output-channel f32 scale); the JAX `th` and `taps` arguments choose the
TPU kernel's VMEM tiling and have no counterpart here, so they are left out.
On a CUDA tensor the wrapper runs the kernel or raises; on a CPU tensor it
runs `conv3x3_s1_w8a8_reference`, the plain version the kernel is held
against.
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


@lru_cache(maxsize=1)
def _launch_fn():
    fn = _build.load(NAME).int8_conv_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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
    if C % 32 or Co % 8:
        raise ValueError(f"the kernel needs C % 32 == 0 and Co % 8 == 0, got "
                         f"C={C}, Co={Co}")
    if not x_padded.is_contiguous() or x_padded.data_ptr() % 16:
        raise ValueError("x_padded must be contiguous and 16-byte aligned")
    if any(t.device != x_padded.device for t in (w, scale)):
        raise ValueError("conv3x3_s1_w8a8 inputs must share one device")
    wt = w.permute(3, 0, 1, 2).reshape(Co, 9 * C).contiguous()  # K-contiguous
    s = scale.float().contiguous()
    out = torch.empty((B, H, W, Co), dtype=torch.int8, device=x_padded.device)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        rc = _launch_fn()(x_padded.data_ptr(), wt.data_ptr(), s.data_ptr(),
                          out.data_ptr(), B, H, W, C, Co, 1.0 / out_scale,
                          int(act == "silu"), stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv launch failed with CUDA error {rc}")
    _build.LAUNCHES[NAME] += 1
    return out
