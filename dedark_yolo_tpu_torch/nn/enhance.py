"""lowlight_recovery, layer 0 of the detector: the plain PyTorch filter chain.

Port of the JAX package's `nn/enhance.py` (reference ultralytics/nn/modules/
llie.py:11-54): bilinear-resize the NHWC input to 256x256, regress 15 filter
parameters with `ExtractParameters2`, then run DeDark -> WhiteBalance ->
Gamma -> Contrast -> USM at full resolution. Images stay NHWC here, the JAX
layout, so the tests compare like with like.

`LowlightRecovery` runs the chain through the hand-written kernels of
`ops/enhance_kernel.py`, registered as torch ops (an exported program keeps
them as such): with contrast_mode='channel' the whole chain in one
kernel; with 'reference', whose column luminance that kernel does not
compute, the point filters below as stock torch ops and then the blur and
sharpen kernel (the JAX dispatcher's two-stage form, ops/pallas/
enhance_kernel.py:316-319). Everything below is the plain version that the
kernels are held against and that the CPU runs.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import device_cache
from .layers import BiasConv2d, LeakyReLU, Linear, leaky_relu

NUM_FILTER_PARAMS = 15
DEDARK_SLOT = 0
WB_SLOTS = slice(1, 4)
GAMMA_SLOT = 4
CONTRAST_SLOT = 13
USM_SLOT = 14

DEFOG_RANGE = (0.1, 1.0)
GAMMA_RANGE = 3.0
WB_LOG_RANGE = 0.5
USM_RANGE = (0.0, 5.0)

DEFAULT_A = 0.8
DEFAULT_ICA = 0.5


def tanh_range(x, l, r):  # noqa: E741 (JAX's names)
    return torch.tanh(x) * (r - l) / 2.0 + (r + l) / 2.0


def rgb2lum(img):
    """Channel luminance of an NHWC image -> (..., 1)."""
    lum = 0.27 * img[..., 0] + 0.67 * img[..., 1] + 0.06 * img[..., 2]
    return lum[..., None]


def rgb2lum_reference_nchw(img):
    """The reference's rgb2lum as it executes on NCHW tensors: a mix of image
    COLUMNS 0..2 per (batch, row, channel), broadcast across the row (JAX
    enhance.py:79-91). In NHWC: (B, H, 1, C)."""
    lum = (0.27 * img[:, :, 0, :] + 0.67 * img[:, :, 1, :]
           + 0.06 * img[:, :, 2, :])
    return lum[:, :, None, :]


def regress_filter_params(features):
    """Squash the raw (B, 15) features into per-filter parameters."""
    dedark_w = tanh_range(features[:, DEDARK_SLOT:DEDARK_SLOT + 1],
                          *DEFOG_RANGE)
    # the JAX mask [0, 1, 1] on the WB features, without a host-to-device
    # copy (a blocking one: it would synchronise the stream on every call)
    wb = torch.cat([features[:, WB_SLOTS.start:WB_SLOTS.start + 1] * 0.0,
                    features[:, WB_SLOTS.start + 1:WB_SLOTS.stop]], dim=1)
    scale = torch.exp(tanh_range(wb, -WB_LOG_RANGE, WB_LOG_RANGE))
    lum = 1e-5 + 0.27 * scale[:, 0] + 0.67 * scale[:, 1] + 0.06 * scale[:, 2]
    log_g = math.log(GAMMA_RANGE)
    gamma = torch.exp(tanh_range(features[:, GAMMA_SLOT:GAMMA_SLOT + 1],
                                 -log_g, log_g))
    return {"dedark_w": dedark_w, "wb": scale / lum[:, None], "gamma": gamma,
            "contrast": torch.tanh(features[:, CONTRAST_SLOT:CONTRAST_SLOT + 1]),
            "usm": tanh_range(features[:, USM_SLOT:USM_SLOT + 1], *USM_RANGE)}


def apply_point_filters(img, params, dedark_A, IcA, contrast_mode="channel"):
    """DeDark -> WB -> Gamma -> Contrast, all per pixel (JAX enhance.py:118-145).

    img (B, H, W, 3) in [0, 1]; dedark_A (B, 3); IcA (B, H, W, 1).
    contrast_mode 'reference' reproduces the torch fork's column luminance.
    """
    w = params["dedark_w"][:, None, None, :]
    A = dedark_A[:, None, None, :]
    tx = torch.clamp(1.0 - w * IcA, min=0.01)
    x = (img - A) / tx + A
    x = x * params["wb"][:, None, None, :]
    x = torch.pow(torch.clamp(x, min=1e-4), params["gamma"][:, None, None, :])
    p = params["contrast"][:, None, None, :]
    lum_fn = rgb2lum_reference_nchw if contrast_mode == "reference" else rgb2lum
    lum = torch.clamp(lum_fn(x), 0.0, 1.0)
    clum = -torch.cos(math.pi * lum) * 0.5 + 0.5
    return (1.0 - p) * x + p * (x / (lum + 1e-6) * clum)


def gaussian_kernel_25(sigma=5.0, dtype=np.float32):
    """1-D 25-tap Gaussian, normalised in float64, then cast to `dtype`
    (reference filtersB.py:155-161)."""
    x = np.arange(-12, 13, dtype=np.float64)
    k = np.exp(-0.5 * np.square(x / sigma))
    return (k / k.sum()).astype(dtype)


@lru_cache(maxsize=16)
def _usm_blur_matrix(n: int):
    """(n, n) matrix of the 25-tap blur along one axis with 'reflect'
    boundary folded in: B[o, reflect(o + k - 12)] += g[k]."""
    g = gaussian_kernel_25(dtype=np.float64)
    B = np.zeros((n, n), np.float64)
    for o in range(n):
        for k in range(25):
            i = o + k - 12
            if i < 0:
                i = -i
            if i >= n:
                i = 2 * n - 2 - i
            B[o, i] += g[k]
    return B.astype(np.float32)


@device_cache(maxsize=32)
def _blur_matrix(n: int, device: torch.device, dtype: torch.dtype):
    # built outside inference mode even when a predict or val asks first:
    # an inference tensor in the cache could not be saved for a later
    # backward (ROADMAP C10); not kept while a model is traced
    with torch.inference_mode(False):
        return torch.from_numpy(_usm_blur_matrix(n)).to(device=device,
                                                        dtype=dtype)


def usm_filter(img, usm_param):
    """Unsharp mask, 25x25 sigma=5 Gaussian with reflect padding, as two
    banded products (JAX enhance.py:176-190). img (B, H, W, 3); usm (B, 1)."""
    Bv = _blur_matrix(img.shape[1], img.device, img.dtype)
    Bh = _blur_matrix(img.shape[2], img.device, img.dtype)
    blur = torch.einsum("oh,bhwc->bowc", Bv, img)
    blur = torch.einsum("ow,bhwc->bhoc", Bh, blur)
    return (img - blur) * usm_param[:, None, None, :] + img


# JAX's name for the conv form of the same blur and sharpen (JAX
# enhance.py:193-214); the port computes it in one form
usm_filter_conv = usm_filter


def apply_filter_chain(img, features, dedark_A, IcA, contrast_mode="channel"):
    """The full 5-filter chain from the raw (B, 15) features."""
    params = regress_filter_params(features)
    x = apply_point_filters(img, params, dedark_A, IcA, contrast_mode)
    return usm_filter(x, params["usm"])


@lru_cache(maxsize=32)
def _bilinear_matrix_np(out_size: int, in_size: int):
    """(out, in) weights of the torch-convention bilinear resize along one
    axis (JAX enhance.py:215-233)."""
    i = np.arange(out_size)
    src = (i + 0.5) * (in_size / out_size) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    w = np.zeros((out_size, in_size), np.float32)
    w[i, np.clip(lo, 0, in_size - 1)] += 1.0 - frac
    w[i, np.clip(lo + 1, 0, in_size - 1)] += frac
    return w


@device_cache(maxsize=32)
def _bilinear_matrix(out_size: int, in_size: int, device: torch.device,
                     dtype: torch.dtype):
    with torch.inference_mode(False):     # see _blur_matrix
        return torch.from_numpy(_bilinear_matrix_np(out_size, in_size)).to(
            device=device, dtype=dtype)


def torch_bilinear_resize(x, out_h: int, out_w: int):
    """NHWC resize as F.interpolate(bilinear, align_corners=False) computes
    it, no antialias: the reference's downsample to 256 (llie.py:43). An f32
    image goes through F.interpolate; a bf16 one through the JAX package's
    two resize matrices cast to bf16 (enhance.py:255-263), so that it rounds
    where JAX rounds."""
    b, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    if x.dtype == torch.float32:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        return y.permute(0, 2, 3, 1)
    wy = _bilinear_matrix(out_h, h, x.device, x.dtype)
    wx = _bilinear_matrix(out_w, w, x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wy, x)
    return torch.einsum("ow,bhwc->bhoc", wx, x)


class _ConvBlock(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.conv_block = nn.Sequential(BiasConv2d(c1, c2, 3, 2, 1),
                                        LeakyReLU())

    def forward(self, x):
        return self.conv_block(x)


class ExtractParameters2(nn.Module):
    """5 x (conv3x3 s2 + LeakyReLU 0.1) 3->16->32->32->32->32 on a 256x256
    NCHW input, NCHW flatten 2048 -> fc 64 -> fc 15 (reference
    common.py:52-78; the flatten order is the reference's)."""

    def __init__(self, out_dim: int = NUM_FILTER_PARAMS):
        super().__init__()
        widths = (3, 16, 32, 32, 32, 32)
        self.conv_layers = nn.Sequential(*(_ConvBlock(a, b) for a, b
                                           in zip(widths, widths[1:])))
        self.fc1 = Linear(2048, 64)
        self.fc2 = Linear(64, out_dim)

    def forward(self, x):
        x = self.conv_layers(x).reshape(x.shape[0], -1)
        return self.fc2(leaky_relu(self.fc1(x)))


class LowlightRecovery(nn.Module):
    """Layer 0 (reference llie.py:11-54). forward(x NHWC in [0,1]) -> NHWC.

    Priors default to the reference's A=0.8 and a materialised
    full-resolution IcA=0.5. The 256x256 resize runs in the image's dtype;
    the regressor runs in its parameters' dtype, as flax promotes a bf16
    image against f32 params (half predict); with bf16 params (amp
    training) it runs in bf16. The 'channel' chain (the kernel's) returns the
    image's dtype, as the JAX kernel does; 'reference' promotes like the JAX
    plain chain.
    """

    def __init__(self, contrast_mode: str = "channel"):
        super().__init__()
        self.contrast_mode = contrast_mode
        self.extractor = ExtractParameters2()

    def forward(self, x, dedark_A=None, IcA=None):
        if not torch.is_tensor(x):     # row slabs (parallel/spatial.py)
            return x.lowlight(self, dedark_A, IcA)
        b, h, w, _ = x.shape
        if dedark_A is None:
            dedark_A = torch.full((b, 3), DEFAULT_A, dtype=x.dtype,
                                  device=x.device)
        if IcA is None:
            IcA = torch.full((b, h, w, 1), DEFAULT_ICA, dtype=x.dtype,
                             device=x.device)
        small = torch_bilinear_resize(x, 256, 256).permute(0, 3, 1, 2)
        features = self.extractor(small.to(self.extractor.fc1.weight.dtype))
        from ..ops import enhance_kernel as K
        if self.contrast_mode == "channel":
            return K.fused_enhance(x, features, dedark_A, IcA)
        params = regress_filter_params(features)
        y = apply_point_filters(x, params, dedark_A, IcA, self.contrast_mode)
        return K.usm(y, params["usm"])
