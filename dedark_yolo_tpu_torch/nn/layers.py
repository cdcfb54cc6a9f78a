"""Conv blocks of the flagship graph as torch modules, NCHW inside.

Ports of the JAX package's `nn/layers.py`: the flagship's blocks (Conv,
Conv2d, AddConv, Bottleneck, C2f, SPPF, AsffTribeLevel) and the fork's block
zoo that its other detect architectures use (PConv and its bottlenecks,
SCConv = SRU + CRU and its bottlenecks, C2f's bottleneck families, C2,
RFBblock, AsffDoubLevel, MFRU). Module attribute names are the reference
fork's where `utils/torch_import.py` maps them (`model.{i}.cv1.conv.weight`,
...), else plain ones, tabled in `utils/weights.py`. The convs, grouped and
dilated ones too, go to cuDNN through `F.conv2d`, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # ultralytics initialize_weights (JAX layers.py:23-25)
BN_MOMENTUM = 0.03  # torch convention: running += 0.03 * (batch - running)


# A bf16 map (amp training) is computed as the JAX package computes it. XLA
# on the host rounds every elementwise op of a bf16 graph to bf16 (its
# logistic is 1 / (1 + exp(-x)) in rounded steps), casts a weakly typed
# constant such as leaky_relu's 0.1 to bf16 before it multiplies, adds a
# conv's or dense layer's bias to the rounded product, and sums a bf16
# softmax in f32. PyTorch's fused ops (F.silu, F.leaky_relu, a biased conv,
# torch.softmax) round once, so a bf16 map takes the unfused forms below;
# an f32 map the fused ops. PyTorch multiplies a bf16 map by a Python float
# at the float's full precision; XLA rounds the weak-typed scalar to bf16
# first (`weak_const`: leaky_relu's slope, the group norm's constants).


@functools.lru_cache(maxsize=None)
def _to_bf16(value: float) -> float:
    """`value` rounded to f32, then to bf16 to nearest even, as an exact
    f32 value (host arithmetic: no tensor, so it also runs under tracing)."""
    u = int(np.array(value, np.float32).view(np.uint32))
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return float(np.array(u, np.uint32).view(np.float32))


def weak_const(value: float, x) -> float:
    """A Python scalar as XLA takes it against `x`: on a bf16 map rounded
    to bf16 (a value exact in f32, so the op then rounds only its result),
    else as it is."""
    return _to_bf16(value) if x.dtype == torch.bfloat16 else value


class _SiluBF16(torch.autograd.Function):
    """jax.nn.silu on a bf16 map, forward and backward: x * logistic(x),
    logistic as XLA expands it and differentiated by its JAX rule
    (g * (s * (1 - s))), every op rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1.0 - s))


def silu(x):
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return _SiluBF16.apply(x)


def sigmoid(x):
    """jax.nn.sigmoid: on a bf16 map XLA's logistic, 1 / (1 + exp(-x)) in
    rounded steps (the bf16 decode of the benchmark's bf16 rows)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def leaky_relu(x):
    """LeakyReLU(0.1)."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, 0.1)
    return torch.where(x >= 0, x, x * weak_const(0.1, x))


def softmax(x, dim):
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class BiasConv2d(nn.Conv2d):
    """nn.Conv2d with a bias, which a bf16 map adds to the rounded conv."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None, None]


class Linear(nn.Linear):
    """nn.Linear, which adds its bias to the rounded product of a bf16 row."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


def autopad(k: int) -> int:
    """'same'-style pad for odd kernels (reference conv.py:15-21)."""
    return k // 2


def max_pool_same(x, k: int, s: int = 1):
    """MaxPool2d(k, stride=s, padding=k//2); the padding never wins the max."""
    return F.max_pool2d(x, k, stride=s, padding=k // 2)


def upsample_nearest(x, scale: int = 2):
    """Integer-factor nearest upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class BatchNorm(nn.Module):
    """BatchNorm holding only weight, bias, running_mean and running_var, as
    flax's BatchNorm does (JAX layers.py:200): stock BatchNorm2d adds a
    `num_batches_tracked` key the JAX export lacks, and updates the running
    variance with the unbiased batch variance where flax uses the biased
    one (ROADMAP C1).

    In training it normalises with the batch mean and biased variance and
    then moves the running stats toward them by BN_MOMENTUM, in flax's form
    (0.97 * running + 0.03 * batch). One `F.batch_norm` call computes the
    batch stats: given zeroed buffers and momentum 1 it returns them in
    those buffers, the variance unbiased, which the update scales back by
    (n - 1) / n.

    A bf16 input with bf16 scale and bias and f32 running stats (bf16
    training, `amp=True`) is normalised as flax 0.12 does it: one
    `F.batch_norm` on the bf16 input with the scale and bias cast to f32
    reduces the batch mean and variance in f32, updates the f32 running
    stats, computes the affine in f32 and rounds once back to bf16.
    """

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != self.running_mean.dtype:     # bf16 params (amp)
            w, b = w.to(self.running_mean.dtype), b.to(self.running_mean.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                                False, 0.0, BN_EPS)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, w, b, True, 1.0, BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = 1.0 - BN_MOMENTUM
            self.running_mean.mul_(keep).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(keep).add_(var * ((n - 1) / n),
                                             alpha=BN_MOMENTUM)
        return y


class Conv(nn.Module):
    """Conv2d (no bias) + BN + SiLU. Reference conv.py:38-55."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), bias=False)
        self.bn = BatchNorm(c2)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


def Conv2d(c1: int, c2: int, k: int = 1, s: int = 1, p=None, g: int = 1,
           d: int = 1, bias: bool = True):
    """Bare conv, with a bias unless `bias=False` (JAX layers.py:206-221);
    `p` None pads 'same' for the dilated kernel."""
    pad = (d * (k - 1) + 1) // 2 if p is None else p
    if bias:
        return BiasConv2d(c1, c2, k, s, pad, dilation=d, groups=g)
    return nn.Conv2d(c1, c2, k, s, pad, dilation=d, groups=g, bias=False)


class AddConv(nn.Module):
    """conv + BN + LeakyReLU(0.1). Reference block.py:24-45 (add_conv)."""

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, (k - 1) // 2, bias=False)
        self.batch_norm = BatchNorm(c2)

    def forward(self, x):
        return leaky_relu(self.batch_norm(self.conv(x)))


class Bottleneck(nn.Module):
    """Reference block.py:553-565, at C2f's expansion e=1.0."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 1)
        self.cv2 = Conv(c2, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class PConv(nn.Module):
    """FasterNet partial conv: a 3x3 on the first dim // n_div channels, the
    rest passed through (JAX layers.py:418-431)."""

    def __init__(self, dim: int, n_div: int = 4):
        super().__init__()
        self.dc = dim // n_div
        self.conv = nn.Conv2d(self.dc, self.dc, 3, 1, 1, bias=False)

    def forward(self, x):
        return torch.cat([self.conv(x[:, :self.dc]), x[:, self.dc:]], 1)


class PconvBottleneck(nn.Module):
    """PConv -> Conv -> bare 1x1 without bias: the 3x3 Conv of width c2 * e
    (`kind` 'pconv', JAX layers.py:687-700), or the 1x1 Conv of twice that
    (PconvBottleneckN, 'pconv_n', :703-716)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5, kind: str = "pconv"):
        super().__init__()
        c_ = int(c2 * e)
        self.pconv = PConv(c1, 4)
        self.cv1 = (Conv(c1, c_, 3) if kind == "pconv"
                    else Conv(c1, 2 * c_, 1))
        self.cv2 = Conv2d(self.cv1.conv.out_channels, c2, 1, bias=False)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(self.pconv(x)))
        return x + y if self.add else y


def _group_norm(x, groups: int, eps: float):
    """Normalise each of `groups` channel groups of an NCHW map over its
    (C/G, H, W) values, by the unbiased std plus eps, as the JAX package's
    GroupBatchnorm2d and SRU do (layers.py:577-581). On a bf16 map the
    unbiasing factor n / (n - 1) and eps are rounded to bf16 first, as XLA
    rounds the weak-typed scalars of JAX's formula (`weak_const`); the mean
    and the variance reduce in f32 and round once in both packages."""
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, -1)
    n = xg.shape[2]
    mean = xg.mean(2, keepdim=True)
    var = (xg.var(2, unbiased=False, keepdim=True)
           * weak_const(n / max(n - 1, 1), x))
    return ((xg - mean) / (torch.sqrt(var) + weak_const(eps, x))
            ).reshape(b, c, h, w)


class GroupBatchnorm2d(nn.Module):
    """Group norm over 16 groups with a per-channel affine (JAX
    layers.py:561-583; scale initialised to ones, as JAX has it)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xn = _group_norm(x, 16, 1e-10)
        return xn * self.weight[:, None, None] + self.bias[:, None, None]


class CRU(nn.Module):
    """Channel reconstruct unit of SCConv at JAX's defaults (layers.py:
    586-612: alpha 0.5, squeeze 2, two groups, 3x3): the upper half
    squeezed, then a grouped 3x3 plus a 1x1; the lower half squeezed, a
    1x1 of it beside itself; the two weighed by a softmax over their
    pooled channels and their halves summed."""

    def __init__(self, c: int):
        super().__init__()
        self.up_c = c // 2
        low_c = c - self.up_c
        up_s, low_s = self.up_c // 2, low_c // 2
        self.squeeze1 = Conv2d(self.up_c, up_s, 1, bias=False)
        self.squeeze2 = Conv2d(low_c, low_s, 1, bias=False)
        self.GWC = Conv2d(up_s, c, 3, g=2)
        self.PWC1 = Conv2d(up_s, c, 1, bias=False)
        self.PWC2 = Conv2d(low_s, c - low_s, 1, bias=False)

    def forward(self, x):
        up = self.squeeze1(x[:, :self.up_c])
        low = self.squeeze2(x[:, self.up_c:])
        out = torch.cat([self.GWC(up) + self.PWC1(up), self.PWC2(low), low], 1)
        out = softmax(out.mean((2, 3), keepdim=True), 1) * out
        o1, o2 = out.chunk(2, 1)
        return o1 + o2


class SCConv(nn.Module):
    """SRU + CRU at JAX's defaults (layers.py:615-647). The SRU is inlined
    with its own group-norm scale and bias (`sru_weight`, `sru_bias`, at
    ones and zeros as in JAX; 4 groups): a value goes to the informative or
    the other map by sigmoid(gn_x * w / sum(w)) >= 0.5, and the maps'
    halves cross. The gate's sigmoid is `sigmoid`, XLA's rounded logistic on
    a bf16 map: torch.sigmoid rounds once, and near gn_x = 0 the two land on
    either side of 0.5, which moves a whole value to the other map."""

    def __init__(self, c: int):
        super().__init__()
        self.sru_weight = nn.Parameter(torch.ones(c))
        self.sru_bias = nn.Parameter(torch.zeros(c))
        self.cru = CRU(c)

    def gate(self, x):
        """(gn_x, the informative mask) of the SRU on x."""
        w = self.sru_weight
        gn_x = (_group_norm(x, 4, 1e-10) * w[:, None, None]
                + self.sru_bias[:, None, None])
        return gn_x, sigmoid(gn_x * (w / w.sum())[:, None, None]) >= 0.5

    def sru(self, x):
        gn_x, info = self.gate(x)
        zero = torch.zeros((), dtype=gn_x.dtype, device=gn_x.device)
        x11, x12 = torch.where(info, gn_x, zero).chunk(2, 1)
        x21, x22 = torch.where(info, zero, gn_x).chunk(2, 1)
        return torch.cat([x11 + x22, x12 + x21], 1)

    def forward(self, x):
        return self.cru(self.sru(x))


class SCBottleneck(nn.Module):
    """The SCConv bottlenecks of JAX layers.py:719-782, by `kind`: 'scconv'
    SCConv -> 1x1 Conv; 'sc_pw' SCConv -> bare biased 1x1; 'sc_conv3' SCConv
    -> 3x3 Conv; 'conv3_sc' 3x3 Conv -> SCConv; 'sc_pw_pw' SCConv -> 1x1
    Conv to twice the width -> bare 1x1 without bias."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 kind: str = "scconv"):
        super().__init__()
        self.first = kind == "conv3_sc"
        self.sc = SCConv(c2 if self.first else c1)
        self.cv1 = {"scconv": lambda: Conv(c1, c2, 1),
                    "sc_pw": lambda: Conv2d(c1, c2, 1),
                    "sc_conv3": lambda: Conv(c1, c2, 3),
                    "conv3_sc": lambda: Conv(c1, c2, 3),
                    "sc_pw_pw": lambda: Conv(c1, 2 * c1, 1)}[kind]()
        if kind == "sc_pw_pw":
            self.cv2 = Conv2d(2 * c1, c2, 1, bias=False)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.sc(self.cv1(x)) if self.first else self.cv1(self.sc(x))
        if hasattr(self, "cv2"):
            y = self.cv2(y)
        return x + y if self.add else y


def bottleneck(kind: str, c: int, shortcut: bool) -> nn.Module:
    """C2f's inner block of family `kind` (JAX layers.py:857-866), c -> c."""
    if kind == "standard":
        return Bottleneck(c, c, shortcut)
    if kind in ("pconv", "pconv_n"):
        return PconvBottleneck(c, c, shortcut, 1.0, kind)
    return SCBottleneck(c, c, shortcut, kind)


class C2f(nn.Module):
    """Cross-stage partial with dense growth. Reference block.py:373-393;
    `bottleneck` is the inner family of the fork's FasterC2f(_N), SCC2f,
    SC_PW_C2f, SC_Conv3_C2f, Conv3_SC_C2f and SC_PW_PW_C2f (JAX
    layers.py:838-869)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 bottleneck_kind: str = "standard"):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(bottleneck(bottleneck_kind, c, shortcut)
                               for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C2(nn.Module):
    """Reference block.py:355-370 (JAX layers.py:820-835): a 1x1 split in
    two, one half through n bottlenecks, then a 1x1 of both."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1, 2 * c, 1)
        self.cv2 = Conv(2 * c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c, c, shortcut) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat([self.m(a), b], 1))


class SPPF(nn.Module):
    """Reference block.py:323-338."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Upsample(nn.Module):
    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_nearest(x, self.scale)


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class RFBblock(nn.Module):
    """Four-branch dilated receptive-field block, c1 -> 4 * (c1 // 4)
    (JAX layers.py:1088-1105): a 1x1; 1x1 then 3x3; 1x1, 3x3, then 3x3 at
    dilation 2; 1x1, 5x5, then 3x3 at dilation 3; every conv bare and
    biased. cuDNN runs the dilated convs."""

    def __init__(self, c1: int):
        super().__init__()
        i = c1 // 4
        self.b0 = Conv2d(c1, i, 1)
        self.b1 = nn.Sequential(Conv2d(c1, i, 1), Conv2d(i, i, 3))
        self.b2 = nn.Sequential(Conv2d(c1, i, 1), Conv2d(i, i, 3),
                                Conv2d(i, i, 3, d=2))
        self.b3 = nn.Sequential(Conv2d(c1, i, 1), Conv2d(i, i, 5),
                                Conv2d(i, i, 3, d=3))

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1(x), self.b2(x), self.b3(x)], 1)


def _weights(conv, ws):
    """softmax over the levels of the weight conv of the concatenated
    compressed maps, one (B, 1, H, W) slice a level."""
    w = softmax(conv(torch.cat(ws, 1)), dim=1)
    return [w[:, k:k + 1] for k in range(len(ws))]


class AsffTribeLevel(nn.Module):
    """Adaptive 3-level spatial feature fusion. Reference block.py:48-115.

    Input [deepest P5, P4, P3], widths `dims`. Where the branch that level 0
    max-pools (P4) or level 1 upsamples (P5) has another width than the
    level's, a 1x1 AddConv (`align_level_1`, `align_level_0`) brings it to
    that width first, as the JAX package's `align` does (layers.py:1137-1139):
    at the widths of scales n, s and m; at l and x every such branch already
    has the level's width and none is built.

    The 8-channel compress convs of upsampled branches run before the
    upsample, and their small output is upsampled (the JAX default,
    `commute_weights`, layers.py:1162), in training too, as in JAX. A 1x1
    conv + eval BN + pointwise act commutes exactly with integer nearest
    upsample; in training the batch mean and biased variance of the small
    map are those of its upsampled copy, so the commute holds there too.
    """

    def __init__(self, level: int, dims: Sequence[int]):
        super().__init__()
        self.level = level
        inter = dims[level]
        if level == 0 and dims[1] != inter:
            self.align_level_1 = AddConv(dims[1], inter, 1, 1)
        if level == 1 and dims[0] != inter:
            self.align_level_0 = AddConv(dims[0], inter, 1, 1)
        if level in (0, 1):
            self.stride_level_2 = AddConv(dims[2], inter, 3, 2)
        else:
            self.compress_level_0 = AddConv(dims[0], inter, 1, 1)
            self.compress_level_1 = AddConv(dims[1], inter, 1, 1)
        compress_c = 8
        self.weight_level_0 = AddConv(inter, compress_c, 1, 1)
        self.weight_level_1 = AddConv(inter, compress_c, 1, 1)
        self.weight_level_2 = AddConv(inter, compress_c, 1, 1)
        self.weight_levels = Conv2d(compress_c * 3, 3, 1, 1)
        self.expand = AddConv(inter, inter, 3, 1)

    def _align(self, name, x):
        return getattr(self, name)(x) if hasattr(self, name) else x

    def forward(self, xs):
        x0, x1, x2 = xs
        # (branch at the level's resolution, pre-upsample tensor, scale)
        if self.level == 0:
            r0 = (x0, x0, 1)
            r1 = (self._align("align_level_1", F.max_pool2d(x1, 2, 2)),) * 2 + (1,)
            r2 = (self.stride_level_2(max_pool_same(x2, 3, 2)),) * 2 + (1,)
        elif self.level == 1:
            a0 = self._align("align_level_0", x0)
            r0 = (upsample_nearest(a0, 2), a0, 2)
            r1 = (x1, x1, 1)
            r2 = (self.stride_level_2(x2),) * 2 + (1,)
        else:
            a0 = self.compress_level_0(x0)
            a1 = self.compress_level_1(x1)
            r0 = (upsample_nearest(a0, 4), a0, 4)
            r1 = (upsample_nearest(a1, 2), a1, 2)
            r2 = (x2, x2, 1)
        ws = []
        for cmp, (_, pre, scale) in zip(
                (self.weight_level_0, self.weight_level_1,
                 self.weight_level_2), (r0, r1, r2)):
            w = cmp(pre)
            ws.append(upsample_nearest(w, scale) if scale > 1 else w)
        w0, w1, w2 = _weights(self.weight_levels, ws)
        return self.expand(r0[0] * w0 + r1[0] * w1 + r2[0] * w2)


class AsffDoubLevel(nn.Module):
    """Adaptive 2-level fusion of [P4, P3] (reference block.py:118-162, JAX
    layers.py:1173-1205): level 0 at P4's width and resolution (P3 through
    a stride-2 3x3 AddConv), level 1 at P3's (P4 through a 1x1 AddConv,
    upsampled); 16-channel compress convs, the upsampled branch's commuted
    past the upsample as in AsffTribeLevel."""

    def __init__(self, level: int, dims: Sequence[int]):
        super().__init__()
        self.level = level
        inter = dims[level]
        if level == 0:
            self.stride_level_1 = AddConv(dims[1], inter, 3, 2)
        else:
            self.compress_level_0 = AddConv(dims[0], inter, 1, 1)
        compress_c = 16
        self.weight_level_0 = AddConv(inter, compress_c, 1, 1)
        self.weight_level_1 = AddConv(inter, compress_c, 1, 1)
        self.weight_levels = Conv2d(compress_c * 2, 2, 1, 1)
        self.expand = AddConv(inter, inter, 3, 1)

    def forward(self, xs):
        x0, x1 = xs
        if self.level == 0:
            r0, r1 = x0, self.stride_level_1(x1)
            w0 = self.weight_level_0(r0)
        else:
            a0 = self.compress_level_0(x0)
            r0, r1 = upsample_nearest(a0, 2), x1
            w0 = upsample_nearest(self.weight_level_0(a0), 2)
        w0, w1 = _weights(self.weight_levels, [w0, self.weight_level_1(r1)])
        return self.expand(r0 * w0 + r1 * w1)


class MFRU(nn.Module):
    """Multi-scale feature reconstruct unit of [P5, P4, P3] (reference
    block.py:164-217, JAX layers.py:1208-1239), at P3's width and
    resolution. `sc_deep` and `pw` are one module each, applied to P5 and
    to P4, and `sc_out` one module applied to P3 and to the fused map, as
    in the reference. Where P4's width differs from P5's (scales n, s, m),
    `align_level_1` (a 1x1 AddConv) brings P4 to it first."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        c_deep, c_out = dims[0], dims[2]
        self.sc_deep = SCConv(c_deep)
        self.sc_out = SCConv(c_out)
        self.pw = Conv2d(c_deep, c_out, 1)
        if dims[1] != c_deep:
            self.align_level_1 = AddConv(dims[1], c_deep, 1, 1)
        compress_c = 16
        self.weight_level_0 = Conv2d(c_out, compress_c, 1)
        self.weight_level_1 = Conv2d(c_out, compress_c, 1)
        self.weight_level_2 = Conv2d(c_out, compress_c, 1)
        self.weight_levels = Conv2d(compress_c * 3, 3, 1)

    def forward(self, xs):
        x1 = (self.align_level_1(xs[1]) if hasattr(self, "align_level_1")
              else xs[1])
        l0 = upsample_nearest(self.pw(self.sc_deep(xs[0])), 4)
        l1 = upsample_nearest(self.pw(self.sc_deep(x1)), 2)
        l2 = self.sc_out(xs[2])
        w0, w1, w2 = _weights(self.weight_levels,
                              [self.weight_level_0(l0), self.weight_level_1(l1),
                               self.weight_level_2(l2)])
        return self.sc_out(l0 * w0 + l1 * w1 + l2 * w2)


class Classify(nn.Module):
    """Classification head (reference head.py:244-260, JAX layers.py:
    1242-1253): a Conv to 1280 channels (k, s from the row's args), the mean
    over H and W, then a biased Linear to nc logits."""

    def __init__(self, c1: int, nc: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv(c1, 1280, k, s)
        self.linear = Linear(1280, nc)

    def forward(self, x):
        return self.linear(self.conv(x).mean((2, 3)))
