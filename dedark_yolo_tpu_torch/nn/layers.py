"""Conv blocks of the flagship graph as torch modules, NCHW inside.

Ports of the JAX package's `nn/layers.py`: the flagship's blocks (Conv,
Conv2d, AddConv, Bottleneck, C2f, SPPF, AsffTribeLevel) and the fork's block
zoo that its other detect architectures use (PConv and its bottlenecks,
SCConv = SRU + CRU and its bottlenecks, C2f's bottleneck families, C2,
RFBblock, AsffDoubLevel, MFRU), the classify head and the Segment head's
Proto, and the rest of JAX's blocks that a user's graph may name: Conv2,
DWConv, LightConv, ConvTranspose, Focus, GhostConv, CrossConv, the
attention blocks (ChannelAttention, SpatialAttention, CBAM), RepConv (and
`fuse_repconv`, its deploy form), GhostBottleneck, C1, C3, C3x, C3TR
(`nn/transformer.py`), C3Ghost, RepC3, BottleneckCSP, SPP, HGStem and
HGBlock. Module attribute names are the reference
fork's where `utils/torch_import.py` maps them (`model.{i}.cv1.conv.weight`,
...), else plain ones, tabled in `utils/weights.py`. The convs, grouped and
dilated ones too, go to cuDNN through `F.conv2d`, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import contextlib
import functools
import math
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
    if not torch.is_tensor(x):     # row slabs (parallel/spatial.py)
        return x.each(silu)
    return _SiluBF16.apply(x)


class _SigmoidBF16(torch.autograd.Function):
    """jax.nn.sigmoid on a bf16 map, forward and backward: XLA's logistic,
    1 / (1 + exp(-x)) in rounded steps, differentiated by JAX's rule for
    it (g * (s * (1 - s))), every op rounded to bf16. Autograd through the
    rounded steps gives another gradient (CBAM's weights drifted to twice
    JAX's bf16-f32 gap)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x):
    """jax.nn.sigmoid: on a bf16 map XLA's logistic (`_SigmoidBF16`; also
    the bf16 decode of the benchmark's bf16 rows)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    if not torch.is_tensor(x):     # row slabs (parallel/spatial.py)
        return x.each(sigmoid)
    return _SigmoidBF16.apply(x)


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


class BiasConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with a bias, which a bf16 map adds to the rounded
    transposed conv (flax's ConvTranspose adds it after the conv)."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.conv_transpose2d(x, self.weight, None, self.stride,
                                  self.padding) + self.bias[:, None, None]


class Linear(nn.Linear):
    """nn.Linear, which adds its bias to the rounded product of a bf16 row.
    An input of another dtype than the weights meets them in the promoted
    dtype, as flax's Dense promotes (an f32 row through bf16 weights is an
    f32 product: RT-DETR's query boxes under bf16 weights)."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dt), w.to(dt), b.to(dt)
        if x.dtype != torch.bfloat16:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


def autopad(k, p=None, d: int = 1):
    """'same'-style pad for odd kernels (reference conv.py:15-21, JAX
    layers.py:28-32): `p` where given, else half the dilated kernel; a
    (kh, kw) kernel pads each side by its own half (C3x's cross kernels)."""
    if isinstance(k, (tuple, list)):
        return tuple(autopad(x, p, d) for x in k)
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


# the activations of JAX's blocks by JAX's names (layers.py:35-42); True is
# silu, and any other value that is not a name (False, None) the identity
ACTS = {"silu": silu, "relu": F.relu, "identity": lambda x: x}


def get_act(name):
    """The activation of JAX's name (JAX layers.py:35-42)."""
    return {**ACTS, "relu6": F.relu6, "leaky": leaky_relu}[name]


def act_name(act) -> str:
    if act is True:
        return "silu"
    return act if isinstance(act, str) else "identity"


def max_pool_same(x, k: int, s: int = 1):
    """MaxPool2d(k, stride=s, padding=k//2); the padding never wins the max."""
    return F.max_pool2d(x, k, stride=s, padding=k // 2)


def upsample_nearest(x, scale: int = 2):
    """Integer-factor nearest upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


# > 0 while a remat recompute runs (`frozen_running_stats`): train-mode BN
# then normalises with the batch statistics and leaves its running stats
# alone, so they move once a step. A plain counter, not a thread-local:
# the recompute runs on the autograd engine's thread.
_FROZEN_STATS = [0]


@contextlib.contextmanager
def frozen_running_stats():
    """Within the block train-mode BatchNorm does not move its running
    stats (the recompute context of `nn/graph.py`'s remat)."""
    _FROZEN_STATS[0] += 1
    try:
        yield
    finally:
        _FROZEN_STATS[0] -= 1


@contextlib.contextmanager
def batchnorm_group(model, group):
    """Within the block every BatchNorm of `model` in training takes its
    moments over `group`'s global batch (None: this rank's batch). The
    trainer sets it around a step under a mesh of several ranks."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


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

    With `group` set (`batchnorm_group`: training under a mesh of several
    ranks) the moments are those of the global batch, as GSPMD computes
    them for JAX's sharded step: the per-channel sum, sum of squares and
    count, in f32, are all-reduced through
    `torch.distributed.nn.functional.all_reduce` (whose backward
    all-reduces the gradient, so it crosses ranks), the variance is flax's
    E[x^2] - E[x]^2 clipped at 0, the affine is flax's (x - mean) *
    (rsqrt(var + eps) * scale) + bias in f32 rounded once to the input's
    dtype, and the running stats move with the global moments. Row slabs
    (data x spatial training, `parallel/spatial.py`) take the same form,
    their sums taken over every slab before the group's all-reduce; where
    the 'spatial' axis runs over ranks the slabs' sums are all-reduced over
    the spatial group and `group` is the data group, so a slab map's
    moments sum over the whole world and a map every rank computes alike
    (layer 0's parameter CNN, what follows a join) over the data group
    only.

    `eps` and `momentum` are YOLO's tuned BN's (1e-3, 0.03) unless given:
    RT-DETR's input projection keeps flax's plain BatchNorm (1e-5, 0.1).
    """

    group = None     # the mesh's group in a multi-rank step

    def __init__(self, c: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps, self.momentum = eps, momentum

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != self.running_mean.dtype:     # bf16 params (amp)
            w, b = w.to(self.running_mean.dtype), b.to(self.running_mean.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                                False, 0.0, self.eps)
        if self.group is not None or not torch.is_tensor(x):
            y, mean, var = self._global(x, w, b)
        else:
            mean = torch.zeros_like(self.running_mean)
            var = torch.zeros_like(self.running_var)
            y = F.batch_norm(x, mean, var, w, b, True, 1.0, self.eps)
            n = x.numel() // x.shape[1]
            var = var * ((n - 1) / n)
        if not _FROZEN_STATS[0]:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
                self.running_var.mul_(keep).add_(var, alpha=self.momentum)
        return y

    def _global(self, x, w, b):
        """(y, mean, biased var) with the moments over the group's batch
        (this process's, without a group)."""
        from torch.distributed.nn.functional import all_reduce
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.float()
        s1 = xf.sum(dims)
        stats = torch.cat([s1, (xf * xf).sum(dims),
                           s1.new_full((1,), math.prod(x.shape) // c)])
        if self.group is not None:
            stats = all_reduce(stats, group=self.group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        shape = [1, c] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * w
        y = (xf - mean.view(shape)) * mul.view(shape) + b.view(shape)
        return y.to(x.dtype), mean.detach(), var.detach()


class Conv(nn.Module):
    """Conv2d (no bias) + BN + act (JAX layers.py:165-203, reference
    conv.py:38-55): padding `p` (None: 'same' for the dilated kernel),
    groups `g`, dilation `d`, `act` one of ACTS' names. `k` may be a
    (kh, kw) pair."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d,
                              groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act_name(act)

    def forward(self, x):
        return ACTS[self.act](self.bn(self.conv(x)))


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
    """Reference block.py:553-565 (JAX layers.py:671-684): a k[0] Conv to
    int(c2 * e), then a k[1] Conv of `g` groups to c2, plus the input where
    `shortcut` and the widths agree. C2f and C2 take e=1.0, C3 k=(1, 3),
    C3x the cross kernels ((1, 3), (3, 1))."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
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


class PconvBottleneckN(PconvBottleneck):
    """PConv -> 1x1 Conv to twice c2 * e -> bare 1x1 (JAX layers.py:703-716)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__(c1, c2, shortcut, e, "pconv_n")


def _group_norm(x, groups: int, eps: float):
    """Normalise each of `groups` channel groups of an NCHW map over its
    (C/G, H, W) values, by the unbiased std plus eps, as the JAX package's
    GroupBatchnorm2d and SRU do (layers.py:577-581). On a bf16 map the
    unbiasing factor n / (n - 1) and eps are rounded to bf16 first, as XLA
    rounds the weak-typed scalars of JAX's formula (`weak_const`); the mean
    and the variance reduce in f32 and round once in both packages. Row
    slabs (`parallel/spatial.py`) take their statistics over every slab."""
    if not torch.is_tensor(x):
        return x.group_norm(groups, eps)
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


class SCConvBottleneck(SCBottleneck):
    """SCConv -> 1x1 Conv (JAX layers.py:719-728)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__(c1, c2, shortcut, "scconv")


class SCPWBottleneck(SCBottleneck):
    """SCConv -> bare biased 1x1 (JAX layers.py:731-741)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__(c1, c2, shortcut, "sc_pw")


class SCConv3Bottleneck(SCBottleneck):
    """SCConv -> 3x3 Conv (JAX layers.py:744-754)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__(c1, c2, shortcut, "sc_conv3")


class Conv3SCBottleneck(SCBottleneck):
    """3x3 Conv -> SCConv (JAX layers.py:757-767)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__(c1, c2, shortcut, "conv3_sc")


class SCPWPWBottleneck(SCBottleneck):
    """SCConv -> 1x1 Conv to twice the width -> bare 1x1 without bias (JAX
    layers.py:770-782)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__(c1, c2, shortcut, "sc_pw_pw")


def bottleneck(kind: str, c: int, shortcut: bool) -> nn.Module:
    """C2f's inner block of family `kind` (JAX layers.py:857-866), c -> c."""
    if kind == "standard":
        return Bottleneck(c, c, shortcut, e=1.0)
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
        self.m = nn.Sequential(*(Bottleneck(c, c, shortcut, e=1.0)
                                 for _ in range(n)))

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


class Proto(nn.Module):
    """Mask prototypes of the Segment head (reference block.py:242-254, JAX
    layers.py:1075-1085): a 3x3 Conv, a biased 2x2 stride-2 transposed conv
    that doubles the map, a 3x3 Conv and a 1x1 Conv to c2 prototypes."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = BiasConvTranspose2d(c_, c_, 2, 2)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


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


# The rest of the JAX package's blocks (layers.py:224-558, 785-1072): the
# reference's C1/C3/CSP/Ghost/SPP/Focus/CBAM/HGNet families and RepConv.


class Conv2(nn.Module):
    """A k x k and a 1x1 conv summed under one BN and act (JAX layers.py:
    224-244, reference conv.py:58-76)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g, bias=False)
        self.cv2 = nn.Conv2d(c1, c2, 1, s, 0, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act_name(act)

    def forward(self, x):
        return ACTS[self.act](self.bn(self.conv(x) + self.cv2(x)))


class DWConv(Conv):
    """Conv of gcd(c1, c2) groups (JAX layers.py:257-268): `conv`, `bn` as
    a Conv's."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1,
                 act="silu"):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class LightConv(nn.Module):
    """A 1x1 Conv without act, then a k x k DWConv with ReLU (JAX
    layers.py:271-279, reference conv.py:79-92)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act="identity")
        self.conv2 = DWConv(c2, c2, k, act="relu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ConvTranspose(nn.Module):
    """Transposed conv + BN + act (JAX layers.py:282-300), at the output
    size of flax's explicit padding: flax pads the stride-dilated input by
    p on each side, so H -> (H - 1) * s + 2p - k + 2 (k = s = 2, p = 0:
    2H - 2, where the reference's torch layer gives 2H). torch's transposed
    conv with padding k - 1 - p computes that map, its kernel mirrored as
    Proto's (`utils/weights.py`)."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0,
                 bn: bool = True, act="silu"):
        super().__init__()
        if k - 1 - p < 0:
            raise ValueError(f"ConvTranspose: padding {p} above k - 1 = "
                             f"{k - 1} has no torch form")
        cls = nn.ConvTranspose2d if bn else BiasConvTranspose2d
        self.conv_transpose = cls(c1, c2, k, s, k - 1 - p, bias=not bn)
        self.bn = BatchNorm(c2) if bn else None
        self.act = act_name(act)

    def forward(self, x):
        x = self.conv_transpose(x)
        return ACTS[self.act](self.bn(x) if self.bn is not None else x)


class Focus(nn.Module):
    """The four pixel phases side by side as channels, then a Conv (JAX
    layers.py:391-401): (even row, even col), (odd, even), (even, odd),
    (odd, odd), JAX's order."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """A Conv to c2 // 2 and its 5x5 depthwise Conv, side by side (JAX
    layers.py:404-415)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class CrossConv(Conv):
    """C3x's rectangular Conv + BN + SiLU, kernel (kh, kw) padded by its
    halves (JAX layers.py:911-924)."""

    def __init__(self, c1: int, c2: int, k=(1, 3)):
        super().__init__(c1, c2, tuple(k))


class ChannelAttention(nn.Module):
    """x times the sigmoid of a biased 1x1 conv of its channel means (JAX
    layers.py:529-536)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = Conv2d(c, c, 1)

    def forward(self, x):
        return x * sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """x times the sigmoid of a k x k conv of its channel mean and max (JAX
    layers.py:539-549; padding 3 for k = 7, else 1)."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, k, 1, 3 if k == 7 else 1, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * sigmoid(self.cv1(s))


class CBAM(nn.Module):
    """Channel then spatial attention (JAX layers.py:552-558)."""

    def __init__(self, c1: int, k: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class RepConv(nn.Module):
    """A k x k Conv (padding 1) and a 1x1 Conv, both without act, summed,
    plus BN of the input where `use_id_bn`, c1 == c2 and s == 1; then the
    act (JAX layers.py:434-464, reference conv.py:193-291). `fuse_convs`
    turns it into the deploy form: one biased k x k `conv` (JAX's `fused`)
    that computes the same map in eval."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 use_id_bn: bool = False, act="silu"):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, p=1, act="identity")
        self.conv2 = Conv(c1, c2, 1, s, p=0, act="identity")
        self.bn = BatchNorm(c1) if use_id_bn and c1 == c2 and s == 1 else None
        self.act = act_name(act)

    def forward(self, x):
        if hasattr(self, "conv"):
            return ACTS[self.act](self.conv(x))
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + self.bn(x)
        return ACTS[self.act](y)

    @torch.no_grad()
    def fuse_convs(self):
        """The deploy form, as JAX's `_fuse_one_repconv` (layers.py:467-491)
        folds it: each branch's BN into its kernel (w * gamma / std, beta -
        mean * gamma / std), the 1x1 kernel at the centre of the k x k, the
        identity BN's scale on the diagonal of the centre tap."""
        def fold(kernel, bn):
            t = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
            return kernel * t[:, None, None, None], bn.bias - bn.running_mean * t
        c1 = self.conv1.conv
        k3, b3 = fold(c1.weight, self.conv1.bn)
        k1, b1 = fold(self.conv2.conv.weight, self.conv2.bn)
        kern = k3 + F.pad(k1, (1, 1, 1, 1))
        bias = b3 + b1
        if self.bn is not None:
            t = self.bn.weight / torch.sqrt(self.bn.running_var + BN_EPS)
            idx = torch.arange(kern.shape[1], device=kern.device)
            kern[idx, idx, 1, 1] += t
            bias = bias + self.bn.bias - self.bn.running_mean * t
        conv = BiasConv2d(c1.in_channels, c1.out_channels, c1.kernel_size,
                          c1.stride, 1, device=kern.device, dtype=kern.dtype)
        conv.weight.copy_(kern)
        conv.bias.copy_(bias)
        del self.conv1, self.conv2, self.bn
        self.conv = conv


def fuse_repconv(model: nn.Module) -> int:
    """Every RepConv of `model` in its deploy form, in place (JAX
    `fuse_repconv_variables`, layers.py:494-526, on the port's modules);
    returns how many were fused."""
    reps = [m for m in model.modules()
            if isinstance(m, RepConv) and not hasattr(m, "conv")]
    for m in reps:
        m.fuse_convs()
    return len(reps)


class GhostBottleneck(nn.Module):
    """GhostConv to c2 // 2, at s = 2 a k x k DWConv without act, GhostConv
    to c2, plus the input (s = 1, c1 == c2) or its shortcut (s = 2: a DWConv
    and a 1x1 Conv, both without act) (JAX layers.py:785-803). The second
    GhostConv keeps its SiLU, as in JAX (the reference's has none)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act="identity") if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act="identity"),
                                       Conv(c1, c2, 1, 1, act="identity"))
                         if s == 2 else None)
        self.add = c1 == c2

    def forward(self, x):
        y = self.conv(x)
        if self.shortcut is not None:
            return y + self.shortcut(x)
        return y + x if self.add else y


class C1(nn.Module):
    """A 1x1 Conv, then n 3x3 Convs, plus their input (JAX layers.py:
    806-817)."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.m = nn.Sequential(*(Conv(c2, c2, 3) for _ in range(n)))

    def forward(self, x):
        y = self.cv1(x)
        return self.m(y) + y


class _C3Base(nn.Module):
    """The C3 frame (JAX layers.py:872-888): cv1 (1x1 Conv to c_) through
    `m`, beside cv2 (1x1 Conv to c_), then cv3 (1x1 Conv of both to c2)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.c_ = c_

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3(_C3Base):
    """C3 with n Bottlenecks of kernels (1, 3) (JAX layers.py:872-888 built
    with k=(1, 3), the reference's C3: its bottleneck is a 1x1 Conv then a
    3x3 Conv; JAX's default k=((1, 1), (3, 3)) raises a TypeError in its
    Conv, ROADMAP "Known differences")."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, e)
        self.m = nn.Sequential(*(Bottleneck(self.c_, self.c_, shortcut, g,
                                            (1, 3), 1.0) for _ in range(n)))


class C3x(_C3Base):
    """C3 whose n bottlenecks are CrossConv (1, 3) then (3, 1), plus their
    input where `shortcut` (JAX layers.py:891-908)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__(c1, c2)
        self.m = nn.Sequential(*(Bottleneck(self.c_, self.c_, shortcut,
                                            k=((1, 3), (3, 1)), e=1.0)
                                 for _ in range(n)))


class C3TR(_C3Base):
    """C3 whose inner block is a TransformerBlock of 4 heads and n layers
    (JAX layers.py:927-942); `hw`: the tokens of the map it is built for
    (nn/transformer.py)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 hw: int = 0):
        super().__init__(c1, c2, e)
        from .transformer import TransformerBlock
        self.m = TransformerBlock(self.c_, self.c_, 4, n, hw)


class C3Ghost(_C3Base):
    """C3 with n GhostBottlenecks (JAX layers.py:965-980)."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__(c1, c2)
        self.m = nn.Sequential(*(GhostBottleneck(self.c_, self.c_)
                                 for _ in range(n)))


class RepC3(nn.Module):
    """cv1 (1x1 Conv to c2) through n RepConvs to c_ = c2 * e, plus cv2
    (1x1 Conv to c2), then cv3 (1x1 Conv) where c_ != c2 (JAX layers.py:
    945-962)."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c2, 1, 1)
        self.m = nn.Sequential(*(RepConv(c2 if i == 0 else c_, c_)
                                 for i in range(n)))
        self.cv2 = Conv(c1, c2, 1, 1)
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else None

    def forward(self, x):
        y = self.m(self.cv1(x)) + self.cv2(x)
        return self.cv3(y) if self.cv3 is not None else y


class BottleneckCSP(nn.Module):
    """CSP bottleneck (JAX layers.py:983-1002): cv1 through n Bottlenecks
    (e = 1) and the bare 1x1 cv3, beside the bare 1x1 cv2 of the input; BN
    and SiLU of both, then the 1x1 Conv cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0)
                                 for _ in range(n)))
        self.cv3 = Conv2d(c_, c_, 1, bias=False)
        self.cv2 = Conv2d(c1, c_, 1, bias=False)
        self.bn = BatchNorm(2 * c_)
        self.cv4 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(silu(self.bn(y)))


class SPP(nn.Module):
    """Spatial pyramid pooling (JAX layers.py:1005-1016): a 1x1 Conv to
    c1 // 2, beside its max pools of each size in `k`, then a 1x1 Conv."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [max_pool_same(x, k)
                                         for k in self.k], 1))


class HGStem(nn.Module):
    """HGNetv2's stem, ReLU throughout (JAX layers.py:1035-1050): a 3x3 s2
    Conv, zero-padded by one at the bottom and right; a 2x2 Conv and a 2x2
    Conv (each on a map padded the same way) beside a 2x2 stride-1 VALID
    max pool of it; a 3x3 s2 Conv of both, then a 1x1 Conv."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = Conv(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = Conv(cm, c2, 1, 1, act="relu")

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = F.max_pool2d(x, 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """HGNetv2's block (JAX layers.py:1053-1072): n k x k ReLU Convs (or
    LightConvs) in a chain, the input and every output side by side through
    a 1x1 ReLU Conv `sc` to c2 // 2 and a 1x1 ReLU Conv `ec` to c2, plus
    the input where `shortcut` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        block = ((lambda ci: LightConv(ci, cm, k)) if lightconv
                 else (lambda ci: Conv(ci, cm, k, act="relu")))
        self.m = nn.ModuleList(block(c1 if i == 0 else cm) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act="relu")
        self.ec = Conv(c2 // 2, c2, 1, 1, act="relu")
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y
