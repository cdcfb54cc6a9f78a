"""Conv blocks of the flagship graph as torch modules, NCHW inside.

Ports of the JAX package's `nn/layers.py` (Conv, Conv2d, AddConv, Bottleneck,
C2f, SPPF, AsffTribeLevel). Module attribute names are the reference fork's,
so `state_dict()` keys equal what `utils/torch_import.export_state_dict`
emits from the JAX params (`model.{i}.cv1.conv.weight`, ...). The convs go to
cuDNN through `F.conv2d`, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Sequence

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
# an f32 map the fused ops.
LEAKY_SLOPE_BF16 = 0.10009765625     # 0.1 rounded to bf16, exact in f32


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


def leaky_relu(x):
    """LeakyReLU(0.1)."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, 0.1)
    return torch.where(x >= 0, x, x * LEAKY_SLOPE_BF16)


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


def Conv2d(c1: int, c2: int, k: int = 1, s: int = 1):
    """Bare conv with bias (JAX layers.py:206)."""
    return BiasConv2d(c1, c2, k, s, autopad(k))


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


class C2f(nn.Module):
    """Cross-stage partial with dense growth. Reference block.py:373-393."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


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


class AsffTribeLevel(nn.Module):
    """Adaptive 3-level spatial feature fusion. Reference block.py:48-115.

    Input [deepest P5, P4, P3], widths `dims`. Ports the L-scale module,
    where every branch already has the level's width; other widths would
    need the JAX package's aligning convs, whose weights the reference
    checkpoint layout has no names for, so they raise.

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
        need_same = {0: (0, 1), 1: (0, 1), 2: ()}[level]
        if any(dims[j] != inter for j in need_same):
            raise NotImplementedError(
                f"AsffTribeLevel level {level} at widths {tuple(dims)}: only "
                "the reference's L-scale widths are ported")
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

    def forward(self, xs):
        x0, x1, x2 = xs
        # (branch at the level's resolution, pre-upsample tensor, scale)
        if self.level == 0:
            r0 = (x0, x0, 1)
            r1 = (F.max_pool2d(x1, 2, 2),) * 2 + (1,)
            r2 = (self.stride_level_2(max_pool_same(x2, 3, 2)),) * 2 + (1,)
        elif self.level == 1:
            r0 = (upsample_nearest(x0, 2), x0, 2)
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
        w = softmax(self.weight_levels(torch.cat(ws, 1)), dim=1)
        fused = (r0[0] * w[:, 0:1] + r1[0] * w[:, 1:2] + r2[0] * w[:, 2:3])
        return self.expand(fused)
