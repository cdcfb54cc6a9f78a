"""Transformer blocks as torch modules (JAX nn/transformer.py).

C3TR's inner block: `TransformerBlock` (JAX transformer.py:92-110) with
its `TransformerLayer`s (:77-89), whose attention is flax's
MultiHeadDotProductAttention at qkv_features = c, here in plain tensor
math (`MultiHeadAttention`; with `bias` flax's default use_bias=True).
RT-DETR's encoder and decoder stack: `AIFI` (:61-74) with its
`TransformerEncoderLayer` (:29-44) and 2D sin-cos position table, `MLP`,
`LayerNorm2d`, `inverse_sigmoid`, the bilinear sampler of one level
(`sample_level`, :146-177), `MSDeformAttn` (:180-246) and
`DeformableTransformerDecoderLayer` (:249-274). Sequences are (B, L, C), a
map's pixels in row-major order, as JAX's NHWC reshape lists them.

flax's defaults are kept where they are not torch's: LayerNorm's epsilon
1e-6 and its variance E[x^2] - E[x]^2 (`LayerNorm`), jax.nn.gelu's tanh
form.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Linear, softmax, weak_const


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention(num_heads, qkv_features=c,
    use_bias=bias): query, key and value projections split into heads of
    c // num_heads, the query divided by the square root of that depth, a
    softmax over the keys, the heads joined and projected by `out`. The
    four projections stay separate Linears (flax's `query`, `key`, `value`,
    `out`), so their biases are `bias` leaves in the optimizer's groups."""

    def __init__(self, c: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        lin = (lambda: Linear(c, c)) if bias else (
            lambda: nn.Linear(c, c, bias=False))
        self.query, self.key, self.value, self.out = (lin() for _ in range(4))

    def _key(self, k):
        """The key projection. Its bias adds one constant to every score of
        a query, to which the softmax is blind: its gradient is 0, which
        autograd would give as the rounding of sums that cancel (the card's
        and the host's then differ by 100%, and Adam would walk the bias on
        it). So the bias enters as a constant, added to the product as
        flax's DenseGeneral adds it."""
        lin = self.key
        if lin.bias is None:
            return lin(k)
        w, b = lin.weight, lin.bias.detach()
        if k.dtype != w.dtype:
            dt = torch.promote_types(k.dtype, w.dtype)
            k, w, b = k.to(dt), w.to(dt), b.to(dt)
        return F.linear(k, w) + b

    def forward(self, q, k=None, v=None):
        """Attention of the query sequence q (B, Lq, C) over the keys k and
        values v (B, Lk, C); k defaults to q and v to k (flax's
        inputs_k and inputs_v)."""
        k = q if k is None else k
        v = k if v is None else v
        b, n, c = q.shape
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], self.num_heads, -1)
        q, k, v = heads(self.query(q)), heads(self._key(k)), heads(self.value(v))
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)      # as jnp's einsum promotes
        q = q / weak_const(math.sqrt(q.shape[-1]), q)
        w = softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, c))


class TransformerLayer(nn.Module):
    """Self-attention plus the input, then two bias-free linear layers plus
    their input (JAX transformer.py:77-89)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.ma = MultiHeadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        x = x + self.ma(x)
        return x + self.fc2(self.fc1(x))


class TransformerBlock(nn.Module):
    """A 1x1 Conv where c1 != c2, the map as a sequence plus a biased
    linear layer of a learned position table `pos` (1, hw, c2), then n
    TransformerLayers (JAX transformer.py:92-110).

    `pos` has one row a pixel of the map the model is built for (`hw`; JAX
    sizes it at init, `DetectionModel` by a trace of its imgsz), so a block
    runs only at that map size and raises at another. Loading a state dict
    takes the size of its `pos` (a JAX tree made at another imgsz)."""

    def __init__(self, c1: int, c2: int, num_heads: int = 4, n: int = 1,
                 hw: int = 0):
        super().__init__()
        self.conv = Conv(c1, c2, 1, 1) if c1 != c2 else None
        self.pos = nn.Parameter(torch.zeros(1, hw, c2))
        self.linear = Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads)
                                  for _ in range(n)))
        self.sizing = None

    def size_for(self, hw: int):
        """A position table of hw rows (zeros) on the table's device."""
        self.pos.data = self.pos.new_zeros(1, hw, self.pos.shape[2])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        pos = state_dict.get(prefix + "pos")
        if pos is not None and pos.shape != self.pos.shape:
            self.pos.data = self.pos.new_empty(pos.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        if self.sizing is not None:     # DetectionModel's trace records hw
            self.sizing.append(h * w)
            return x
        if h * w != self.pos.shape[1]:
            raise ValueError(
                f"TransformerBlock was built for a map of {self.pos.shape[1]}"
                f" pixels and got {h}x{w}: its position table is sized at "
                "init (JAX transformer.py:106), so C3TR runs at one imgsz")
        seq = x.flatten(2).transpose(1, 2) + self.linear(self.pos)
        return self.tr(seq).transpose(1, 2).reshape(b, c, h, w)


# ---------------------------------------------------------------- RT-DETR


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last axis: epsilon 1e-6, the variance as
    E[x^2] - E[x]^2 (flax's fast variance, floored at 0), scale and bias.
    The statistics are taken in f32 (flax promotes a bf16 input to f32 for
    them), the result cast back to the input's dtype."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """flax's LayerNorm over the channels of a map (JAX transformer.py:
    126-132, reference LayerNorm2d), here on an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (JAX transformer.py:29-44): biased
    self-attention of x + pos over x + pos with values x, plus x, a
    LayerNorm; then a GELU MLP of width cm plus its input, a LayerNorm."""

    def __init__(self, c: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiHeadAttention(c, num_heads, bias=True)
        self.norm1 = LayerNorm(c)
        self.fc1 = Linear(c, cm)
        self.fc2 = Linear(cm, c)
        self.norm2 = LayerNorm(c)

    def forward(self, x, pos=None):
        q = x if pos is None else x + pos
        x = self.norm1(x + self.ma(q, q, x))
        return self.norm2(x + self.fc2(gelu(self.fc1(x))))


def sincos_pos_embed_2d(h: int, w: int, dim: int, temperature=10000.0,
                        device=None):
    """(1, h * w, dim) 2D sine-cosine position table (JAX transformer.py:
    47-58, reference AIFI.build_2d_sincos_position_embedding). Its rows
    come from meshgrid(grid_w, grid_h, indexing='ij') flattened, i.e. w
    major, while a map's sequence is h major: the reference's own order,
    which only shows on non-square maps, kept."""
    if dim % 4:
        raise ValueError(f"sincos position table: dim {dim} is not a "
                         "multiple of 4")
    grid_w = torch.arange(w, dtype=torch.float32, device=device)
    grid_h = torch.arange(h, dtype=torch.float32, device=device)
    gw, gh = torch.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32,
                                                device=device) / pos_dim))
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([torch.sin(out_w), torch.cos(out_w), torch.sin(out_h),
                      torch.cos(out_h)], 1)[None]


class AIFI(TransformerEncoderLayer):
    """Attention-based intra-scale feature interaction (JAX transformer.py:
    61-74): the encoder layer over an NCHW map's pixels with the sin-cos
    position table of its size. JAX builds it at c = the row's input width
    and the default cm 2048 and 8 heads, dropping the row's own args
    (ROADMAP, dropped yaml args)."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__(c1, cm, num_heads)

    def forward(self, x):
        b, c, h, w = x.shape
        pos = sincos_pos_embed_2d(h, w, c, device=x.device).to(x.dtype)
        seq = super().forward(x.flatten(2).transpose(1, 2), pos)
        return seq.transpose(1, 2).reshape(b, c, h, w)


class MLP(nn.Module):
    """num_layers Linears, ReLU between them (JAX transformer.py:113-123,
    reference MLP): c1 -> hidden ... hidden -> c2; `layers.{k}`."""

    def __init__(self, c1: int, hidden: int, c2: int, num_layers: int = 3):
        super().__init__()
        dims = [c1] + [hidden] * (num_layers - 1) + [c2]
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x) if i == len(self.layers) - 1 else F.relu(lin(x))
        return x


def inverse_sigmoid(x, eps: float = 1e-5):
    """log(x / (1 - x)), x clipped to [0, 1] and both terms to eps (JAX
    transformer.py:140-143)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sample_level(value, loc, h: int, w: int):
    """Bilinear samples of one level (JAX `_sample_level`, transformer.py:
    146-177): value (B, h * w, nh, hd), loc (B, Lq, nh, np, 2) in [0, 1]
    as (x, y) -> (B, Lq, nh, np, hd); F.grid_sample with bilinear weights,
    zero padding and align_corners=False (pixel = loc * size - 0.5), the
    reference's multi_scale_deformable_attn. bf16 values (amp) take JAX's
    own form, `_sample_corners`."""
    if value.dtype == torch.bfloat16:
        return _sample_corners(value, loc, h, w)
    b, _, nh, hd = value.shape
    lq, npts = loc.shape[1], loc.shape[3]
    v = value.reshape(b, h, w, nh, hd).permute(0, 3, 4, 1, 2).reshape(
        b * nh, hd, h, w)
    grid = (loc * 2 - 1).permute(0, 2, 1, 3, 4).reshape(b * nh, lq, npts, 2)
    dt = torch.promote_types(v.dtype, grid.dtype)
    out = F.grid_sample(v.to(dt), grid.to(dt), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(b, nh, hd, lq, npts).permute(0, 3, 1, 4, 2)


def _sample_corners(value, loc, h: int, w: int):
    """`sample_level` as JAX computes it: four masked gathers of the corners
    in the values' dtype, each times its weight (x and y fractions in the
    points' dtype, times the in-bounds mask), summed in the order (0, 0),
    (0, 1), (1, 0), (1, 1). On bf16 values the corners are bf16 and the sum
    f32, so each corner's gradient rounds to bf16 before the gathers'
    scatter-add, as XLA's does; `F.grid_sample` of the values in f32 rounds
    the value gradient once, which sits farther from JAX's bf16 than JAX's
    bf16 from its f32 (tests/test_torch_rtdetr_amp.py)."""
    b, _, nh, hd = value.shape
    lq, npts = loc.shape[1], loc.shape[3]
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    out = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi = xi.clamp(0, w - 1).long()
        yi = yi.clamp(0, h - 1).long()
        flat = (yi * w + xi).permute(0, 1, 3, 2).reshape(b, lq * npts, nh, 1)
        corner = torch.take_along_dim(value, flat.expand(-1, -1, -1, hd), 1)
        corner = corner.reshape(b, lq, npts, nh, hd).permute(0, 1, 3, 2, 4)
        out = out + corner * (wgt * inb)[..., None]
    return out


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (JAX transformer.py:180-246): from
    each query, nh * nl * np sampling offsets around its reference box
    (scaled by the box's half size over np) and softmax weights over each
    head's nl * np samples; the weighted sum of the bilinear reads of each
    level's value projection, then the output projection."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.np = n_heads, n_levels, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    def offset_bias(self):
        """The sampling offsets' initial bias (JAX `_offset_bias`, reference
        _reset_parameters): head h's direction on a ring of nh angles,
        scaled to the unit square, point i pushed i + 1 steps out."""
        thetas = np.arange(self.nh, dtype=np.float32) * (2.0 * math.pi
                                                          / self.nh)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid[:, None, None, :], (1, self.nl, self.np, 1))
        for i in range(self.np):
            grid[:, :, i, :] *= i + 1
        return torch.from_numpy(grid.reshape(-1).astype(np.float32))

    def forward(self, query, refer_bbox, values):
        """query (B, Lq, C); refer_bbox (B, Lq, 4) normalized cxcywh;
        values: each level's (B, C, H, W) map -> (B, Lq, C)."""
        nh, nl, npts = self.nh, self.nl, self.np
        b, lq, d = query.shape
        offsets = self.sampling_offsets(query).reshape(b, lq, nh, nl, npts, 2)
        attn = softmax(self.attention_weights(query).reshape(
            b, lq, nh, nl * npts), -1).reshape(b, lq, nh, nl, npts)
        center = refer_bbox[:, :, None, None, None, :2]
        half_wh = refer_bbox[:, :, None, None, None, 2:] * 0.5
        loc = center + offsets / npts * half_wh
        out = 0.0
        for lvl, v in enumerate(values):
            h, w = v.shape[2], v.shape[3]
            v = self.value_proj(v.flatten(2).transpose(1, 2)).reshape(
                b, h * w, nh, d // nh)
            sampled = sample_level(v, loc[:, :, :, lvl], h, w)
            out = out + (sampled * attn[:, :, :, lvl, :, None]).sum(3)
        return self.output_proj(out.reshape(b, lq, d))


class DeformableTransformerDecoderLayer(nn.Module):
    """Biased self-attention, deformable cross-attention and a ReLU FFN,
    each plus its input and a LayerNorm (JAX transformer.py:249-274)."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 d_ffn: int = 1024, n_levels: int = 4, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, bias=True)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, embed, refer_bbox, feats, query_pos=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed))
        embed = self.norm2(embed + self.cross_attn(
            embed if query_pos is None else embed + query_pos, refer_bbox,
            feats))
        y = self.linear2(F.relu(self.linear1(embed)))
        return self.norm3(embed + y)
