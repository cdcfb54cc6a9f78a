"""Transformer blocks as torch modules (JAX nn/transformer.py).

C3TR's inner block: `TransformerBlock` (JAX transformer.py:92-110) with
its `TransformerLayer`s (:77-89), whose attention is flax's
MultiHeadDotProductAttention at qkv_features = c without biases, here in
plain tensor math (`MultiHeadAttention`). Sequences are (B, L, C), a map's
pixels in row-major order, as JAX's NHWC reshape lists them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv, Linear, softmax, weak_const


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention(num_heads, qkv_features=c,
    use_bias=False) on one sequence: query, key and value projections split
    into heads of c // num_heads, the query divided by the square root of
    that depth, a softmax over the keys, the heads joined and projected by
    `out`."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(c, c, bias=False)
        self.key = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(c, c, bias=False)
        self.out = nn.Linear(c, c, bias=False)

    def forward(self, x):
        b, n, c = x.shape
        heads = lambda t: t.reshape(b, n, self.num_heads, -1)
        q, k, v = (heads(f(x)) for f in (self.query, self.key, self.value))
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
