"""Low-light synthesis for training (JAX ops/degrade.py:14-27): the
reference's `img ** dark_param` gamma-crush of a [0, 1] batch
(ultralytics/models/yolo/detect/train.py:79,103)."""

from __future__ import annotations

import torch


def _integer_pow(x, n: int):
    """x ** n by square-and-multiply in the order of `jax.lax.integer_pow`
    (the product of the set bits' squares, lowest bit first), so that the
    rounding equals the JAX package's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def lowlight_degrade(img, dark_param):
    """Gamma-crush a [0, 1] image batch: clip(img, 0, 1) ** dark_param.
    Integer exponents from 1 to 64 multiply, others go through torch.pow."""
    x = img.clamp(0.0, 1.0)
    p = float(dark_param)
    if p.is_integer() and 1 <= p <= 64:
        return _integer_pow(x, int(p))
    return torch.pow(x, p)
