"""Exponential moving average of the model's parameters and BN statistics
(JAX utils/ema.py:14-30; reference ultralytics/utils/torch_utils.py:344-377,
ModelEMA): decay = 0.9999 * (1 - exp(-updates / 2000)).

The EMA is a dict of tensors keyed like the model's state_dict, so it loads
into the same architecture with `load_state_dict`.
"""

from __future__ import annotations

import math

import torch


def ema_init(params: dict) -> dict:
    """A copy of `params` (a state_dict: parameters and buffers)."""
    return {k: v.detach().clone() for k, v in params.items()}


def ema_decay(updates: int, base_decay=0.9999, tau=2000.0) -> float:
    return base_decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, updates: int,
               base_decay=0.9999, tau=2000.0) -> int:
    """One EMA step in place on `ema_params`: e = e * d + p * (1 - d) for
    every entry of the state_dict `params`, with the decay of the new
    update count. Returns that count (JAX returns the new tree with it)."""
    updates += 1
    d = ema_decay(updates, base_decay, tau)
    keys = list(ema_params)
    e = [ema_params[k] for k in keys]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(
        e, [params[k].detach().to(ema_params[k].dtype) for k in keys],
        alpha=1.0 - d)
    return updates
