"""Exponential moving average of the model's parameters and BN statistics
(JAX utils/ema.py:14-30; reference ultralytics/utils/torch_utils.py:344-377,
ModelEMA): decay = 0.9999 * (1 - exp(-updates / 2000)).

The EMA is a dict of tensors keyed like the model's state_dict, so it loads
into the same architecture with `load_state_dict`.
"""

from __future__ import annotations

import math

import torch


def ema_init(state: dict) -> dict:
    """A copy of `state` (a state_dict: parameters and buffers)."""
    return {k: v.detach().clone() for k, v in state.items()}


def ema_decay(updates: int, base_decay=0.9999, tau=2000.0) -> float:
    return base_decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_update(ema: dict, state: dict, updates: int, base_decay=0.9999,
               tau=2000.0) -> int:
    """One EMA step in place: e = e * d + s * (1 - d) for every entry, with
    the decay of the new update count. Returns that count."""
    updates += 1
    d = ema_decay(updates, base_decay, tau)
    keys = list(ema)
    e = [ema[k] for k in keys]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [state[k].detach().to(ema[k].dtype) for k in keys],
                        alpha=1.0 - d)
    return updates
