"""SGD (nesterov) and AdamW with three parameter groups and gradient
accumulation: the tree path of JAX engine/optim.py (`label_params` :66-75,
`init_opt_state` :78-81, `opt_update` :84-153).

Parameters, gradients and optimizer buffers are dicts of tensors keyed by
the model's parameter names. Groups as the reference builds them
(ultralytics/engine/trainer.py:611-665): 'bias' (warmed up on its own lr),
'norm' (any other tensor of ndim <= 1: no decay), 'weight' (decayed).
Gradients are summed over `accumulate` calls, never averaged: the loss is
already the batch sum, so the sum over the window is the gradient of an
nbs-sized batch (the caller scales the decay by batch * accumulate / nbs).
On the call that closes a window the summed gradient is clipped to a global
norm of 10 and the update is applied in place.

torch-parity notes, as in the JAX package: SGD's decay is coupled (added to
the gradient) and its nesterov update is g + mu * buf; AdamW's decay is
decoupled (p -= lr * wd * p), betas (momentum, 0.999), with bias
correction. lr and momentum come per call, so the warmup ramps reach every
step. The JAX package's flat-master path (:156 on) is a TPU layout and is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

GROUPS = ("bias", "norm", "weight")


def label_params(params: dict) -> dict:
    """{name: 'bias' | 'norm' | 'weight'}: 'bias' by the leaf name, 'norm'
    for any other tensor with ndim <= 1, 'weight' for the rest."""
    return {name: "bias" if name.rsplit(".", 1)[-1] == "bias"
            else "norm" if p.ndim <= 1 else "weight"
            for name, p in params.items()}


@dataclass
class OptState:
    step: int = 0        # updates applied
    micro: int = 0       # calls in the open accumulation window
    acc: dict = field(default_factory=dict)    # summed gradients
    buf: dict = field(default_factory=dict)    # SGD momentum / Adam m
    buf2: dict = field(default_factory=dict)   # Adam v (zeros for SGD)


def init_opt_state(params: dict) -> OptState:
    zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
    return OptState(acc=zeros(), buf=zeros(), buf2=zeros())


@torch.no_grad()
def opt_update(params: dict, grads: dict, state: OptState, labels: dict, *,
               kind="sgd", lr_bias, lr, momentum, weight_decay=0.0005,
               accumulate=1, clip_norm=10.0, nesterov=True, b2=0.999,
               eps=1e-8) -> bool:
    """Add `grads` to the window; on every `accumulate`-th call clip the sum,
    update `params` in place and empty the window. Returns whether this call
    applied an update (callers step the EMA only then, reference trainer.py
    optimizer_step). `state` changes in place."""
    names = list(params)
    torch._foreach_add_([state.acc[n] for n in names],
                        [grads[n] for n in names])
    state.micro += 1
    if state.micro < accumulate:
        return False
    state.micro = 0
    state.step += 1
    g = [state.acc[n] for n in names]
    # global grad-norm clip (reference trainer.py:459-467), on the device
    gnorm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(g)))
    torch._foreach_mul_(g, torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0))
    for group in GROUPS:
        ns = [n for n in names if labels[n] == group]
        if not ns:
            continue
        p = [params[n] for n in ns]
        gi = [state.acc[n] for n in ns]
        b = [state.buf[n] for n in ns]
        lr_g = lr_bias if group == "bias" else lr
        wd = weight_decay if group == "weight" else 0.0
        if kind == "sgd":
            gw = torch._foreach_add(gi, p, alpha=wd) if wd else gi
            torch._foreach_mul_(b, momentum)
            torch._foreach_add_(b, gw)
            delta = torch._foreach_add(gw, b, alpha=momentum) if nesterov else b
            torch._foreach_add_(p, delta, alpha=-lr_g)
        else:  # adamw
            # the scalars rounded as the JAX package computes them: momentum
            # and the step are f32, 1 - b2 is taken in double, then cast
            one, mu = np.float32(1), np.float32(momentum)
            t = np.float32(state.step)
            v = [state.buf2[n] for n in ns]
            torch._foreach_mul_(b, float(mu))
            torch._foreach_add_(b, gi, alpha=float(one - mu))
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, gi, gi, value=1 - b2)
            c1 = float(one - mu ** t)
            c2 = float(one - np.float32(b2) ** t)
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            if wd:
                torch._foreach_mul_(
                    p, float(one - np.float32(lr_g) * np.float32(wd)))
            torch._foreach_addcdiv_(p, torch._foreach_div(b, c1), denom,
                                    value=-lr_g)
    torch._foreach_zero_(g)
    return True
