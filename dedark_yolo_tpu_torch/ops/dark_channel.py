"""Dark-channel priors of a batch (JAX ops/dark_channel.py:33-62).

dark_channel: the per-pixel minimum over RGB (the reference applies no
spatial window, train.py:42-45). atmospheric_light: the mean colour over the
brightest 0.1% of dark-channel pixels, the true mean over all of them (the
JAX package's fix of the reference's off-by-one, ROADMAP C5). IcA: the dark
channel of img / A. Images are NHWC floats in [0, 1].

The top of the dark channel is a stable descending sort, sliced, so that
equal dark values take the lower pixel index first, as `jax.lax.top_k` does
(ROADMAP C2); `torch.topk` promises no order among ties.
"""

from __future__ import annotations

import torch


def dark_channel(img):
    """Per-pixel channel minimum: (..., H, W, 3) -> (..., H, W)."""
    return img.amin(dim=-1)


def atmospheric_light(img, dark, top_fraction=0.001):
    """(B, H, W, 3) image and its (B, H, W) dark channel -> A (B, 3)."""
    b, h, w, _ = img.shape
    numpx = max(int(h * w * top_fraction), 1)
    _, idx = torch.sort(dark.reshape(b, h * w), dim=1, descending=True,
                        stable=True)
    top = torch.gather(img.reshape(b, h * w, 3), 1,
                       idx[:, :numpx, None].expand(-1, -1, 3))
    # accumulated in f32 and rounded once to the image's dtype, as jnp.mean
    # does for bf16
    return top.float().mean(dim=1).to(img.dtype)


def dark_channel_priors(img, top_fraction=0.001, eps=1e-6):
    """(A (B, 3), IcA (B, H, W, 1)) for a (B, H, W, 3) batch."""
    A = atmospheric_light(img, dark_channel(img), top_fraction)
    ica = dark_channel(img / (A[:, None, None, :] + eps))
    return A, ica[..., None]
