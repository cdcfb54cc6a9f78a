"""The letterbox's geometry (JAX ops/letterbox.py:19-31). The port
letterboxes on the host through `native.letterbox_batch`; the JAX
package's in-graph `letterbox_jax` has no caller there and is not ported
(ROADMAP "Not queued")."""

from __future__ import annotations


def letterbox_params(orig_hw, new_hw):
    """(gain, pad_w, pad_h) of a centred letterbox from `orig_hw` to
    `new_hw`, both (h, w) ints: the reference's geometry (augment.py:552-577)
    with scaleup=True and the whole target shape (no stride padding)."""
    gain = min(new_hw[0] / orig_hw[0], new_hw[1] / orig_hw[1])
    unpad_w, unpad_h = round(orig_hw[1] * gain), round(orig_hw[0] * gain)
    return gain, (new_hw[1] - unpad_w) / 2, (new_hw[0] - unpad_h) / 2
