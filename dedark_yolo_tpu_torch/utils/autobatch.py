"""Autobatch: fit the train batch to the card's memory (JAX
utils/autobatch.py; reference ultralytics/utils/autobatch.py:32 fits to 67%
of CUDA memory).

JAX's fit on the port's measurements: the peak memory of one train step at
two trial batches (8 and 16), mem(b) = fixed + b * per_image, and the
largest multiple of 8 (at most 512) whose predicted peak stays under 0.67
of the card's memory. The JAX package reads the two sizes from XLA's
compile-time memory analysis; the port runs each trial step and reads
`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`, against
`torch.cuda.mem_get_info()[1]`.
"""

from __future__ import annotations

from . import LOGGER

FRACTION, DIVISOR, MAX_BATCH = 0.67, 8, 512


def fit_batch(m1, m2, limit, fraction=FRACTION, divisor=DIVISOR,
              max_batch=MAX_BATCH):
    """(batch, fixed, per_image) from the peaks m1 at `divisor` images and
    m2 at twice as many, under fraction * limit bytes (JAX's arithmetic)."""
    per_img = max((m2 - m1) / divisor, 1.0)
    fixed = m1 - per_img * divisor
    b = int((limit * fraction - fixed) / per_img)
    b = max(divisor, min(max_batch, (b // divisor) * divisor))
    return b, fixed, per_img


def autobatch(measure, device, fraction=FRACTION, divisor=DIVISOR,
              max_batch=MAX_BATCH):
    """The batch to train at on CUDA `device`. measure(b) runs one train
    step at batch b and leaves its state as it found it. Returns (batch,
    {"peaks": (m1, m2), "limit", "fixed", "per_image"})."""
    import torch
    if device.type != "cuda":
        raise NotImplementedError(
            "autobatch (batch < 0) measures the card's memory; on the CPU "
            "pass a batch size")
    peaks = []
    for b in (divisor, 2 * divisor):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        measure(b)
        torch.cuda.synchronize(device)
        peaks.append(torch.cuda.max_memory_allocated(device))
    limit = torch.cuda.mem_get_info(device)[1]
    batch, fixed, per_img = fit_batch(*peaks, limit, fraction, divisor,
                                      max_batch)
    LOGGER.info(f"autobatch: fixed={fixed / 1e9:.2f}GB per_img="
                f"{per_img / 1e6:.1f}MB -> batch {batch} ({fraction:.0%} of "
                f"{limit / 1e9:.0f}GB)")
    return batch, {"peaks": tuple(peaks), "limit": limit, "fixed": fixed,
                   "per_image": per_img}
