"""Depth-2 dispatch/process pipelining for device loops (JAX
utils/pipeline.py).

Submit batch i+1 to the device before reading back batch i, so the next
batch's host work (load, letterbox, upload, launches) overlaps the current
batch's device time, on one thread.
"""

from __future__ import annotations


def pipelined(items, dispatch, process):
    """For each item: out = dispatch(item) (async device submit), then
    process() the PREVIOUS out — results are processed strictly in dispatch
    order, one step behind. A dispatch returning None is skipped."""
    pending = None
    for it in items:
        out = dispatch(it)
        if pending is not None:
            process(pending)
        pending = out
    if pending is not None:
        process(pending)
