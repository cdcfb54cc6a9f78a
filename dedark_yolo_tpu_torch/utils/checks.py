"""Runtime checks (JAX utils/checks.py; reference ultralytics/utils/checks.py)."""

from __future__ import annotations

import math

from . import LOGGER


def check_imgsz(imgsz, stride=32):
    """Round an int imgsz UP to a multiple of stride (reference
    checks.py:45): the FPN's concats need imgsz % max_stride == 0. The
    JAX package's [h, w] form has no caller in the port."""
    out = math.ceil(imgsz / stride) * stride
    if out != imgsz:
        LOGGER.info(f"imgsz {imgsz} is not a multiple of stride {stride}; "
                    f"updated to {out}")
    return out
