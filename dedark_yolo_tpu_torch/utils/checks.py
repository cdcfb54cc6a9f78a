"""Runtime checks (JAX utils/checks.py; reference ultralytics/utils/checks.py)."""

from __future__ import annotations

import math

from . import LOGGER


def check_imgsz(imgsz, stride=32, min_dim=1, floor=0):
    """Round imgsz (an int or [h, w]) UP to a multiple of stride, and to at
    least `floor` (JAX utils/checks.py:19-32, reference checks.py:45): the
    FPN's concats need imgsz % max_stride == 0. A list comes back a list
    where `min_dim` is 2 or it holds more than one size, else an int."""
    if isinstance(imgsz, (list, tuple)):
        sz = [max(math.ceil(x / stride) * stride, floor) for x in imgsz]
        changed = list(imgsz) != sz
        out = sz if min_dim == 2 or len(sz) > 1 else sz[0]
    else:
        out = max(math.ceil(imgsz / stride) * stride, floor)
        changed = out != imgsz
    if changed:
        LOGGER.info(f"imgsz {imgsz} is not a multiple of stride {stride}; "
                    f"updated to {out}")
    return out


def check_imshow(warn=False):
    """True when this host can open OpenCV display windows (JAX
    utils/checks.py:35; reference checks.py:352-364). Probed in a
    subprocess: a GUI-less OpenCV stack can abort the process on imshow,
    which no try/except catches."""
    import subprocess
    import sys
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import cv2, numpy as np;"
             "cv2.imshow('t', np.zeros((1, 1, 3), np.uint8));"
             "cv2.waitKey(1); cv2.destroyAllWindows(); cv2.waitKey(1)"],
            capture_output=True, timeout=20)
        ok = r.returncode == 0
    except Exception:
        ok = False
    if not ok and warn:
        LOGGER.warning("environment does not support cv2.imshow() — "
                       "show=True disabled")
    return ok
