"""Host image I/O through OpenCV (JAX utils/patches.py), and the import of
an optional host package.

`imread` and `imwrite` survive non-ASCII paths (np.fromfile + imdecode,
imencode + tofile), as the JAX package's do; nothing global is patched.
OpenCV, Pillow and matplotlib are imported when a call needs them, never at
import: a host without one (the card's machine has no OpenCV) runs every
path that does not draw, encode or decode, and a call that needs the
package raises an ImportError naming it (`require`), with no fallback.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np

PACKAGES = {"cv2": "OpenCV (cv2)", "PIL": "Pillow (PIL)", "yaml": "PyYAML",
            "matplotlib": "matplotlib", "mss": "mss"}


def require(module: str, what: str):
    """`import module`, or an ImportError naming the package and `what`
    needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs {PACKAGES.get(module, module)}, "
                          "which is not installed on this host") from e


def imread(filename, flags=None):
    """cv2.imread that survives non-ASCII paths (np.fromfile + imdecode);
    None when the file cannot be decoded."""
    cv2 = require("cv2", f"reading the image {filename}")
    if flags is None:
        flags = cv2.IMREAD_COLOR
    try:
        img = cv2.imread(str(filename), flags)
        if img is not None:
            return img
    except cv2.error:
        pass
    try:
        return cv2.imdecode(np.fromfile(str(filename), np.uint8), flags)
    except Exception:
        return None


def imwrite(filename, img, params=None):
    """cv2.imwrite via imencode + tofile (non-ASCII-safe); True on success."""
    cv2 = require("cv2", f"writing the image {filename}")
    try:
        ok, buf = cv2.imencode(Path(str(filename)).suffix, img, params or [])
        if ok:
            buf.tofile(str(filename))
        return bool(ok)
    except Exception:
        return False
