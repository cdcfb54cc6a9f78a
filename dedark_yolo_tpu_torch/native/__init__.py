"""The native host library (JAX native/), loaded with ctypes.

`letterbox.cc` letterboxes a whole batch of BGR uint8 frames in a C++
thread pool (8.8 fixed-point bilinear from `resize.h`, lround geometry with
a float32 gain); `decode.cc` decodes JPEGs with libjpeg at the cheapest DCT
scale, then letterboxes or resizes them max-side. One ctypes call a batch,
the GIL released for its length. The sources are copies of the JAX
package's, with its signatures.

Each source builds on its own with g++ at first use, never at import, into
`_kernels_build/` beside the CUDA libraries, named by a hash of the sources
and the flags: `letterbox` links pthread only, `decode` also libjpeg, so a
host without `jpeglib.h` still letterboxes. There is no quiet fallback: a
failed build raises with the compiler's output, and `decode_*` raise naming
`jpeglib.h` where that header is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC.parent / "_kernels_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# library name -> (source, link flags); resize.h is hashed into both
LIBS = {"letterbox": ("letterbox.cc", ("-lpthread",)),
        "decode": ("decode.cc", ("-ljpeg", "-lpthread"))}

_libs: dict[str, ctypes.CDLL] = {}
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_ARGTYPES = {
    "letterbox_batch": [ctypes.POINTER(ctypes.c_void_p), _i32, ctypes.c_int32,
                        _u8, ctypes.c_int32, ctypes.c_uint8, ctypes.c_int32,
                        ctypes.c_int32],
    "decode_maxside_batch": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                             _u8, ctypes.c_int32, ctypes.c_int32, _i32,
                             ctypes.c_int32],
    "decode_letterbox_batch": [ctypes.POINTER(ctypes.c_char_p),
                               ctypes.c_int32, _u8, ctypes.c_int32,
                               ctypes.c_uint8, _i32, ctypes.c_int32],
}


def lib_path(name: str) -> Path:
    src, link = LIBS[name]
    h = hashlib.sha256()
    for f in (SRC / src, SRC / "resize.h"):
        h.update(f.read_bytes())
    h.update(" ".join(CXX_FLAGS + link).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library `name` unless it exists; returns its path. Raises
    with the compiler's output when the build fails."""
    out = lib_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the native library")
    src, link = LIBS[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC / src),
                           *link], capture_output=True, text=True)
    if proc.returncode:
        log = proc.stdout + proc.stderr
        if name == "decode" and "jpeglib.h" in log:
            raise RuntimeError("the native decode needs libjpeg's header "
                               "jpeglib.h, which this host lacks:\n" + log)
        raise RuntimeError(f"g++ failed for native/{src}:\n{log}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        for fn, args in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = None
        _libs[name] = lib
    return _libs[name]


def available() -> bool:
    """True when the letterbox library builds and loads (JAX native
    `available`): the library predict needs. It builds at the first call,
    as `load` does; a failed build answers False here and raises in
    `load`. The decode library is not asked for (`decode_*` raise where
    libjpeg is missing)."""
    try:
        load("letterbox")
    except (RuntimeError, OSError):
        return False
    return True


def letterbox_batch(images, size, fill=114, swap_rb=True, n_threads=0):
    """Letterbox a list of HWC uint8 (BGR) images into one (N, size, size,
    3) uint8 batch (RGB when swap_rb) in the native thread pool."""
    lib = load("letterbox")
    n = len(images)
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    shapes = np.asarray([[im.shape[0], im.shape[1]] for im in images],
                        dtype=np.int32).reshape(n, 2)
    dst = np.empty((n, size, size, 3), np.uint8)
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    lib.letterbox_batch(ptrs, shapes, n, dst, size, fill, 1 if swap_rb else 0,
                        n_threads)
    return dst


def _path_array(paths):
    enc = [str(p).encode() for p in paths]
    return (ctypes.c_char_p * len(enc))(*enc), enc   # keep enc alive


def decode_maxside_batch(paths, size, bgr=True, n_threads=0):
    """Decode JPEGs at the cheapest DCT scale, then resize max-side to
    `size`. Returns (imgs (N, size, size, 3) uint8, each image top-left;
    shapes (N, 4) int32 [loaded_h, loaded_w, orig_h, orig_w], zeros for a
    file that failed to decode)."""
    lib = load("decode")
    n = len(paths)
    dst = np.empty((n, size, size, 3), np.uint8)
    shapes = np.zeros((n, 4), np.int32)
    arr, _keep = _path_array(paths)
    lib.decode_maxside_batch(arr, n, dst, size, 1 if bgr else 0, shapes,
                             n_threads)
    return dst, shapes


def decode_letterbox_batch(paths, size, fill=114, n_threads=0):
    """Decode JPEGs and letterbox them into an (N, size, size, 3) RGB
    batch. Returns (batch, orig_shapes (N, 2) int32 [h0, w0], zeros for a
    file that failed to decode)."""
    lib = load("decode")
    n = len(paths)
    dst = np.empty((n, size, size, 3), np.uint8)
    shapes = np.zeros((n, 2), np.int32)
    arr, _keep = _path_array(paths)
    lib.decode_letterbox_batch(arr, n, dst, size, fill, shapes, n_threads)
    return dst, shapes
