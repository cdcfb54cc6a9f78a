"""Logging and run directories, and the JAX package's `utils` names
(JAX utils/__init__.py), each imported from its module at first use."""

import importlib
import logging
import sys
from pathlib import Path

LOGGER = logging.getLogger("dedark_yolo_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)


def increment_dir(path, exist_ok=False):
    """runs/detect/val -> runs/detect/val2, 3, ... when the dir already
    exists (reference utils/files.py increment_path), so successive runs
    never mix their files."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for i in range(2, 9999):
            cand = path.with_name(f"{path.name}{i}")
            if not cand.exists():
                return cand
    return path


def device_cache(maxsize):
    """functools.lru_cache for functions that build a device tensor from
    hashable arguments, bypassed while torch.export or torch.compile traces
    a model: a tensor made then is a FakeTensor, and one kept in the cache
    would come back to every later eager call."""
    import functools

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            import torch
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)
        call.cache_clear, call.cache_info = cached.cache_clear, cached.cache_info
        return call
    return wrap


# name -> the module of this package that defines it (JAX's __all__)
_EXPORTS = {
    "ap_per_class": "metrics", "compute_ap": "metrics",
    "match_predictions": "metrics", "match_from_iou": "metrics",
    "ConfusionMatrix": "metrics", "Metric": "metrics",
    "DetMetrics": "metrics", "smooth": "metrics",
    "ema_init": "ema", "ema_update": "ema", "ema_decay": "ema",
    "save_checkpoint": "checkpoint", "load_checkpoint": "checkpoint",
}
__all__ = ["LOGGER", "increment_dir", "device_cache", *_EXPORTS]


def __getattr__(name):
    """Import a re-exported name at its first use (PEP 562): the modules
    import this one for LOGGER."""
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
