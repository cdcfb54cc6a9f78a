"""dedark_yolo_tpu_torch: the Dedark-YOLO detector in PyTorch for NVIDIA Hopper.

A port of the JAX package `dedark_yolo_tpu`, which stays the reference. Layer
0's low-light enhance chain runs through a hand-written CUDA kernel
(`csrc/fused_enhance.cu`) on CUDA tensors; the rest is PyTorch and cuDNN.
Entry points run on `cuda` unless the caller passes `device="cpu"`; the
CLI is `python -m dedark_yolo_tpu_torch MODE k=v`.
"""

from .engine.model import YOLO

__version__ = "0.1.0"
__all__ = ["YOLO", "__version__"]
