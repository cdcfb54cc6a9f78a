"""The low-light enhance kernels: wrappers of `csrc/fused_enhance.cu` and
`csrc/usm.cu`.

Port of `dedark_yolo_tpu/ops/pallas/enhance_kernel.py`: `fused_enhance_pallas`
(the whole chain in one pass) with its differentiable wrapper
`fused_enhance_diff`, and `usm_pallas` (blur and sharpen only, after a point
chain run outside the kernel). Both are torch ops
(`torch.library.custom_op`, namespace `OPS`), so that `torch.export` keeps
each as one node of an exported program and a loaded artifact calls them.
Each op's CUDA implementation launches its kernel and raises if it cannot;
its CPU implementation is its `*_reference`, the plain version the kernel
is held against; its backward recomputes through that plain version. An
importer of an exported program imports this module first, so that the
ops are registered. `fused_enhance`'s kernel regresses the
per-image filter parameters from the features itself (the JAX package makes
them outside its kernel, `param_vec` here), so that its wrapper launches one
kernel and nothing else.

Both kernels run one blur-and-sharpen stage (`csrc/usm_tile.cuh`): a block
walks one strip of SW output columns of one image down one segment of rows,
RO rows at a time. `enhance_plan` is that launch plan in plain Python (strip
width, rows a segment, grid, shared memory), so the CPU tests walk it; the
wrappers pass its rows a segment to the launch. Its constants and
`smem_bytes` mirror `csrc/usm_tile.cuh`, which owns them: a CPU test reads
them from the source, and the card's smoke run holds `smem_bytes` to the
library's `enhance_smem_bytes`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..nn import enhance as E
from ..utils import device_cache
from . import _build

OPS = "dedark_yolo_tpu_torch"   # the namespace of the ops: torch.ops.<OPS>.*
NAME = "fused_enhance"
USM_NAME = "usm"
_build.LAUNCHES.setdefault(NAME, 0)
_build.LAUNCHES.setdefault(USM_NAME, 0)
MIN_SIDE = 13  # one reflection covers the 12-pixel blur halo

# The stage's fixed shape (csrc/usm_tile.cuh): the blur radius, output
# columns of a strip, rows of a chunk, outputs of one horizontal task.
PAD, SW, RO, CO = 12, 72, 8, 9
NT = SW + 2 * PAD             # threads of a block, one a window column
# Rows a segment: at least MIN_SEG_ROWS (the 2*PAD-row halo of a segment is
# computed twice), and as many segments as fit in WAVES waves of resident
# blocks: at ~160 registers a thread, 4 blocks of NT threads share an SM
# (65,536 registers) on 132 SMs. Two full waves measured fastest on an
# H100 at 16x640x640 (96-row segments, 1,008 blocks; 80 rows, 1,152 blocks
# and a third partial wave, was 3-8% slower); at B = 1 the MIN_SEG_ROWS
# floor still gives more blocks than SMs.
MIN_SEG_ROWS = 32
BLOCKS_PER_SM, SM_COUNT, WAVES = 4, 132, 2
MAX_GRID_YZ = 65_535


def smem_bytes():
    """Shared memory of a block (the .cu's `Smem`): RO rows of the
    vertically blurred window, NT * 3 lanes, and RO output row segments,
    SW * 3 lanes, all f32."""
    return RO * (NT * 3 + SW * 3) * 4


def enhance_plan(B, H, W):
    """Launch plan of the blur stage for a (B, H, W, 3) image: block
    (x, y, z) = (strip, segment, image) owns output columns [x*SW, x*SW +
    SW) and rows [y*seg_rows, y*seg_rows + seg_rows), clipped to the image.
    """
    if min(H, W) < MIN_SIDE or B < 1:
        raise ValueError(f"the blur needs B >= 1 and H, W >= {MIN_SIDE}, got "
                         f"{(B, H, W)}")
    if B > MAX_GRID_YZ:
        raise ValueError(f"at most {MAX_GRID_YZ} images a launch, got {B}")
    strips = -(-W // SW)
    fit = WAVES * BLOCKS_PER_SM * SM_COUNT // (B * strips)
    segments = max(1, min(fit, H // MIN_SEG_ROWS))
    seg_rows = -(-H // segments)
    seg_rows = -(-seg_rows // RO) * RO         # whole chunks
    segments = -(-H // seg_rows)
    return {"sw": SW, "ro": RO, "co": CO, "threads": NT,
            "seg_rows": seg_rows, "strips": strips, "segments": segments,
            "grid": (strips, segments, B), "blocks": strips * segments * B,
            "smem_bytes": smem_bytes()}


def param_vec(features, dedark_A):
    """(B, 16) f32 per-image filter parameters in the JAX `_param_vec` slot
    order: 0 dedark_w, 1-3 A, 4-6 wb, 7 gamma, 8 contrast, 9 usm, 10-15
    zero. `csrc/fused_enhance.cu` computes the same values itself from the
    features and A, so that the wrapper launches one kernel and nothing
    else."""
    p = E.regress_filter_params(features.float())
    b = features.shape[0]
    return torch.cat([p["dedark_w"], dedark_A.float(), p["wb"], p["gamma"],
                      p["contrast"], p["usm"],
                      features.new_zeros((b, 6), dtype=torch.float32)],
                     dim=-1).contiguous()


@device_cache(maxsize=8)
def gaussian_taps(device: torch.device):
    """The 25 taps as f32, normalised in float64 like `gaussian_kernel_25`:
    the values `csrc/usm_tile.cuh` compiles in (its `G`; a CPU test holds
    the two equal bit for bit). Built outside inference mode and kept out
    of tracing, as `nn.enhance._blur_matrix` is (ROADMAP C10)."""
    with torch.inference_mode(False):
        return torch.tensor(E.gaussian_kernel_25(), dtype=torch.float32,
                            device=device)


def fused_enhance_reference(img, features, dedark_A, IcA):
    """Plain version: the chain in f32, returned in the image's dtype."""
    return E.apply_filter_chain(img.float(), features.float(),
                                dedark_A.float(), IcA.float()).to(img.dtype)


def _check_image(name, img):
    """Raise unless img is a CUDA (B, H, W, 3) f32/bf16 tensor whose sides
    one reflection of the 12-pixel blur halo covers."""
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {img.device}")
    if img.dim() != 4 or img.shape[3] != 3 \
            or img.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} needs a (B, H, W, 3) f32/bf16 image, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if min(img.shape[1:3]) < MIN_SIDE:
        raise ValueError(f"{name} needs H, W >= {MIN_SIDE}, got "
                         f"{img.shape[1]}x{img.shape[2]}")


# fused_enhance_launch(img, ica, features, A, out, B, H, W, bf16, stream,
#                      seg_rows)
FUSED_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p, ctypes.c_int])
# usm_launch(img, usm, out, B, H, W, bf16, stream, seg_rows)
USM_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p, ctypes.c_int])


@lru_cache(maxsize=1)
def _launch_fn():
    fn = _build.load(NAME).fused_enhance_launch
    fn.argtypes = FUSED_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_fused_enhance(img: torch.Tensor, features: torch.Tensor,
                          dedark_A: torch.Tensor,
                          IcA: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of `fused_enhance`: one launch of the
    kernel on the current stream, counted in `_build.LAUNCHES`."""
    _check_image(NAME, img)
    b, h, w, _ = img.shape
    if tuple(IcA.shape) != (b, h, w, 1) or tuple(features.shape) != (b, 15) \
            or tuple(dedark_A.shape) != (b, 3):
        raise ValueError("IcA must be (B, H, W, 1), features (B, 15), "
                         "dedark_A (B, 3)")
    ica = IcA.to(img.dtype)
    if not (img.is_contiguous() and ica.is_contiguous()):
        raise ValueError("fused_enhance needs contiguous NHWC img and IcA")
    if any(t.device != img.device for t in (features, dedark_A, ica)):
        raise ValueError("fused_enhance inputs must share one device")
    feats = features.float().contiguous()
    A = dedark_A.float().contiguous()
    plan = enhance_plan(b, h, w)
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    with torch.cuda.device(img.device):
        rc = _launch_fn()(img.data_ptr(), ica.data_ptr(), feats.data_ptr(),
                          A.data_ptr(), out.data_ptr(), b, h, w,
                          int(img.dtype == torch.bfloat16), stream,
                          plan["seg_rows"])
    if rc != 0:
        raise RuntimeError(f"fused_enhance launch failed with CUDA error {rc}")
    _build.LAUNCHES[NAME] += 1
    return out


def _recompute_backward(plain, ctx, grad):
    """Gradients of `plain` at the saved inputs, by running it again under
    autograd, for the inputs that need one (None for the others)."""
    need = ctx.needs_input_grad
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        out = plain(*inputs)
        wrt = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad.to(out.dtype)))
    return tuple(next(grads) if n else None for n in need)


def _save_inputs(ctx, inputs, output):
    """Only the raw inputs are saved, so no full-resolution intermediate
    lives between forward and backward (the JAX custom VJP,
    enhance_kernel.py:323-348)."""
    ctx.save_for_backward(*inputs)


def _fused_enhance_backward(ctx, grad):
    return _recompute_backward(E.apply_filter_chain, ctx, grad)


# DeDark -> WB -> Gamma -> Contrast -> USM in one pass, as a torch op:
# fused_enhance(img, features, dedark_A, IcA). img (B, H, W, 3) f32 or bf16
# in [0, 1], contiguous NHWC; features (B, 15); dedark_A (B, 3); IcA
# (B, H, W, 1), staged in the image's dtype. Returns the enhanced image in
# the image's dtype; the math runs in f32. A CUDA tensor launches the
# kernel (or raises), a CPU one runs `fused_enhance_reference`; under
# torch.export the op stays one node of the graph (its fake version gives
# the shape). The backward recomputes through the plain chain.
fused_enhance = torch.library.custom_op(
    f"{OPS}::{NAME}", _launch_fused_enhance, mutates_args=(),
    device_types="cuda")
fused_enhance.register_kernel("cpu", fused_enhance_reference)
fused_enhance.register_fake(lambda img, *rest: torch.empty_like(img))
fused_enhance.register_autograd(_fused_enhance_backward,
                                setup_context=_save_inputs)


def usm_reference(y, usm_param):
    """Plain version of `usm`: `usm_filter` in f32, returned in y's dtype."""
    return E.usm_filter(y.float(), usm_param.float()).to(y.dtype)


@lru_cache(maxsize=1)
def _usm_launch_fn():
    fn = _build.load(USM_NAME).usm_launch
    fn.argtypes = USM_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_usm(y: torch.Tensor, usm_param: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of `usm`: one launch of the kernel on the
    current stream, counted in `_build.LAUNCHES`."""
    _check_image(USM_NAME, y)
    b, h, w, _ = y.shape
    if tuple(usm_param.shape) != (b, 1):
        raise ValueError(f"usm_param must be (B, 1), got {tuple(usm_param.shape)}")
    if not y.is_contiguous():
        raise ValueError("usm needs a contiguous NHWC y")
    if usm_param.device != y.device:
        raise ValueError("usm inputs must share one device")
    s = usm_param.float().contiguous()
    plan = enhance_plan(b, h, w)
    out = torch.empty_like(y)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = _usm_launch_fn()(y.data_ptr(), s.data_ptr(), out.data_ptr(),
                              b, h, w, int(y.dtype == torch.bfloat16), stream,
                              plan["seg_rows"])
    if rc != 0:
        raise RuntimeError(f"usm launch failed with CUDA error {rc}")
    _build.LAUNCHES[USM_NAME] += 1
    return out


def _usm_backward(ctx, grad):
    return _recompute_backward(usm_reference, ctx, grad)


# Unsharp mask as a torch op: usm(y, usm_param), a reflect-padded 25-tap
# sigma-5 blur, (y - blur) * s + y. y (B, H, W, 3) f32 or bf16, contiguous
# NHWC, the point-filtered image; usm_param (B, 1). Returns y's dtype; the
# math runs in f32. CUDA launches the kernel, the CPU runs `usm_reference`;
# the backward recomputes through the plain version (the JAX package has
# no backward kernel here: its XLA chain is differentiated).
usm = torch.library.custom_op(f"{OPS}::{USM_NAME}", _launch_usm,
                              mutates_args=(), device_types="cuda")
usm.register_kernel("cpu", usm_reference)
usm.register_fake(lambda y, usm_param: torch.empty_like(y))
usm.register_autograd(_usm_backward, setup_context=_save_inputs)
