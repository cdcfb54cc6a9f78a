"""Time the enhance kernels against other sources of them, on one card.

    python -m dedark_yolo_tpu_torch.tools.enhance_ab [DIR ...]
        [--seg-rows 40,160] [--iters 20] [--rounds 2]

At the smoke's main-path shape (16, 640, 640, 3), in f32 and in bf16, on the
kernel phase's random-prior draw (`enhance_inputs`, `usm_inputs`, which
`chip_smoke.py` draws its kernel-phase inputs from too). Variants of each
kernel (`fused_enhance`, `usm`): `csrc/<kernel>.cu` under
`ops.enhance_kernel.enhance_plan`'s rows a segment, the same at each
`--seg-rows` value, and each DIR's `<kernel>.cu` (another revision with the
same launch arguments, say), which nvcc compiles against the `usm_tile.cuh`
in the same DIR. Each variant's output is held to the plain version under
`TOL`; then the variants of one kernel and dtype run in turns — each in
order, then in reverse — `rounds` times, each time a CUDA-event median over
`iters` raw launches (no parameter or output allocation). Prints one JSON
line: the card's name and power limit, its SM clock and power draw after
each kernel's turns (nvidia-smi), each variant's ms (every turn and the
median) and check, and each source's ptxas report (the committed sources'
only when this process compiled them: `_build.build` skips a library that
exists); then exits non-zero if a variant failed its check.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import enhance_kernel as K
from . import _ab

SHAPE = (16, 640, 640)
SEED = 0
# |kernel - plain| <= ATOL + RTOL * |plain|, compared in the working dtype.
# f32: both compute in f32, but exp(g*log v) against pow, FMA contraction
# and another association of the contrast scale differ by a few ulps, which
# gamma (<= 3), the DeDark division (tx >= 0.2) and the sharpen's
# cancellation (s <= 5) amplify; the JAX package holds its own kernel to the
# chain at the same 1e-4 (tests/test_pallas_enhance.py). bf16: both round
# one f32 result to bf16 once, so they differ by at most one bf16 ulp.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2 ** -7)}


def enhance_inputs(b, h, w, dtype, default_priors, device):
    """fused_enhance's (img, features, A, IcA) at (b, h, w), seeded by the
    shape: img in [0.02, 0.98], features ~ N(0, 0.7), and random priors or
    the layer's defaults (A 0.8, IcA 0.5)."""
    rng = np.random.default_rng([SEED, b, h, w])
    img = rng.uniform(0.02, 0.98, (b, h, w, 3)).astype(np.float32)
    feats = rng.normal(0, 0.7, (b, 15)).astype(np.float32)
    if default_priors:
        A = np.full((b, 3), 0.8, np.float32)
        ica = np.full((b, h, w, 1), 0.5, np.float32)
    else:
        A = rng.uniform(0.6, 0.9, (b, 3)).astype(np.float32)
        ica = rng.uniform(0.2, 0.8, (b, h, w, 1)).astype(np.float32)
    t = [torch.from_numpy(x).to(device) for x in (img, feats, A, ica)]
    return t[0].to(dtype), t[1], t[2], t[3].to(dtype)


def usm_inputs(b, h, w, dtype, device):
    """A point-filtered-like image (values up to 3) and strengths in the
    filter's (0, 5) range."""
    rng = np.random.default_rng([SEED, b, h, w, 1])
    y = rng.uniform(0.0, 3.0, (b, h, w, 3)).astype(np.float32)
    s = rng.uniform(0.0, 5.0, (b, 1)).astype(np.float32)
    return (torch.from_numpy(y).to(device).to(dtype),
            torch.from_numpy(s).to(device))


def compare(got, want, dtype):
    """|kernel - plain| <= ATOL + RTOL * |plain| in `dtype`'s tolerance."""
    g, r = got.float(), want.float()
    err = (g - r).abs()
    atol, rtol = TOL[str(dtype)[6:]]
    at = int(err.argmax())
    return {"max_abs_err": float(err.max()),
            "plain_at_max_err": float(r.flatten()[at]),
            "max_abs_plain": float(r.abs().max()), "atol": atol, "rtol": rtol,
            "ok": bool(torch.isfinite(g).all())
            and bool((err <= atol + rtol * r.abs()).all())}


def _launcher(lib, kernel):
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = K.FUSED_ARGTYPES if kernel == K.NAME else K.USM_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _call(fn, kernel, inputs, out, seg_rows, stream):
    """A no-argument call of one raw launch on the pre-made inputs."""
    B, H, W, _ = out.shape
    args = (*(t.data_ptr() for t in inputs), out.data_ptr(), B, H, W,
            int(out.dtype == torch.bfloat16), stream, seg_rows)

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{kernel}: launch returned {rc}")
    return call


def run(others=(), seg_rows=(), iters=20, rounds=2):
    if not torch.cuda.is_available():
        raise SystemExit("enhance_ab: no CUDA device")
    dev = torch.device("cuda")
    smi = _ab.nvidia_smi()
    kernels = (K.NAME, K.USM_NAME)
    logs = _build.build(list(kernels))
    libs = {"csrc": {k: _build.load(k) for k in kernels}}
    ptxas = {"csrc": {k: _build.ptxas_lines(logs.get(k, "")) for k in kernels}}
    for d in others:
        libs[d], ptxas[d] = {}, {}
        for k in kernels:
            libs[d][k], log = _ab.build_other(Path(d) / f"{k}.cu", k)
            ptxas[d][k] = _build.ptxas_lines(log)

    B, H, W = SHAPE
    plan = K.enhance_plan(B, H, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, clocks = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        img, feats, A, ica = enhance_inputs(B, H, W, dtype, False, dev)
        y, s = usm_inputs(B, H, W, dtype, dev)
        s = s.float().contiguous()
        cases = {K.NAME: ((img, ica, feats, A),
                          K.fused_enhance_reference(img, feats, A, ica)),
                 K.USM_NAME: ((y, s), K.usm_reference(y, s))}
        for kernel, (inputs, want) in cases.items():
            calls, checks = {}, {}
            for src, lib in libs.items():
                fn = _launcher(lib[kernel], kernel)
                for sr in [plan["seg_rows"], *seg_rows]:
                    name = src if sr == plan["seg_rows"] \
                        else f"{src} seg_rows={sr}"
                    out = torch.empty_like(want)
                    calls[name] = _call(fn, kernel, inputs, out, sr, stream)
                    calls[name]()
                    torch.cuda.synchronize()
                    checks[name] = compare(out, want, dtype)
            turns = _ab.in_turns(calls, iters, rounds)
            key = f"{kernel} {str(dtype)[6:]}"
            clocks[key] = _ab.nvidia_smi(_ab.CLOCKS_QUERY)
            for name in calls:
                rows.append({"kernel": kernel, "dtype": str(dtype)[6:],
                             "variant": name,
                             "ms": statistics.median(turns[name]),
                             "turns_ms": turns[name], **checks[name]})
    return {"tool": "enhance_ab", "nvidia_smi": smi,
            "device": torch.cuda.get_device_name(0), "shape": [*SHAPE, 3],
            "plan": plan, "iters": iters, "rounds": rounds,
            "clocks_after": clocks, "rows": rows, "ptxas": ptxas}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*",
                    help="directories holding fused_enhance.cu, usm.cu and "
                         "the usm_tile.cuh they include")
    ap.add_argument("--seg-rows", default="",
                    help="comma-separated rows a segment to time csrc at, "
                         "beside the plan's")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    srs = [int(v) for v in a.seg_rows.split(",") if v]
    res = run(a.others, srs, a.iters, a.rounds)
    print(json.dumps(res), flush=True)
    if not all(r["ok"] for r in res["rows"]):
        raise SystemExit("enhance_ab: a variant disagrees with the plain "
                         "version")
    return res


if __name__ == "__main__":
    main()
