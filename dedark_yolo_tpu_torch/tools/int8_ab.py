"""Time the int8_conv kernel against other sources of it, on one card.

    python -m dedark_yolo_tpu_torch.tools.int8_ab [OTHER.cu ...]
        [--act silu] [--iters 20] [--rounds 2]

At the int8 probe's layer, (32, 80, 80, 256 -> 256), on the probe's draw
(`tools.int8_probe.layer_inputs`). Variants: `csrc/int8_conv.cu` and each
OTHER source of the kernel (an earlier revision, say), all launched under
`ops.int8_conv.kernel_plan`'s plan. Every source is built with the port's
nvcc flags and called through its `int8_conv_launch` with the wrapper's
arguments on the same pre-made inputs and weight repack; a source whose
launch takes only the first twelve of them (from before the launch plan)
ignores the rest, as the C calling convention allows. The variants run in
turns — each in order, then in reverse — `rounds` times, each time a
CUDA-event median over `iters` calls. Every variant is held to the plain
version (bit-exact for act=none; for silu at most one int8 step, on under
1% of the outputs). Prints one JSON line: the card's name and power limit
(nvidia-smi), each variant's ms (every turn and the median), TOP/s, share of
the int8 peak and check, and each source's ptxas report; then exits non-zero
if a variant failed its check.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from ..ops import _build
from ..ops import int8_conv as I
from . import _ab
from .int8_probe import layer_inputs

INT8_OP_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
OUT_SCALE = 0.05
SHAPE = (32, 80, 80, 256, 256)  # (B, H, W, C, Co), the probe's layer


def run(others=(), act="silu", iters=20, rounds=2):
    if not torch.cuda.is_available():
        raise SystemExit("int8_ab: no CUDA device")
    dev = torch.device("cuda")
    smi = _ab.nvidia_smi()
    logs = _build.build([I.NAME])
    variants = [("csrc/int8_conv.cu", _build.load(I.NAME))]
    ptxas = {"csrc/int8_conv.cu": _build.ptxas_lines(logs.get(I.NAME, ""))}
    for src in others:
        lib, log = _ab.build_other(Path(src), I.NAME)
        variants.append((src, lib))
        ptxas[src] = _build.ptxas_lines(log)

    B, H, W, C, Co = SHAPE
    x, w, scale = layer_inputs(*SHAPE, dev)
    plan = I.kernel_plan(*SHAPE)
    wt = w.permute(3, 0, 1, 2).reshape(Co, 9 * C).contiguous()
    want = I.conv3x3_s1_w8a8_reference(x, w, scale, OUT_SCALE, act)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls, checks = {}, {}
    for name, lib in variants:
        fn = lib.int8_conv_launch
        fn.argtypes, fn.restype = I.LAUNCH_ARGTYPES, ctypes.c_int
        out = torch.empty((B, H, W, Co), dtype=torch.int8, device=dev)
        args = (x.data_ptr(), wt.data_ptr(), scale.data_ptr(), out.data_ptr(),
                B, H, W, C, Co, 1.0 / OUT_SCALE, int(act == "silu"), stream,
                *(plan[k] for k in I.PLAN_ARGS))

        def call(fn=fn, args=args, name=name):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{name}: launch returned {rc}")
        call()
        torch.cuda.synchronize()
        d = (out.int() - want.int()).abs()
        checks[name] = {"max_step": int(d.max()),
                        "frac_differ": float((d > 0).float().mean())}
        checks[name]["ok"] = (checks[name]["max_step"] == 0 if act is None
                              else checks[name]["max_step"] <= 1
                              and checks[name]["frac_differ"] < 0.01)
        calls[name] = call
    turns = _ab.in_turns(calls, iters, rounds)
    ops = 2 * B * H * W * Co * 9 * C
    rows = []
    for name, _ in variants:
        ms = statistics.median(turns[name])
        rows.append({"variant": name, "ms": ms, "turns_ms": turns[name],
                     "tops": ops / ms / 1e9,
                     "peak_pct": 100 * ops / (ms / 1e3) / INT8_OP_PER_S,
                     **checks[name]})
    return {"tool": "int8_ab", "nvidia_smi": smi,
            "device": torch.cuda.get_device_name(0), "shape": list(SHAPE),
            "plan": {k: plan[k] for k in I.PLAN_ARGS}, "act": act,
            "iters": iters, "rounds": rounds, "rows": rows, "ptxas": ptxas}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other int8_conv sources")
    ap.add_argument("--act", choices=["none", "silu"], default="silu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    res = run(a.others, None if a.act == "none" else a.act, a.iters, a.rounds)
    print(json.dumps(res), flush=True)
    if not all(r["ok"] for r in res["rows"]):
        raise SystemExit("int8_ab: a variant disagrees with the plain version")
    return res


if __name__ == "__main__":
    main()
