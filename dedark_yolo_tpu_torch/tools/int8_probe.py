"""int8 W8A8 conv probe: the hand-written int8 kernel against a bf16 chain.

Port of `scripts/int8_probe.py`, whose numbers decided whether an int8
(PTQ) serving path pays. Each chain runs `layers` 3x3 stride-1 convolutions
at (batch, hw, hw, ch -> ch), each followed by the backbone's SiLU:

  bf16  cuDNN `F.conv2d` + `F.silu` in bf16, channels_last, weights w8/127
  int8  `ops.int8_conv.conv3x3_s1_w8a8(act='silu')`, the padding made before
        every layer as the JAX probe makes it, out_scale 0.05

with the JAX probe's weights, requantisation scale and three distinct input
buffers, drawn in its order from the same seed. On the card each chain is
timed with CUDA events over `iters` calls after 2 warm-up calls, and each
row gives ms per chain, TOP/s, the share of the H100's dense peak for its
type and the speedup over bf16. `--device cpu` runs it on the CPU for a
test at a tiny size; it then reports no share of a device peak.

    python -m dedark_yolo_tpu_torch.tools.int8_probe [--layers 24]
        [--iters 6] [--batch 32] [--hw 80] [--ch 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.predictor import resolve_device
from ..ops.int8_conv import conv3x3_s1_w8a8

# H100 SXM dense tensor-core peaks (NVIDIA data sheet), at a 700 W limit
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
OUT_SCALE = 0.05
WARMUP = 2


def requant_scale(ch):
    """The probe's requantisation scale of a 3x3 conv over `ch` int8
    channels: acc * scale has a std of about 127, so outputs cover the int8
    range, about a third saturate, and the chain's int8 histogram stays
    about stationary (scripts/int8_probe.py)."""
    return 127.0 / (np.sqrt(9 * ch) * 73.0 * 127.0 / np.sqrt(3))


def layer_inputs(B, H, W, C, Co, device, seed=0, channel_scales=False):
    """One layer's seeded draw: padded int8 input (B, H+2, W+2, C), int8
    weight (3, 3, C, Co) and the probe's (Co,) f32 scale, with
    `channel_scales` each channel's times its own factor in [0.5, 2)."""
    rng = np.random.default_rng([seed, B, H, W, C, Co])
    x = rng.integers(-128, 127, (B, H + 2, W + 2, C), dtype=np.int8)
    w = rng.integers(-128, 127, (3, 3, C, Co), dtype=np.int8)
    scale = np.full(Co, requant_scale(C), np.float32)
    if channel_scales:
        scale *= rng.uniform(0.5, 2.0, Co).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, scale))


def _chains(batch, hw, ch, layers, device):
    rng = np.random.default_rng(0)
    w8 = torch.from_numpy(rng.integers(-127, 127, (3, 3, ch, ch),
                                       dtype=np.int8)).to(device)
    scale = torch.full((ch,), requant_scale(ch), dtype=torch.float32,
                       device=device)
    wb = (w8.to(torch.bfloat16) / 127.0).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xi8 = [torch.from_numpy(rng.integers(-128, 127, (batch, hw, hw, ch),
                                         dtype=np.int8)).to(device)
           for _ in range(3)]
    # an NHWC tensor seen as NCHW is channels_last
    xbf = [(x.to(torch.bfloat16) / 127.0).permute(0, 3, 1, 2) for x in xi8]

    def chain_bf16(x):
        for _ in range(layers):
            x = F.silu(F.conv2d(x, wb, padding=1))
        return x

    def chain_int8(x):
        for _ in range(layers):
            x = conv3x3_s1_w8a8(F.pad(x, (0, 0, 1, 1, 1, 1)), w8, scale,
                                out_scale=OUT_SCALE, act="silu")
        return x

    return (("bf16", chain_bf16, xbf), ("int8", chain_int8, xi8))


def _ms_per_call(fn, inputs, iters, device):
    with torch.inference_mode():
        for i in range(WARMUP):
            fn(inputs[i % len(inputs)])
        if device.type != "cuda":
            t0 = time.perf_counter()
            for i in range(iters):
                fn(inputs[i % len(inputs)])
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters


def run(layers=24, iters=6, batch=32, hw=80, ch=256, device=None):
    """Time both chains; returns the rows and the number of int8 kernel
    calls made (`int8_calls`, warm-up included)."""
    device = resolve_device(device)
    ops = 2 * batch * hw * hw * 9 * ch * ch * layers
    rows = []
    for name, fn, inputs in _chains(batch, hw, ch, layers, device):
        ms = _ms_per_call(fn, inputs, iters, device)
        rate = ops / (ms / 1e3)
        rows.append({"chain": name, "ms": ms, "tops": rate / 1e12,
                     "peak_pct": (100 * rate / PEAK_OPS[name]
                                  if device.type == "cuda" else None)})
    for r in rows:
        r["speedup_vs_bf16"] = rows[0]["ms"] / r["ms"]
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "shape": [batch, hw, hw, ch], "layers": layers, "iters": iters,
            "rows": rows, "int8_calls": (WARMUP + iters) * layers}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hw", type=int, default=80)
    ap.add_argument("--ch", type=int, default=256)
    ap.add_argument("--device", default=None, help="default cuda")
    a = ap.parse_args(argv)
    res = run(a.layers, a.iters, a.batch, a.hw, a.ch, a.device)
    print(f"device {res['device']}, shape {res['shape']}, "
          f"{res['layers']} layers")
    for r in res["rows"]:
        unit = "TOP/s" if r["chain"] == "int8" else "TFLOP/s"
        peak = ("not measured" if r["peak_pct"] is None
                else f"{r['peak_pct']:.1f}% of peak")
        print(f"{r['chain']:5s} {r['ms']:9.3f} ms/chain  {r['tops']:8.2f} "
              f"{unit} ({peak})  speedup vs bf16 {r['speedup_vs_bf16']:.2f}x")
    return res


if __name__ == "__main__":
    main()
