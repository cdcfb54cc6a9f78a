"""What the A/B timing tools (`int8_ab`, `enhance_ab`) share: build another
source of a kernel with the port's nvcc flags, time a call with CUDA events,
run variants in turns, and read the card's state from nvidia-smi (which
`chip_smoke.py` reads through here too).
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build

# nvidia-smi's fields read beside each kernel timing
CLOCKS_QUERY = "clocks.sm,power.draw,power.limit"


def build_other(src: Path, tag: str):
    """Compile another source of a kernel; returns (library, ptxas log).
    nvcc resolves quoted includes from the source's own directory first, so
    the headers beside it are hashed in with it."""
    h = hashlib.sha256(src.read_bytes()
                       + " ".join(_build.NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _build.BUILD_DIR / f"lib{tag}_ab-{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def time_ms(call, iters=20, warmup=3):
    """CUDA-event median of `iters` calls, after `warmup` calls, in ms."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def in_turns(calls, iters, rounds):
    """{name: [ms of each turn]}: every call in order, then in reverse,
    `rounds` times."""
    names = list(calls)
    turns = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            turns[name].append(time_ms(calls[name], iters))
    return turns


def nvidia_smi(query="name,power.limit"):
    """nvidia-smi's csv line for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
