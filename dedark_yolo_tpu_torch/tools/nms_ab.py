"""Time the nms kernel against other sources of it, on one card.

    python -m dedark_yolo_tpu_torch.tools.nms_ab [OTHER.cu ...]
        [--iters 20] [--rounds 2]

On the `predict`, `val` and `crowd` scenes of `tools/nms_scenes.py` (16
images of 2048 candidates, max_det 300). Variants: `csrc/nms.cu` and each
OTHER source of the kernel (an earlier revision, say), every one built with
the port's nvcc flags and called through its `nms_launch` with the
wrapper's ten arguments on the same inputs; a source from before the
scratch mask takes only the first nine and ignores the mask, as the C
calling convention allows. The variants run in turns -- each in order, then
in reverse -- `rounds` times, each time the device ms of a call among
`iters` run back to back (`_ab.queued_ms`: the host's launch time hidden).
Every variant is held to `_greedy` bit for bit (keep_idx and keep_scores).
For `csrc/nms.cu` its two passes are also timed apart
(`pass_ms`). Prints one JSON line: the card's name and power limit
(nvidia-smi), per scene each variant's ms (every turn and the median) and
check, the walk's depth, and each source's ptxas report; then exits
non-zero if a variant disagrees with `_greedy`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from ..ops import _build
from ..ops import nms as N
from . import _ab
from .nms_scenes import scene, walk_depth

SCENES = ("predict", "val", "crowd")
# nms_mask_launch(boxes, scores, mask, B, K, iou_thres, stream);
# nms_scan_launch(mask, scores, keep_idx, keep_scores, B, K, max_det, stream)
MASK_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_void_p])
SCAN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def outputs(boxes, max_det):
    """Empty keep_idx and keep_scores for `boxes`' batch."""
    b = boxes.shape[0]
    return (torch.empty((b, max_det), dtype=torch.long, device=boxes.device),
            torch.empty((b, max_det), dtype=torch.float32,
                        device=boxes.device))


def pass_ms(lib, boxes, scores, kw, iters=20):
    """Device ms of the library's two passes apart, raw launches (no
    wrapper, no launch count) run back to back (`_ab.queued_ms`):
    {"mask_ms", "scan_ms"}. The scan is timed on the mask of one mask pass,
    which it only reads."""
    fm, fs = lib.nms_mask_launch, lib.nms_scan_launch
    fm.argtypes, fm.restype = MASK_ARGTYPES, ctypes.c_int
    fs.argtypes, fs.restype = SCAN_ARGTYPES, ctypes.c_int
    b, k = scores.shape
    mask = torch.empty((b, k, N.mask_words(k)), dtype=torch.int64,
                       device=boxes.device)
    keep_i, keep_s = outputs(boxes, kw["max_det"])
    stream = torch.cuda.current_stream(boxes.device).cuda_stream

    def run(fn, *args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{N.NAME} pass returned {rc}")
    mask_call = lambda: run(fm, boxes.data_ptr(), scores.data_ptr(),
                            mask.data_ptr(), b, k, kw["iou_thres"], stream)
    scan_call = lambda: run(fs, mask.data_ptr(), scores.data_ptr(),
                            keep_i.data_ptr(), keep_s.data_ptr(), b, k,
                            kw["max_det"], stream)
    out = {"mask_ms": _ab.queued_ms(mask_call, iters)}
    out["scan_ms"] = _ab.queued_ms(scan_call, iters)
    return out


def run(others=(), iters=20, rounds=2):
    if not torch.cuda.is_available():
        raise SystemExit("nms_ab: no CUDA device")
    dev = torch.device("cuda")
    smi = _ab.nvidia_smi()
    logs = _build.build([N.NAME])
    variants = [("csrc/nms.cu", _build.load(N.NAME))]
    ptxas = {"csrc/nms.cu": _build.ptxas_lines(logs.get(N.NAME, ""))}
    for src in others:
        lib, log = _ab.build_other(Path(src), N.NAME)
        variants.append((src, lib))
        ptxas[src] = _build.ptxas_lines(log)
    for _, lib in variants:
        lib.nms_launch.argtypes = N.ARGTYPES
        lib.nms_launch.restype = ctypes.c_int

    stream = torch.cuda.current_stream(dev).cuda_stream
    scenes = {}
    for name in SCENES:
        boxes, scores, kw = scene(name, dev)
        b, k = scores.shape
        want_i, want_s = N._greedy(boxes, scores, **kw)
        mask = torch.empty((b, k, N.mask_words(k)), dtype=torch.int64,
                           device=dev)
        calls, checks = {}, {}
        for vname, lib in variants:
            keep_i, keep_s = outputs(boxes, kw["max_det"])
            args = (boxes.data_ptr(), scores.data_ptr(), keep_i.data_ptr(),
                    keep_s.data_ptr(), b, k, kw["max_det"], kw["iou_thres"],
                    stream, mask.data_ptr())

            def call(fn=lib.nms_launch, args=args, vname=vname):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"{vname}: launch returned {rc}")
            call()
            torch.cuda.synchronize()
            checks[vname] = bool(torch.equal(keep_i, want_i)
                                 and torch.equal(keep_s, want_s))
            calls[vname] = call
        turns = _ab.in_turns(calls, iters, rounds, _ab.queued_ms)
        depth = walk_depth(want_i, scores, kw["max_det"])
        kept = (want_i >= 0).sum(1)
        scenes[name] = {
            "b": b, "k": k, **kw,
            "kept": [int(kept.min()), int(kept.max())],
            "walk_depth": [int(depth.min()), int(depth.max())],
            "passes": pass_ms(variants[0][1], boxes, scores, kw, iters),
            "nvidia_smi": _ab.nvidia_smi(_ab.CLOCKS_QUERY),
            "rows": [{"variant": v, "ms": statistics.median(turns[v]),
                      "turns_ms": turns[v], "ok": checks[v]}
                     for v, _ in variants]}
    return {"tool": "nms_ab", "nvidia_smi": smi,
            "device": torch.cuda.get_device_name(0), "iters": iters,
            "rounds": rounds, "scenes": scenes, "ptxas": ptxas}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other nms sources")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    res = run(a.others, a.iters, a.rounds)
    print(json.dumps(res), flush=True)
    if not all(r["ok"] for s in res["scenes"].values() for r in s["rows"]):
        raise SystemExit("nms_ab: a variant disagrees with _greedy")
    return res


if __name__ == "__main__":
    main()
