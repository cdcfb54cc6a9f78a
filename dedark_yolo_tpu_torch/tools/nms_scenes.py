"""Seeded candidate sets for the `nms` kernel: what `chip_smoke.py` holds the
kernel to `_greedy` on, on the card, and what the CPU tests hold `_greedy`
to the JAX package's greedy loop on.

Each scene is a seeded detector output (boxes and class scores, drawn as
tests/test_torch_nms.py draws them) put through the port's own top-k gate
(`ops.nms.nms_candidates`), so the kernel sees the class-offset boxes and
sorted scores that predict gives it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.nms import nms_candidates

# name: (draw, gate, greedy) keyword arguments
SCENES = {
    # predict's shape: 16 images, 8400 anchors of 3 classes, best class per
    # anchor, 2048 candidates, max_det 300
    "predict": (dict(b=16, n=8400, nc=3, seed=0, dense=True),
                dict(conf_thres=0.05, max_nms=2048, multi_label=False),
                dict(iou_thres=0.7, max_det=300)),
    # tests/test_torch_nms.py's dense scene: fills max_det
    "dense": (dict(b=2, n=3000, nc=3, seed=7, dense=True),
              dict(conf_thres=0.05, max_nms=2048, multi_label=True),
              dict(iou_thres=0.7, max_det=300)),
    # quantised scores (exact ties, also across classes), duplicated boxes
    "ties": (dict(b=3, n=400, nc=4, seed=4, ties=True),
             dict(conf_thres=0.3, max_nms=512, multi_label=True),
             dict(iou_thres=0.5, max_det=100)),
    # the second image has no candidate: it stops at once
    "empty_image": (dict(b=2, n=400, nc=4, seed=3, empty=(1,)),
                    dict(conf_thres=0.25, max_nms=256, multi_label=True),
                    dict(iou_thres=0.6, max_det=50)),
    # one candidate an image
    "k1": (dict(b=3, n=1, nc=1, seed=5),
           dict(conf_thres=0.25, max_nms=2048, multi_label=False),
           dict(iou_thres=0.7, max_det=5)),
    # K = 1998, not a multiple of 32 (nor of the block's 256)
    "k_ragged": (dict(b=3, n=999, nc=2, seed=6),
                 dict(conf_thres=0.2, max_nms=2048, multi_label=True),
                 dict(iou_thres=0.45, max_det=300)),
}


def draw(b, n, nc, seed, ties=False, dense=False, empty=()):
    """(B, N, 4) xywh pixel boxes and (B, N, nc) scores in [0, 1)."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 320, (b, n, 2))
    wh = rng.uniform(8, 40 if dense else 120, (b, n, 2))
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, nc)).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8
        boxes[:, n // 2:] = boxes[:, :n // 2]
    for i in empty:
        scores[i] = 0.0
    return boxes, scores.astype(np.float32)


def scene(name, device):
    """(class-offset boxes (B, K, 4), scores (B, K), greedy kwargs) of the
    named scene on `device`."""
    d, gate, greedy = SCENES[name]
    boxes, scores = draw(**d)
    *_, shifted, cand = nms_candidates(torch.from_numpy(boxes).to(device),
                                       torch.from_numpy(scores).to(device),
                                       **gate)
    return shifted, cand, greedy
