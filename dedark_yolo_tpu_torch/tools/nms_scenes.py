"""Seeded candidate sets for the `nms` kernel: what `chip_smoke.py` holds the
kernel to `_greedy` on, on the card, and what the CPU tests hold `_greedy`
to the JAX package's greedy loop on.

Each scene is a seeded detector output (boxes and class scores, drawn as
tests/test_torch_nms.py draws them) put through the port's own top-k gate
(`ops.nms.nms_candidates`), so the kernel sees the class-offset boxes and
sorted scores that predict and val give it.
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
    # what DetectionValidator hands the kernel on every batch: multi-label
    # at conf 0.001 fills all 2048 candidates
    "val": (dict(b=16, n=8400, nc=3, seed=8, dense=True),
            dict(conf_thres=0.001, max_nms=2048, multi_label=True),
            dict(iou_thres=0.7, max_det=300)),
    # a trained detector's output: every object predicted by 8-10 jittered
    # anchors with near-equal scores, so the walk goes deep (past 1500
    # candidates before 300 are kept, or to the end of the 2048)
    "crowd": (dict(b=16, n=8400, nc=3, seed=9, crowd=True),
              dict(conf_thres=0.05, max_nms=2048, multi_label=False),
              dict(iou_thres=0.7, max_det=300)),
    # tests/test_torch_nms.py's dense scene: fills max_det
    "dense": (dict(b=2, n=3000, nc=3, seed=7, dense=True),
              dict(conf_thres=0.05, max_nms=2048, multi_label=True),
              dict(iou_thres=0.7, max_det=300)),
    # the dense scene kept to 1000: the scan gathers the words of more than
    # 512 kept rows (past its registers)
    "max_det_1000": (dict(b=2, n=3000, nc=3, seed=7, dense=True),
                     dict(conf_thres=0.05, max_nms=2048, multi_label=True),
                     dict(iou_thres=0.7, max_det=1000)),
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


def draw(b, n, nc, seed, ties=False, dense=False, empty=(), crowd=False):
    """(B, N, 4) xywh pixel boxes and (B, N, nc) scores in [0, 1)."""
    rng = np.random.default_rng(seed)
    if crowd:
        return _crowd(rng, b, n, nc)
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


def _crowd(rng, b, n, nc):
    """200-319 objects over a 640-px frame, each predicted by 8-10 anchors
    whose boxes jitter around it (centre by 4% of its size, sides by 5%)
    with scores within 2% of the object's, on its class; every other
    anchor scores below 0.05 on every class."""
    boxes = np.concatenate([rng.uniform(0, 640, (b, n, 2)),
                            rng.uniform(8, 120, (b, n, 2))], -1)
    scores = rng.uniform(0, 0.05, (b, n, nc))
    for img in range(b):
        per = rng.integers(8, 11, rng.integers(200, 320))   # anchors an object
        obj = np.repeat(np.arange(len(per)), per)
        anchors = rng.permutation(n)[:len(obj)]
        centre = rng.uniform(0, 640, (len(per), 2))[obj]
        size = rng.uniform(16, 96, (len(per), 2))[obj]
        jitter = rng.normal(0, 0.04, centre.shape)
        boxes[img, anchors, :2] = centre + jitter * size
        boxes[img, anchors, 2:] = size * np.exp(rng.normal(0, 0.05, size.shape))
        cls = rng.integers(0, nc, len(per))[obj]
        best = rng.uniform(0.3, 0.95, len(per))[obj]
        scores[img, anchors] *= 0.1
        scores[img, anchors, cls] = best * rng.uniform(0.98, 1.0, len(obj))
    return boxes.astype(np.float32), scores.astype(np.float32)


def walk_depth(keep_idx, scores, max_det):
    """Candidates each image's walk passed, in score order (B,): up to the
    last kept one where max_det were kept, else every positive score (the
    walk ran out). Assumes the candidate order of `nms_candidates`."""
    kept = (keep_idx >= 0).sum(1)
    return torch.where(kept == max_det, keep_idx[:, -1] + 1,
                       (scores > 0).sum(1))


def scene(name, device):
    """(class-offset boxes (B, K, 4), scores (B, K), greedy kwargs) of the
    named scene on `device`."""
    d, gate, greedy = SCENES[name]
    boxes, scores = draw(**d)
    *_, shifted, cand = nms_candidates(torch.from_numpy(boxes).to(device),
                                       torch.from_numpy(scores).to(device),
                                       **gate)
    return shifted, cand, greedy
