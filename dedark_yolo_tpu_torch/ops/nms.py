"""Batched fixed-shape NMS (JAX ops/nms.py:28-135).

The contract of the JAX function: a top-k gate over the (anchor, class)
pairs (multi-label) or the per-anchor best class, capped at `max_nms`; the
`max_wh` class offset; greedy suppression that stops once no candidate is
left; (B, max_det, 6) [x1, y1, x2, y2, conf, cls] plus (B,) counts, and the
kept anchor indices with `return_idx`.

The greedy loop is `greedy_nms`: on CUDA tensors the `nms` kernel of
`csrc/nms.cu` (an IoU bitmask over all SMs, then one warp an image walks
it in score order; one call is two launches, counted once in
`LAUNCHES["nms"]`), on CPU tensors its plain version `_greedy`, which asks
the host once per step whether any image still has a candidate. Nothing on
the CUDA path waits on the device, so predict's step returns while the
batch still runs.

Ties: `jax.lax.top_k` puts the lower index first, and `torch.topk` promises
no order, so the gate is a stable descending sort, sliced. `torch.argmax`
returns the first maximum, as `jnp.argmax` does, and so does the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .boxes import xywh2xyxy

NAME = "nms"
_build.LAUNCHES.setdefault(NAME, 0)
# csrc/nms.cu: a mask word covers CHUNK candidates; an image has at most
# MAX_K (the scan keeps its kept list in shared memory)
CHUNK = 64
MAX_K = 2048


def _greedy(boxes, scores, iou_thres: float, max_det: int):
    """Plain version of `greedy_nms`, the whole batch in lockstep.
    boxes (B, K, 4) xyxy, class-offset; scores (B, K), 0 = no candidate.
    Returns keep_idx (B, max_det) int64 (-1 invalid) and keep_scores."""
    b = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    live = scores.clone()
    keep_idx = torch.full((b, max_det), -1, dtype=torch.long,
                          device=boxes.device)
    keep_scores = torch.zeros((b, max_det), dtype=scores.dtype,
                              device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    for i in range(max_det):
        # an image whose candidates are all 0 is done; updating it further
        # changes nothing, so the batch moves in lockstep without masks
        best = live.argmax(dim=1)
        best_score = live[rows, best]
        active = best_score > 0.0
        if not bool(active.any()):   # the one host sync of the iteration
            break
        bb = boxes[rows, best]                                   # (B, 4)
        iw = (torch.minimum(x2, bb[:, 2:3])
              - torch.maximum(x1, bb[:, 0:1])).clamp(min=0)
        ih = (torch.minimum(y2, bb[:, 3:4])
              - torch.maximum(y1, bb[:, 1:2])).clamp(min=0)
        inter = iw * ih
        barea = ((bb[:, 2] - bb[:, 0]).clamp(min=0)
                 * (bb[:, 3] - bb[:, 1]).clamp(min=0))[:, None]
        iou = inter / (areas + barea - inter + 1e-7)
        live = torch.where(iou > iou_thres, torch.zeros_like(live), live)
        live[rows, best] = 0.0
        keep_idx[:, i] = torch.where(active, best, -1)
        keep_scores[:, i] = torch.where(active, best_score,
                                        torch.zeros_like(best_score))
    return keep_idx, keep_scores


def mask_words(k: int) -> int:
    """u64 words of one mask row: ceil(K / CHUNK)."""
    return -(-k // CHUNK)


def mask_bytes(b: int, k: int) -> int:
    """Bytes of the (B, K, mask_words(K)) u64 scratch mask."""
    return 8 * b * k * mask_words(k)


# nms_launch(boxes, scores, keep_idx, keep_scores, B, K, max_det, iou_thres,
#            stream, mask)
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


@lru_cache(maxsize=1)
def _launch_fn():
    fn = _build.load(NAME).nms_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def greedy_nms(boxes, scores, iou_thres: float, max_det: int):
    """Greedy suppression of every image of a batch.

    boxes (B, K, 4) f32 xyxy, class-offset; scores (B, K) f32, 0 = no
    candidate, non-increasing along K in every image with the zeros after
    every positive score (what `nms_candidates` gives; the kernel walks the
    candidates in that order and nothing checks it, which would need a host
    sync). Returns keep_idx (B, max_det) int64 (-1 invalid) and keep_scores
    (B, max_det) f32. CUDA tensors run the `nms` kernel (K at most MAX_K),
    CPU tensors `_greedy`.
    """
    if boxes.device.type == "cpu":
        return _greedy(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu, not {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"{NAME} needs boxes (B, K, 4) and scores (B, K), "
                         f"got {tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"{NAME} needs f32 boxes and scores, got "
                         f"{boxes.dtype} and {scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"{NAME} inputs must share one device")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError(f"{NAME} needs contiguous boxes and scores")
    if boxes.data_ptr() % 16:
        raise ValueError(f"{NAME} reads boxes 16 bytes at a time: they must "
                         "start on a 16-byte boundary")
    b, k, _ = boxes.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{NAME} takes 1 to {MAX_K} candidates an image, "
                         f"got {k}")
    if max_det < 1:
        raise ValueError(f"{NAME} needs max_det >= 1, got {max_det}")
    keep_idx = torch.empty((b, max_det), dtype=torch.long, device=boxes.device)
    keep_scores = torch.empty((b, max_det), dtype=torch.float32,
                              device=boxes.device)
    if b == 0:
        return keep_idx, keep_scores
    mask = torch.empty((b, k, mask_words(k)), dtype=torch.int64,
                       device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        rc = _launch_fn()(boxes.data_ptr(), scores.data_ptr(),
                          keep_idx.data_ptr(), keep_scores.data_ptr(), b, k,
                          max_det, float(iou_thres), stream, mask.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    _build.LAUNCHES[NAME] += 1
    return keep_idx, keep_scores


def _top_k(x, k: int):
    """Largest k along dim 1, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def nms_candidates(boxes_xywh, class_scores, conf_thres=0.25, max_nms=2048,
                   multi_label=True, agnostic=False, max_wh=7680.0):
    """The top-k gate: (xyxy (B, K, 4), class (B, K) f32, anchor index
    (B, K), class-offset xyxy (B, K, 4) contiguous, score (B, K) contiguous,
    0 below conf_thres), K = min(max_nms, candidates)."""
    b, n, nc = class_scores.shape
    zero = class_scores.new_zeros(())
    if multi_label and nc > 1:
        flat = class_scores.reshape(b, n * nc)
        flat = torch.where(flat > conf_thres, flat, zero)
        cand_scores, flat_idx = _top_k(flat, min(max_nms, n * nc))
        anchor_idx = flat_idx // nc
        cls_idx = (flat_idx % nc).to(torch.float32)
    else:
        conf = class_scores.amax(dim=-1)
        cls_full = class_scores.argmax(dim=-1).to(torch.float32)
        conf = torch.where(conf > conf_thres, conf, zero)
        cand_scores, anchor_idx = _top_k(conf, min(max_nms, n))
        cls_idx = torch.gather(cls_full, 1, anchor_idx)

    xyxy = xywh2xyxy(torch.gather(boxes_xywh, 1,
                                  anchor_idx[..., None].expand(-1, -1, 4)))
    offset = 0.0 if agnostic else max_wh
    shifted = xyxy + (cls_idx * offset)[..., None]
    return xyxy, cls_idx, anchor_idx, shifted.contiguous(), \
        cand_scores.contiguous()


def non_max_suppression(boxes_xywh, class_scores, conf_thres=0.25,
                        iou_thres=0.45, max_det=300, max_nms=2048,
                        multi_label=True, agnostic=False, max_wh=7680.0,
                        return_idx=False):
    """Batched fixed-shape NMS.

    boxes_xywh (B, N, 4) pixels (cx, cy, w, h); class_scores (B, N, nc)
    sigmoid probabilities.
    Returns dets (B, max_det, 6) with conf 0 and cls -1 in invalid rows,
    counts (B,), and with return_idx the kept anchor indices (B, max_det),
    -1 where invalid.
    """
    xyxy, cls_idx, anchor_idx, shifted, cand_scores = nms_candidates(
        boxes_xywh, class_scores, conf_thres, max_nms, multi_label, agnostic,
        max_wh)
    keep_idx, keep_scores = greedy_nms(shifted, cand_scores, iou_thres,
                                       max_det)

    valid = keep_idx >= 0
    gather = keep_idx.clamp(min=0)
    out_boxes = torch.gather(xyxy, 1, gather[..., None].expand(-1, -1, 4))
    out_cls = torch.gather(cls_idx, 1, gather)
    out_cls = torch.where(valid, out_cls, torch.full_like(out_cls, -1.0))
    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    dets = torch.cat([out_boxes, keep_scores[..., None], out_cls[..., None]],
                     -1)
    counts = valid.sum(-1)
    if return_idx:
        out_anchor = torch.gather(anchor_idx, 1, gather)
        out_anchor = torch.where(valid, out_anchor,
                                 torch.full_like(out_anchor, -1))
        return dets, counts, out_anchor.to(torch.int32)
    return dets, counts
