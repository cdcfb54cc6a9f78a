"""DetectionPredictor: batched inference (JAX engine/predictor.py:113-378).

The raw BGR frames of a batch are letterboxed to RGB in one call of the
native host library (`native.letterbox_batch`, C++ threads, the GIL
released; a partial batch repeats its first frame), as the JAX predictor
does when its library builds (JAX engine/predictor.py:282-297, 358-361).
Then one device step per batch: u8 -> float, the graph (layer 0 runs the
fused enhance kernel on CUDA), DFL decode, fixed-shape NMS with
multi_label=False (the `nms` kernel on CUDA). Boxes go back to
original-image pixels with the reference's letterbox inverse
(`scale_boxes`, whose Python rounding can sit one row off the native
letterbox's lround on frames such as 721x1280: the JAX package's
behaviour, kept). Batches are dispatched depth-2: on CUDA, `step` uploads
from a pinned buffer without waiting and returns device tensors while the
batch runs, so batch i+1 is letterboxed and submitted while batch i
computes; batch i's results are read back (the one wait of a batch) and
demuxed after that, in source order. The validator runs the same device
work (`PinnedUpload`, `detect_step`) with multi_label=True.

Not ported: TTA, ensembles, exported artifacts (AutoBackend),
save_enhanced/visualize, video and streams.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from ..cfg import get_cfg
from .. import native
from ..data.augment import PAD_VALUE
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from .results import Results


def resolve_device(device) -> torch.device:
    """None means cuda; cuda without a CUDA device raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def load_source(source):
    """Yield (path, BGR uint8 image) from an array, an image file, a `.npy`
    file of the BGR array (a host without OpenCV reads these), a directory
    of those (sorted by name), or a list of any of them."""
    if isinstance(source, np.ndarray):
        yield "array", source
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_source(s)
        return
    p = Path(source)
    if p.is_dir():
        from ..data.dataset import IMG_FORMATS
        files = sorted(f for f in p.iterdir()
                       if f.suffix.lower() in IMG_FORMATS | {".npy"})
        if not files:
            raise FileNotFoundError(f"no images in {p}")
        yield from load_source(files)
    elif p.suffix.lower() == ".npy" and p.is_file():
        yield str(p), np.load(p)
    elif p.is_file():
        import cv2
        img = cv2.imread(str(p))
        if img is None:
            raise FileNotFoundError(f"could not read image: {p}")
        yield str(p), img
    else:
        raise FileNotFoundError(f"source not found: {source}")


@contextlib.contextmanager
def matmul_precision(name):
    """'float32' turns TF32 off for cuDNN convs and CUDA matmuls;
    'default'/'tensorfloat32' turns it on. Restores both flags on exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    tf32 = name != "float32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class PinnedUpload:
    """Host numpy arrays -> the same on the device. On CUDA each array
    leaves from one of two pinned host buffers of its name, used in turns,
    and the host does not wait on the copy (only, before refilling a pair
    of buffers, on that pair's copies two uploads back)."""

    def __init__(self, device):
        self.device = device
        self._pinned = [{}, {}]
        self._copied = [None, None]
        self._turn = 0

    def __call__(self, arrays: dict) -> dict:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(a).to(self.device)
                    for k, a in arrays.items()}
        k = self._turn
        self._turn ^= 1
        if self._copied[k] is not None:
            self._copied[k].synchronize()
        out = {}
        for name, a in arrays.items():
            buf = self._pinned[k].get(name)
            dtype = torch.from_numpy(a).dtype
            if buf is None or tuple(buf.shape) != a.shape or buf.dtype != dtype:
                buf = self._pinned[k][name] = torch.empty(
                    a.shape, dtype=dtype, pin_memory=True)
            buf.numpy()[...] = a
            out[name] = buf.to(self.device, non_blocking=True)
        self._copied[k] = torch.cuda.Event()
        self._copied[k].record()
        return out


def detect_step(model, img, a, multi_label, extra=None):
    """The device work of one predict or val batch: img (B, H, W, 3) float
    on the device -> (raw head maps, dets (B, max_det, 6), counts (B,)),
    none waited for. `extra` = (boxes_xywh (B, M, 4), scores (B, M, nc))
    candidates joined to the decoded ones before NMS (val's save_hybrid)."""
    with matmul_precision(a.matmul_precision):
        raw = model(img)
        boxes, scores = model.decode(raw)
        boxes, scores = boxes.float(), scores.float()
        if extra is not None:
            boxes = torch.cat([boxes, extra[0]], 1)
            scores = torch.cat([scores, extra[1]], 1)
        dets, counts = non_max_suppression(
            boxes, scores, conf_thres=float(a.conf), iou_thres=float(a.iou),
            max_det=a.max_det, max_nms=a.max_nms, multi_label=multi_label,
            agnostic=a.agnostic_nms)
    return raw, dets, counts


class DetectionPredictor:
    def __init__(self, args=None, model=None, names=None):
        self.args = args if args is not None else get_cfg()
        if self.args.conf is None:
            self.args.conf = 0.25  # predict default (reference model.py:213)
        self.device = resolve_device(self.args.device)
        self.model = model
        self.names = names or (model.names if model is not None else {})
        # mean ms per image of each stage over every image seen
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self._totals = dict(self.speed)
        self.seen = 0
        self.upload = PinnedUpload(self.device)

    @torch.inference_mode()
    def step(self, img_u8):
        """(B, S, S, 3) uint8 RGB on the host -> dets (B, max_det, 6), counts
        on the device; on CUDA it returns without waiting for them."""
        dtype = torch.bfloat16 if self.args.half else torch.float32
        img = self.upload({"img": img_u8})["img"].to(dtype) / 255.0
        return detect_step(self.model, img, self.args, multi_label=False)[1:]

    def __call__(self, source):
        return list(self.stream_inference(source))

    def stream_inference(self, source):
        a = self.args
        imgsz = int(a.imgsz)
        batch_size = max(1, int(a.batch))
        self.model.to(self.device).eval()
        buf_paths, buf_orig = [], []

        def dispatch():
            nonlocal buf_paths, buf_orig
            if not buf_orig:
                return None
            n = len(buf_orig)
            t0 = time.perf_counter()
            srcs = buf_orig + [buf_orig[0]] * (batch_size - n)
            arr = native.letterbox_batch(srcs, imgsz, fill=PAD_VALUE,
                                         swap_rb=True)
            t1 = time.perf_counter()
            out = self.step(arr)
            t_disp = time.perf_counter() - t1
            rec = (out, n, t1 - t0, t_disp, buf_paths, buf_orig)
            buf_paths, buf_orig = [], []
            return rec

        def demux(rec):
            (dets, counts), n, t_pre, t_disp, paths, origs = rec
            t1 = time.perf_counter()
            dets = dets.cpu().numpy()
            counts = counts.cpu().numpy()
            t2 = time.perf_counter()
            speed = {"preprocess": t_pre / n * 1000,
                     "inference": (t_disp + t2 - t1) / n * 1000}
            results = []
            for i in range(n):
                k = int(counts[i])
                det = dets[i, :k].copy()
                orig = origs[i]
                if k:
                    det[:, :4] = scale_boxes((imgsz, imgsz),
                                             torch.from_numpy(det[:, :4]),
                                             orig.shape[:2]).numpy()
                results.append(Results(
                    orig_img=np.ascontiguousarray(orig[..., ::-1]),
                    path=paths[i], names=self.names, boxes=det, speed=speed))
            speed["postprocess"] = (time.perf_counter() - t2) / n * 1000
            self.seen += n
            for key, v in speed.items():
                self._totals[key] += v * n
                self.speed[key] = self._totals[key] / self.seen
            yield from results

        pending = None
        for path, img in load_source(source):
            buf_paths.append(path)
            buf_orig.append(img)
            if len(buf_orig) == batch_size:
                newly = dispatch()
                if pending is not None:
                    yield from demux(pending)
                pending = newly
        newly = dispatch()
        if pending is not None:
            yield from demux(pending)
        if newly is not None:
            yield from demux(newly)
