"""DetectionPredictor: batched inference (JAX engine/predictor.py:113-417).

The raw BGR frames of a batch are letterboxed to RGB in one call of the
native host library (`native.letterbox_batch`, C++ threads, the GIL
released; a partial batch repeats its first frame), as the JAX predictor
does when its library builds (JAX engine/predictor.py:282-297, 358-361).
Then one device step per batch: u8 -> float, the graph (layer 0 runs the
fused enhance kernel on CUDA) for each ensemble member, with `augment`
three times a member (`DetectionModel.tta_eval`), DFL decode, and one
fixed-shape NMS with multi_label=False over every member's candidates (the
`nms` kernel on CUDA). The same forward keeps layer 0's output
(`save_enhanced`) and every layer's first-image activations (`visualize`,
sliced on the device). Boxes go back to original-image pixels with the
reference's letterbox inverse (`scale_boxes`, whose Python rounding can sit
one row off the native letterbox's lround on frames such as 721x1280: the
JAX package's behaviour, kept). Batches are dispatched depth-2: on CUDA,
`step` uploads from a pinned buffer without waiting and returns device
tensors while the batch runs, so batch i+1 is letterboxed and submitted
while batch i computes; batch i's results are read back (the one wait of a
batch) and demuxed after that, in source order. The validator runs the same
device work (`PinnedUpload`, `detect_step`) with multi_label=True.

Files: `save` writes the annotated image (a video's frames as an mp4), and
with save_enhanced the enhanced image, with visualize the feature grids;
save_txt and save_crop write on their own, as in JAX. The enhanced image
and the activations are also returned in memory (`Results.enhanced_img`,
`Results.features`), so they need no OpenCV or matplotlib unless saved;
the JAX predictor writes their files whenever the flags are on.

An exported artifact (`engine/autobackend.py`, model=AutoBackend) runs
layer 0, the graph and the decode itself at its fixed batch; only NMS runs
here (`backend_step`, JAX predictor.py:141-160): the short last batch is
padded to the artifact's batch and its padding's outputs dropped before
NMS; augment, save_enhanced and visualize are ignored with a warning. A
task's predictor (`engine/segment.py`, `engine/pose.py`) replaces `step`
and fills its Results through the `readback` and `extra_fields` hooks
(JAX predictor.py:259-261), which the server's responses use too.
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
from ..nn.graph import require_detect
from ..ops.boxes import scale_boxes, xywh2xyxy
from ..ops.nms import non_max_suppression, top_k
from ..utils import LOGGER, increment_dir
from ..utils.checks import check_imshow
from ..utils.patches import imread, require
from .results import Results


def resolve_device(device) -> torch.device:
    """None means cuda; cuda without a CUDA device raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


VID_FORMATS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".mpg",
               ".mpeg"}


def load_source(source, vid_stride=1):
    """Yield (path, BGR uint8 image, meta) from any predict source (JAX
    engine/predictor.py:37-110): an array; a PIL image; a (3, H, W) or
    (B, 3, H, W) RGB tensor; an image file; a `.npy` file of the BGR array
    (a host without OpenCV reads these); a video file (every vid_stride-th
    frame); a webcam index, stream URL or `.streams` file; "screen"; a
    directory of any of those files, walked recursively in sorted order; or
    a list of any of them. meta is None for a still image, (frame index,
    fps, frame count) for a video or stream frame (count 0 when unbounded).
    Image files, videos and streams need OpenCV, PIL images Pillow."""
    from ..data.loaders import (LoadScreenshots, LoadStreams,
                                is_stream_source, pil_to_bgr,
                                tensor_to_bgr_list)
    if isinstance(source, np.ndarray):
        yield "array", source, None
        return
    if type(source).__module__.startswith("PIL") and hasattr(source, "mode"):
        yield "pil", pil_to_bgr(source), None
        return
    if (hasattr(source, "__array__") and getattr(source, "ndim", 0) in (3, 4)
            and not isinstance(source, np.ndarray)):
        for i, img in enumerate(tensor_to_bgr_list(source)):
            yield f"tensor{i}", img, None
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_source(s, vid_stride)
        return
    if is_stream_source(source):
        streams = LoadStreams(source, vid_stride=vid_stride)
        try:
            for paths, frames, metas in streams:
                yield from zip(paths, frames, metas)
        finally:
            streams.close()
        return
    if isinstance(source, str) and source.strip().lower().startswith("screen"):
        for paths, frames, metas in LoadScreenshots(source):
            yield from zip(paths, frames, metas)
        return
    p = Path(source)
    if p.is_dir():
        from ..data.dataset import IMG_FORMATS
        files = [f for f in sorted(p.rglob("*")) if f.suffix.lower()
                 in IMG_FORMATS | VID_FORMATS | {".npy"}]
        if not files:
            raise FileNotFoundError(f"no images or videos in {p}")
        for f in files:
            yield from load_source(f, vid_stride)
    elif p.suffix.lower() == ".npy" and p.is_file():
        yield str(p), np.load(p), None
    elif p.is_file() and p.suffix.lower() in VID_FORMATS:
        cv2 = require("cv2", f"reading the video {p}")
        cap = cv2.VideoCapture(str(p))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % vid_stride == 0:
                yield str(p), frame, (idx, fps, total)
            idx += 1
        cap.release()
    elif p.is_file():
        img = imread(p)
        if img is None:
            raise FileNotFoundError(f"could not read image: {p}")
        yield str(p), img, None
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


def joined_nms(boxes, scores, a, multi_label):
    """One fixed-shape NMS at the config's thresholds over the candidates
    of every (B, N_i, 4) xywh / (B, N_i, nc) pair, joined along N."""
    return non_max_suppression(
        torch.cat(boxes, 1) if len(boxes) > 1 else boxes[0],
        torch.cat(scores, 1) if len(scores) > 1 else scores[0],
        conf_thres=float(a.conf), iou_thres=float(a.iou), max_det=a.max_det,
        max_nms=a.max_nms, multi_label=multi_label, agnostic=a.agnostic_nms)


def backend_step(backend, img_u8, a, multi_label, extra=None):
    """The device work of one batch of an exported artifact: img_u8 (n, S,
    S, 3) uint8 on the device, n <= the artifact's batch (zero images pad
    it) -> (dets, counts) of the n images, not waited for. The artifact
    runs the enhance chain, the forward and the decode; `extra` joins
    candidates before NMS, as in `detect_step`."""
    n = img_u8.shape[0]
    if n < backend.batch:
        img_u8 = torch.cat([img_u8, img_u8.new_zeros(
            (backend.batch - n, *img_u8.shape[1:]))])
    with matmul_precision(a.matmul_precision):
        boxes, scores = backend(img_u8)
        boxes, scores = [boxes[:n]], [scores[:n]]
        if extra is not None:
            boxes.append(extra[0])
            scores.append(extra[1])
        return joined_nms(boxes, scores, a, multi_label)


def task_outputs(model, img_u8):
    """The task's eval_outputs tuple of a device uint8 batch: an
    AutoBackend's outputs (the batch padded to its fixed size with zero
    images, the padding dropped), or the live model's eval_outputs of the
    image / 255 in f32."""
    from .autobackend import AutoBackend
    if isinstance(model, AutoBackend):
        n = img_u8.shape[0]
        if n < model.batch:
            img_u8 = torch.cat([img_u8, img_u8.new_zeros(
                (model.batch - n, *img_u8.shape[1:]))])
        return tuple(o[:n] for o in model(img_u8))
    return model.eval_outputs(img_u8.to(torch.float32) / 255.0)


def require_task(model, task, what):
    """Raise unless `model` is a DetectionModel or an AutoBackend of
    `task`."""
    from ..nn.graph import DetectionModel
    from .autobackend import AutoBackend
    if not isinstance(model, (AutoBackend, DetectionModel)):
        raise TypeError(f"{what} takes a DetectionModel or an AutoBackend, "
                        f"not {type(model).__name__}")
    if getattr(model, "task", "detect") != task:
        raise ValueError(f"{what} needs a {task} model; this one is a "
                         f"{model.task} model")


def query_dets(boxes, scores, a):
    """RT-DETR's NMS-free detections of its decoded queries, boxes_xywh
    (B, nq, 4) in pixels and scores (B, nq, nc) (JAX validator.py:103-124,
    reference RTDETRValidator): each query's best class and score, the
    max_det best queries (ties to the lower index, as jax.lax.top_k), no
    IoU suppression -> (dets (B, max_det, 6) xyxy, conf, cls; counts (B,)
    of those above conf)."""
    xyxy = xywh2xyxy(boxes)
    qconf, qcls = scores.max(-1)
    k = min(int(a.max_det), qconf.shape[-1])
    conf, top = top_k(qconf, k)
    dets = torch.cat([xyxy.gather(1, top[..., None].expand(-1, -1, 4)),
                      conf[..., None],
                      qcls.gather(1, top)[..., None].to(xyxy.dtype)], -1)
    dets = torch.nn.functional.pad(dets, (0, 0, 0, int(a.max_det) - k))
    return dets, (conf > float(a.conf)).sum(-1).to(torch.int32)


def detect_step(model, img, a, multi_label, extra=None):
    """The device work of one val batch: img (B, H, W, 3) float on the
    device -> (raw head maps, dets (B, max_det, 6), counts (B,)), none
    waited for. `extra` = (boxes_xywh (B, M, 4), scores (B, M, nc))
    candidates joined to the decoded ones before NMS (val's save_hybrid).
    RT-DETR's queries take `query_dets` (no NMS; `extra` unused, as in
    JAX)."""
    with matmul_precision(a.matmul_precision):
        raw = model(img)
        boxes, scores = model.decode(raw, img.shape[1:3])
        if model.is_rtdetr:
            return (raw, *query_dets(boxes, scores, a))
        boxes, scores = [boxes.float()], [scores.float()]
        if extra is not None:
            boxes.append(extra[0])
            scores.append(extra[1])
        dets, counts = joined_nms(boxes, scores, a, multi_label)
    return raw, dets, counts


class DetectionPredictor:
    """Batched predict on `model` (JAX engine/predictor.py:113-417).

    `task` is the model task a predictor takes; a subclass for another task
    replaces `step`, `readback` and `extra_fields`.

    members: the state dicts of an ensemble's other members, the same
    architecture as `model`, whose own weights are the first member. Each
    member forwards the batch (through `torch.func.functional_call` on the
    one module, its tensors moved to the device once) and their candidates
    join before one NMS (reference Ensemble, tasks.py:534-546). `model`
    may be an AutoBackend instead (`backend_step`).
    """

    task = "detect"

    def __init__(self, args=None, model=None, names=None, save_dir=None,
                 members=None):
        self.args = args if args is not None else get_cfg()
        if self.args.conf is None:
            self.args.conf = 0.25  # predict default (reference model.py:213)
        self.device = resolve_device(self.args.device)
        if model is not None and self.task == "detect":
            require_detect(model, "DetectionPredictor")
        self.model = model
        self.names = names or (model.names if model is not None else {})
        self.members = list(members or [])
        self._member_states = None
        self.save_dir = (Path(save_dir) if save_dir else increment_dir(
            Path("runs/detect/predict"), self.args.exist_ok))
        # mean ms per image of each stage over every image seen
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self._totals = dict(self.speed)
        self.seen = 0
        self.upload = PinnedUpload(self.device)
        a = self.args
        from .autobackend import AutoBackend
        self.backend = isinstance(model, AutoBackend)
        if self.backend:
            for key in ("augment", "save_enhanced", "visualize"):
                if getattr(a, key):
                    LOGGER.warning(f"{key}=True is ignored for exported "
                                   "artifacts (single-scale inference, "
                                   "outputs only)")
                    setattr(a, key, False)
        if a.augment and model is not None and model.is_rtdetr:
            LOGGER.warning(f"{model.task} has not supported augment inference"
                           " yet — using single-scale inference instead")
            a.augment = False
        self.tta = bool(a.augment)
        if self.tta and (a.save_enhanced or a.visualize):
            LOGGER.warning("augment=True skips save_enhanced/visualize "
                           "captures (reference _predict_augment behavior)")
        # visualize: every layer's output, the first image's, 32 channels
        self.capture = (tuple(sp.i for sp in model.specs)
                        if a.visualize and not self.tta and model is not None
                        else ())
        self.keep_enhanced = (bool(a.save_enhanced) and not self.tta
                              and model is not None and
                              model.specs[0].name == "lowlight_recovery")

    def _forwards(self):
        """One image -> raw maps callable a member; the first is the
        module itself."""
        if self._member_states is None:
            self._member_states = [
                {k: v.to(self.device) for k, v in sd.items()}
                for sd in self.members]
        calls = [self.model]
        for sd in self._member_states:
            calls.append(lambda x, sd=sd, **kw: torch.func.functional_call(
                self.model, sd, (x,), kw))
        return calls

    @torch.inference_mode()
    def step(self, img_u8):
        """(B, S, S, 3) uint8 RGB on the host -> {"dets" (B, max_det, 6),
        "counts" (B,)}, with save_enhanced "enhanced" (B, S, S, 3) f32 in
        [0, 1] (layer 0's output of this forward) and with visualize
        "features" {layer: (1, h, w, <= 32) f32}, on the device; on CUDA it
        returns without waiting for them. With augment each member runs
        `tta_eval`; every member's candidates join before one NMS."""
        a = self.args
        img = self.upload({"img": img_u8})["img"]
        if self.backend:
            dets, counts = backend_step(self.model, img, a, multi_label=False)
            return {"dets": dets, "counts": counts}
        img = img.to(torch.bfloat16 if a.half else torch.float32) / 255.0
        out, boxes, scores = {}, [], []
        with matmul_precision(a.matmul_precision):
            for i, forward in enumerate(self._forwards()):
                if self.tta:
                    b, s = self.model.tta_eval(img, forward)
                else:
                    first = i == 0
                    kept, hook = [], None
                    if first and self.keep_enhanced:
                        hook = self.model.model[0].register_forward_hook(
                            lambda mod, inp, y: kept.append(y))
                    try:
                        raw = forward(img, capture=self.capture if first
                                      else ())
                    finally:
                        if hook is not None:
                            hook.remove()
                    if first and self.capture:
                        raw, caps = raw
                        out["features"] = {k: v.float()
                                           for k, v in caps.items()}
                    if kept:
                        out["enhanced"] = kept[0].float().clamp(0, 1)
                    b, s = self.model.decode(raw, img.shape[1:3])
                boxes.append(b.float())
                scores.append(s.float())
            out["dets"], out["counts"] = joined_nms(boxes, scores, a,
                                                    multi_label=False)
        return out

    def readback(self, out, n):
        """The device outputs of a batch of n images on the host (the one
        wait of a batch): every tensor, save_enhanced's cut to the n
        images, visualize's features as a dict."""
        host = {k: v.cpu().numpy() for k, v in out.items()
                if torch.is_tensor(v)}
        if "enhanced" in host:
            host["enhanced"] = host["enhanced"][:n]
        if "features" in out:
            host["features"] = {k: v.cpu().numpy()
                                for k, v in out["features"].items()}
        return host

    def extra_fields(self, out, i, k, orig_shape, imgsz):
        """A task's further Results fields of image i with k detections
        (JAX predictor.py:259-261): none for detect."""
        return {}

    def __call__(self, source, stream=False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source):
        a = self.args
        if a.show:
            a.show = check_imshow(warn=True)
        imgsz = int(a.imgsz)
        batch_size = max(1, int(a.batch))
        if not self.backend:
            self.model.to(self.device).eval()
        buf_paths, buf_orig, buf_meta = [], [], []
        self._writers = {}

        def dispatch():
            nonlocal buf_paths, buf_orig, buf_meta
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
            rec = (out, n, t1 - t0, t_disp, buf_paths, buf_orig, buf_meta)
            buf_paths, buf_orig, buf_meta = [], [], []
            return rec

        def demux(rec):
            out, n, t_pre, t_disp, paths, origs, metas = rec
            t1 = time.perf_counter()
            host = self.readback(out, n)
            dets, counts = host["dets"], host["counts"]
            enhanced = host.get("enhanced")
            features = host.get("features")
            t2 = time.perf_counter()
            speed = {"preprocess": t_pre / n * 1000,
                     "inference": (t_disp + t2 - t1) / n * 1000}
            if features is not None and a.save:
                from ..utils.plotting import feature_visualization
                feature_visualization(features, self.save_dir / "features"
                                      / Path(paths[0]).stem)
            results = []
            for i in range(n):
                k = int(counts[i])
                det = dets[i, :k].copy()
                orig = origs[i]
                if k:
                    det[:, :4] = scale_boxes((imgsz, imgsz),
                                             torch.from_numpy(det[:, :4]),
                                             orig.shape[:2]).numpy()
                res = Results(
                    orig_img=np.ascontiguousarray(orig[..., ::-1]),
                    path=paths[i], names=self.names, boxes=det, speed=speed,
                    enhanced_img=enhanced[i] if enhanced is not None else None,
                    features=features if i == 0 else None,
                    **self.extra_fields(host, i, k, orig.shape[:2], imgsz))
                res.source_meta = metas[i]
                if a.save or a.save_txt or a.save_crop or a.show:
                    self._write(res, metas[i])
                results.append(res)
            speed["postprocess"] = (time.perf_counter() - t2) / n * 1000
            self.seen += n
            for key, v in speed.items():
                self._totals[key] += v * n
                self.speed[key] = self._totals[key] / self.seen
            yield from results

        pending = None
        try:
            for path, img, meta in load_source(source,
                                               vid_stride=int(a.vid_stride)):
                buf_paths.append(path)
                buf_orig.append(img)
                buf_meta.append(meta)
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
        finally:
            for w in self._writers.values():
                w.release()
            self._writers = {}

    def _write(self, res, meta=None):
        """The files of one result (JAX predictor.py:378-417): with `save`
        the annotated image (a video's frames muxed into <stem>_pred.mp4)
        and, with save_enhanced, <stem>_enhanced.jpg; with save_txt
        labels/<stem>.txt; with save_crop crops/<class>/; with show a
        window. Every file but the txt goes through OpenCV."""
        a = self.args
        stem = Path(res.path).stem if res.path != "array" else "image"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        plot_args = {"line_width": a.line_width, "boxes": a.boxes,
                     "conf": a.show_conf, "labels": a.show_labels}
        if a.show:
            cv2 = require("cv2", "show")
            cv2.imshow(str(res.path), res.plot(**plot_args)[..., ::-1])
            cv2.waitKey(1 if meta is not None else 500)
        if meta is not None and a.save:
            cv2 = require("cv2", "saving a video")
            _, fps, _ = meta
            if res.path not in self._writers:
                h, w = res.orig_shape
                self._writers[res.path] = cv2.VideoWriter(
                    str(self.save_dir / f"{stem}_pred.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"),
                    max(fps / max(int(a.vid_stride), 1), 1), (w, h))
            self._writers[res.path].write(res.plot(**plot_args)[..., ::-1])
            return
        if a.save:
            res.save(self.save_dir / f"{stem}.jpg", **plot_args)
        if a.save_txt:
            res.save_txt(self.save_dir / "labels" / f"{stem}.txt",
                         save_conf=a.save_conf)
        if a.save_crop:
            res.save_crop(self.save_dir / "crops", file_name=stem)
        if a.save and res.enhanced_img is not None:
            cv2 = require("cv2", "saving the enhanced image")
            enh = (res.enhanced_img * 255).astype(np.uint8)
            cv2.imwrite(str(self.save_dir / f"{stem}_enhanced.jpg"),
                        enh[..., ::-1])
