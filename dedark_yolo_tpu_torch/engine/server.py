"""Dynamic-batching inference server (JAX engine/server.py), the serving path.

Requests arriving on independent threads are coalesced into one batch of
the fixed shape `max_batch` (a short batch is padded with copies of its
first image), letterboxed by the native host library
(`native.letterbox_batch`, as the predictor does), run through the
predictor's device step (`DetectionPredictor.step`: upload, layer 0's
fused_enhance kernel, the graph, decode, the nms kernel) and demultiplexed
back to per-request futures, each request's boxes scaled to its own image
with the letterbox inverse (`ops.boxes.scale_boxes`).

One worker thread owns all device work: the model's build, the warmup,
every dispatch and readback (`torch.inference_mode` and the current CUDA
stream are per thread, so the step runs there with its own decorator).
Its loop is depth-2: batch i+1 is letterboxed and dispatched before batch
i is read back, so the host's letterbox and upload overlap the device's
batch; the predictor's two pinned upload buffers in turns keep two batches
in flight apart.

Two front-ends share the batcher:
  - in-process: ``submit(img_bgr) -> Future``;
  - HTTP (stdlib): ``serve(port)`` exposes
        POST /predict   image bytes (jpg/png, decoded by OpenCV) -> detections JSON
        GET  /healthz   liveness
        GET  /stats     requests, batches, occupancy, latency p50/p95

Batching policy: the worker blocks for the first request, then waits at
most ``max_wait_ms`` for followers. An exported `.pt2` artifact is served
through AutoBackend (JAX server.py:110-125): its sidecar's batch, imgsz
and names win over the arguments, and only NMS runs behind its program.
Not ported: a mesh (ROADMAP A12) and the segment/pose tasks (their masks
and keypoints, A12e-A12f). A classify model is refused as JAX refuses it
(server.py:120-128): its predictions are YOLO.predict's.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Queue

import numpy as np
import torch

from .. import native
from ..cfg import get_cfg
from ..data.augment import PAD_VALUE
from ..ops.boxes import scale_boxes
from ..utils import LOGGER
from ..utils.patches import require
from .autobackend import refuse_jax_artifact
from .predictor import DetectionPredictor, resolve_device


def _unported(what):
    return NotImplementedError(f"{what} is not ported to dedark_yolo_tpu_torch "
                               "(ROADMAP A12)")


class InferenceServer:
    """Coalesce concurrent detection requests into fixed-shape device batches.

    model_spec: a .npz checkpoint, an architecture (anything YOLO() takes
    by name) or an exported `.pt2` artifact (whose own batch and imgsz
    win). max_batch: the one batch shape, also the coalescing cap.
    max_wait_ms: how long the worker holds the first request for followers.
    device: None means cuda (and raises without a CUDA device); "cpu" runs
    the plain versions of the kernels.
    """

    def __init__(self, model_spec, imgsz=640, max_batch=8, max_wait_ms=5.0,
                 conf=0.25, iou=0.7, max_det=300, max_nms=2048, half=False,
                 warmup=True, mesh=None, device=None):
        if mesh is not None:
            raise _unported("serving over a mesh")
        spec = str(model_spec)
        refuse_jax_artifact(spec)
        self.device = resolve_device(device)
        self.imgsz = int(imgsz)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q: Queue = Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_images = 0
        self._lat_ms = deque(maxlen=1024)
        self._t_start = time.time()

        self._ready = threading.Event()
        self._setup_exc = None
        over = dict(conf=conf, iou=iou, max_det=max_det, max_nms=max_nms,
                    half=half, batch=self.max_batch, imgsz=self.imgsz,
                    device=str(self.device))
        self._setup_args = (spec, over, warmup)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dedark-batcher")
        self._worker.start()
        self._ready.wait(timeout=1800)
        if self._setup_exc is not None:
            self._stop.set()
            raise self._setup_exc
        if not self._ready.is_set():
            self._stop.set()
            raise TimeoutError("server setup (build/warmup) timed out")

    @staticmethod
    def _check_task(task):
        if task == "classify":
            raise NotImplementedError(
                "InferenceServer serves detect models; use YOLO.predict for "
                "classify")
        if task != "detect":
            raise NotImplementedError(f"serving a {task} model is not ported "
                                      "(ROADMAP A12e-b, A12f)")

    def _setup(self):
        from .model import YOLO
        spec, over, warmup = self._setup_args
        if spec.endswith(".pt2"):
            from .autobackend import AutoBackend
            model = AutoBackend(spec, device=self.device)
            self._check_task(model.task)
            self.imgsz, self.max_batch = model.imgsz, model.batch
            over.update(imgsz=self.imgsz, batch=self.max_batch)
            names, members = model.names, []
        else:
            y = YOLO(spec, device=self.device)
            self._check_task(y.model.task)
            model, names, members = y.model, y.names, y.members
            model.to(self.device).eval()
        self.names = {int(k): v for k, v in (names or {}).items()}
        self._pred = DetectionPredictor(args=get_cfg(over), model=model,
                                        names=self.names, save_dir=".",
                                        members=members)
        if warmup:
            z = np.zeros((self.max_batch, self.imgsz, self.imgsz, 3), np.uint8)
            self._pred.step(z)["counts"].cpu()    # a real readback

    # ------------------------------------------------------------- client API
    def submit(self, img_bgr: np.ndarray) -> Future:
        """Enqueue one HWC-BGR uint8 image; resolves to a detections dict:
        {"boxes": (k, 6) float32 [x1, y1, x2, y2, conf, cls] in the image's
        own pixels, "names": the class names, "latency_ms": the server-side
        latency}."""
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._q.put((img_bgr, fut, time.perf_counter()))
        with self._lock:
            self._n_requests += 1
        return fut

    def predict(self, img_bgr, timeout=60.0):
        """Blocking convenience wrapper around submit()."""
        return self.submit(img_bgr).result(timeout=timeout)

    def stats(self):
        with self._lock:
            lats = sorted(self._lat_ms)
            n = len(lats)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "mean_batch_occupancy": (self._n_images / self._n_batches
                                         if self._n_batches else 0.0),
                "latency_ms_p50": lats[n // 2] if n else 0.0,
                "latency_ms_p95": lats[min(n - 1, int(n * 0.95))] if n else 0.0,
                "uptime_s": time.time() - self._t_start,
                "imgsz": self.imgsz,
                "max_batch": self.max_batch,
            }

    def reset_stats(self):
        """Zero the counters and the latency window (between load phases)."""
        with self._lock:
            self._n_requests = self._n_batches = self._n_images = 0
            self._lat_ms.clear()
            self._t_start = time.time()

    def close(self):
        self._stop.set()
        self._q.put(None)  # unblock the worker
        self._worker.join(timeout=30)
        # fail anything still queued (submits that raced close included):
        # a future that never resolves is worse than an explicit error
        while True:
            try:
                item = self._q.get_nowait()
            except Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("server closed"))

    # ---------------------------------------------------------------- batcher
    def _collect(self, block=True):
        """One coalescing window: block for the first request (unless a
        batch is in flight: block=False takes only what is queued now),
        then drain up to max_batch within max_wait_ms."""
        try:
            first = self._q.get(timeout=0.25) if block else self._q.get_nowait()
        except Empty:
            return []
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(items) < self.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self):
        """The worker: setup, then the depth-2 loop (dispatch batch i+1
        before reading back batch i; with nothing queued, the pending batch
        resolves at once)."""
        try:
            self._setup()
        except Exception as e:
            self._setup_exc = e
            self._ready.set()
            return
        self._ready.set()
        pending = None
        while not self._stop.is_set():
            items = self._collect(block=pending is None)
            dispatched = None
            if items:
                try:
                    dispatched = self._dispatch(items)
                except Exception as e:  # to the waiting clients
                    LOGGER.error(f"serving batch failed: {e}")
                    for _, fut, _ in items:
                        if not fut.done():
                            fut.set_exception(e)
            if pending is not None:
                self._finish(pending)
            pending = dispatched
        if pending is not None:
            self._finish(pending)

    def _finish(self, pending):
        items, shapes, out = pending
        try:
            self._demux(items, shapes, out)
        except Exception as e:
            LOGGER.error(f"serving readback failed: {e}")
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)

    def _dispatch(self, items):
        # per-item validation first: a malformed request fails only its own
        # future, never the others coalesced into the same batch
        good = []
        for img, fut, t_in in items:
            if (isinstance(img, np.ndarray) and img.ndim == 3
                    and img.shape[2] == 3 and img.shape[0] > 0
                    and img.shape[1] > 0 and img.dtype == np.uint8):
                good.append((img, fut, t_in))
            elif not fut.done():
                fut.set_exception(ValueError(
                    "expected HWC-BGR uint8 image, got "
                    f"{getattr(img, 'dtype', '')} shape "
                    f"{getattr(img, 'shape', type(img).__name__)}"))
        items = good
        if not items:
            return None
        shapes = [img.shape[:2] for img, _, _ in items]
        srcs = [img for img, _, _ in items]
        srcs += [srcs[0]] * (self.max_batch - len(srcs))
        batch = native.letterbox_batch(srcs, self.imgsz, fill=PAD_VALUE,
                                       swap_rb=True)
        return items, shapes, self._pred.step(batch)   # not waited for

    def _demux(self, items, shapes, out):
        dets = out["dets"].cpu().numpy()   # waits for the batch
        counts = out["counts"].cpu().numpy()
        t_done = time.perf_counter()
        sz = self.imgsz
        with self._lock:
            self._n_batches += 1
            self._n_images += len(items)
        for i, (_, fut, t_in) in enumerate(items):
            k = int(counts[i])
            det = dets[i, :k].copy()
            if k:
                det[:, :4] = scale_boxes((sz, sz), torch.from_numpy(det[:, :4]),
                                         shapes[i]).numpy()
            lat = (t_done - t_in) * 1000.0
            with self._lock:
                self._lat_ms.append(lat)
            fut.set_result({"boxes": det.astype(np.float32),
                            "names": self.names, "latency_ms": lat})

    # ------------------------------------------------------------------- HTTP
    def serve(self, port=0, host="127.0.0.1"):
        """Start the stdlib HTTP front-end on a daemon thread; returns
        (httpd, bound_port). httpd.shutdown() stops it."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._json(200, server.stats())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/predict":
                    return self._json(404, {"error": "unknown path"})
                try:
                    cv2 = require("cv2", "decoding a POST /predict image")
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                       cv2.IMREAD_COLOR)
                    if img is None:
                        return self._json(400, {"error": "undecodable image"})
                    r = server.predict(img)
                    self._json(200, {
                        "boxes": r["boxes"].tolist(),
                        "names": {str(k): v for k, v in r["names"].items()},
                        "latency_ms": r["latency_ms"]})
                except Exception as e:
                    self._json(500, {"error": str(e)})

        httpd = ThreadingHTTPServer((host, port), Handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="dedark-http")
        t.start()
        bound = httpd.server_address[1]
        LOGGER.info(f"serving on http://{host}:{bound} (batch <= "
                    f"{self.max_batch}, wait {self.max_wait_s * 1e3:.0f} ms)")
        return httpd, bound
