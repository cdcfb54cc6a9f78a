"""Dynamic-batching inference server (JAX engine/server.py), the serving path.

Requests arriving on independent threads are coalesced into one batch of
the fixed shape `max_batch` (a short batch is padded with copies of its
first image), letterboxed by the native host library
(`native.letterbox_batch`, as the predictor does), run through the
device step of the model's task predictor (`DetectionPredictor.step`:
upload, layer 0's fused_enhance kernel, the graph, decode, the nms kernel;
a segment or pose model's predictor adds its masks or keypoints, JAX
server.py:121-157) and demultiplexed back to per-request futures, each
request's boxes scaled to its own image with the letterbox inverse
(`ops.boxes.scale_boxes`) and its masks or keypoints given by the
predictor's `extra_fields` (JAX server.py:363-366), as predict gives them.

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
        POST /predict   image bytes (jpg/png, decoded by OpenCV) -> detections
                        JSON; a segment model's masks as polygons (each
                        mask's largest external contour, `imgops`), a pose
                        model's keypoints
        GET  /healthz   liveness
        GET  /stats     requests, batches, occupancy, latency p50/p95

Batching policy: the worker blocks for the first request, then waits at
most ``max_wait_ms`` for followers. An exported `.pt2` artifact is served
through AutoBackend (JAX server.py:110-125): its sidecar's batch, imgsz
and names win over the arguments, and only NMS runs behind its program.
A classify model is refused as JAX refuses it (server.py:125-128): its
predictions are YOLO.predict's.

Over a mesh of this process's devices (`mesh=make_mesh(devices=[...])`,
JAX server.py:54-73, :164-175, :335-337, where GSPMD shards the batch over
the mesh): each padded batch splits into n equal groups of images, one a
device of the mesh in its order, each run by its own predictor (its own
pinned upload buffers) on the model's replica on that device, copied once
at setup with the ensemble members' weights, one copy a distinct device.
Every group is dispatched before any is read back; each group's NMS runs
on its device, and the responses keep the batch's order. The warmup takes
the same path. A device may repeat (`["cuda:0", "cuda:0"]`).
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
from ..data.imgops import contour_area, find_external_contours
from ..ops.boxes import scale_boxes
from ..utils import LOGGER
from ..utils.patches import require
from .autobackend import refuse_jax_artifact
from .predictor import DetectionPredictor, resolve_device


def mask_polygon(mask):
    """A mask's largest external contour as (m, 2) int32 pixels, the first
    of equal areas; (0, 2) for an empty mask (JAX server.py:416-426,
    cv2.findContours RETR_EXTERNAL / CHAIN_APPROX_SIMPLE and contourArea,
    through `data/imgops.py`)."""
    cs = find_external_contours(np.asarray(mask, np.uint8))
    if not cs:
        return np.zeros((0, 2), np.int32)
    return cs[int(np.argmax([contour_area(c) for c in cs]))]


def check_serve_mesh(mesh, spec, max_batch, device):
    """The mesh a server runs over, or None; refused as JAX refuses it
    (server.py:60-73): an exported artifact, a max_batch that is not a
    multiple of the mesh size; and a mesh that is not over this process's
    devices, or a `device` that is not its first."""
    if mesh is None:
        return None
    from ..parallel import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: a parallel.Mesh, not {type(mesh).__name__}")
    if not mesh.devices:
        raise ValueError("InferenceServer(mesh=) takes a mesh over this "
                         "process's devices: make_mesh(devices=[...])")
    if spec.endswith(".pt2"):
        raise ValueError(
            "exported artifacts (.pt2) carry fixed single-device shapes; "
            "serve the checkpoint instead to shard over a mesh")
    if max_batch % mesh.size:
        raise ValueError(f"max_batch {max_batch} must be a multiple of the "
                         f"mesh size {mesh.size}")
    d = None if device is None else torch.device(device)
    if d is not None and (d.type != mesh.device.type or d.index not in (
            None, mesh.device.index)):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.device}")
    return mesh


class InferenceServer:
    """Coalesce concurrent detection requests into fixed-shape device batches.

    model_spec: a .npz checkpoint, an architecture (anything YOLO() takes
    by name) or an exported `.pt2` artifact (whose own batch and imgsz
    win). max_batch: the one batch shape, also the coalescing cap.
    max_wait_ms: how long the worker holds the first request for followers.
    device: None means cuda (and raises without a CUDA device); "cpu" runs
    the plain versions of the kernels. mesh: a mesh over this process's
    devices (`parallel.make_mesh(devices=...)`), max_batch a multiple of
    its size; the devices are then the mesh's.
    """

    def __init__(self, model_spec, imgsz=640, max_batch=8, max_wait_ms=5.0,
                 conf=0.25, iou=0.7, max_det=300, max_nms=2048, half=False,
                 warmup=True, mesh=None, device=None):
        spec = str(model_spec)
        refuse_jax_artifact(spec)
        self.imgsz = int(imgsz)
        self.max_batch = int(max_batch)
        self._mesh = check_serve_mesh(mesh, spec, self.max_batch, device)
        self.device = (self._mesh.device if self._mesh is not None
                       else resolve_device(device))
        self._preds = None      # a mesh's predictors, one a device
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
            raise ValueError(
                "InferenceServer serves detection-family tasks (detect, "
                "segment, pose); use YOLO.predict for classify")

    def _setup(self):
        from .model import TASK_CLASSES, YOLO
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
        # the task's predictor, as YOLO.predict dispatches (JAX :144-157);
        # only detect takes ensemble members
        pred_cls = TASK_CLASSES[model.task][2]
        kw = {"members": members} if pred_cls is DetectionPredictor else {}
        if self._mesh is None:
            self._pred = pred_cls(args=get_cfg(overrides=over), model=model,
                                  names=self.names, save_dir=".", **kw)
        else:
            self._preds = self._mesh_predictors(pred_cls, model, over, kw)
            self._pred = self._preds[0]
        if warmup:
            z = np.zeros((self.max_batch, self.imgsz, self.imgsz, 3), np.uint8)
            out = self._step(z)
            for o in (out if self._preds else [out]):
                o["counts"].cpu()                # a real readback

    def _mesh_predictors(self, pred_cls, model, over, kw):
        """One predictor a device of the mesh, each of a group of max_batch
        / n images, on the model's replica on its device; the members'
        weights moved once a distinct device."""
        from ..parallel.spatial import replicas
        devices = list(self._mesh.devices)
        reps = replicas(model, devices)
        group = self.max_batch // len(devices)
        preds, states = [], {}
        for dev in devices:
            p = pred_cls(args=get_cfg(overrides={**over, "batch": group,
                                       "device": str(dev)}),
                         model=reps[dev].eval(), names=self.names,
                         save_dir=".", **kw)
            if dev in states:
                p._member_states = states[dev]
            elif kw.get("members"):
                p._forwards()
                states[dev] = p._member_states
            preds.append(p)
        return preds

    def _step(self, batch):
        """Dispatch one padded batch: the predictor's step, or over a mesh
        each device's step on its group of images, none waited for."""
        if self._preds is None:
            return self._pred.step(batch)
        g = self.max_batch // len(self._preds)
        return [p.step(batch[k * g:(k + 1) * g])
                for k, p in enumerate(self._preds)]

    def _readback(self, out, n):
        """The host outputs of a batch of n images (the wait of a batch) ->
        at(i) = (host outputs, the index there) of image i."""
        if self._preds is None:
            host = self._pred.readback(out, n)
            return lambda i: (host, i)
        g = self.max_batch // len(self._preds)
        hosts = [p.readback(o, min(n - k * g, g))
                 for k, (p, o) in enumerate(zip(self._preds, out))
                 if n > k * g]
        return lambda i: (hosts[i // g], i % g)

    # ------------------------------------------------------------- client API
    def submit(self, img_bgr: np.ndarray) -> Future:
        """Enqueue one HWC-BGR uint8 image; resolves to a detections dict:
        {"boxes": (k, 6) float32 [x1, y1, x2, y2, conf, cls] in the image's
        own pixels, "names": the class names, "latency_ms": the server-side
        latency}, and a segment model's "masks" (k, h, w) bool or a pose
        model's "keypoints" (k, nk, 3), at the image's own size."""
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
        return items, shapes, self._step(batch)   # not waited for

    def _demux(self, items, shapes, out):
        at = self._readback(out, len(items))   # waits for the batch
        t_done = time.perf_counter()
        sz = self.imgsz
        with self._lock:
            self._n_batches += 1
            self._n_images += len(items)
        for i, (_, fut, t_in) in enumerate(items):
            host, j = at(i)
            k = int(host["counts"][j])
            det = host["dets"][j, :k].copy()
            if k:
                det[:, :4] = scale_boxes((sz, sz), torch.from_numpy(det[:, :4]),
                                         shapes[i]).numpy()
            lat = (t_done - t_in) * 1000.0
            with self._lock:
                self._lat_ms.append(lat)
            fut.set_result({"boxes": det.astype(np.float32),
                            "names": self.names, "latency_ms": lat,
                            **self._pred.extra_fields(host, j, k, shapes[i],
                                                      sz)})

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
                    payload = {
                        "boxes": r["boxes"].tolist(),
                        "names": {str(k): v for k, v in r["names"].items()},
                        "latency_ms": r["latency_ms"]}
                    if "keypoints" in r:
                        payload["keypoints"] = np.asarray(
                            r["keypoints"]).tolist()
                    if "masks" in r:
                        payload["masks"] = [mask_polygon(m).tolist()
                                            for m in r["masks"]]
                    self._json(200, payload)
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
