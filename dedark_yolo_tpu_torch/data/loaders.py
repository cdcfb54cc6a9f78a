"""Predict sources beyond image files and arrays (JAX data/loaders.py;
reference data/loaders.py).

`LoadStreams` reads webcams, RTSP/RTMP/HTTP streams and `.streams` list
files through OpenCV, one daemon reader thread a source, and yields the
freshest frame of every live stream a tick. `LoadScreenshots` grabs the
screen through `mss`. PIL images and CHW tensors become the BGR uint8
arrays every other source yields. OpenCV and mss are imported when a
loader opens (`utils.patches.require`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

from ..utils import LOGGER
from ..utils.patches import require

STREAM_PREFIXES = ("rtsp://", "rtmp://", "tcp://", "udp://", "http://",
                   "https://")


def is_stream_source(source) -> bool:
    """True when `source` names a live stream: a webcam index (int or
    numeric string), a streaming URL, or a `.streams` list file."""
    if isinstance(source, int):
        return True
    if not isinstance(source, str):
        return False
    s = source.strip().lower()
    return (s.isnumeric() or s.endswith(".streams")
            or s.startswith(STREAM_PREFIXES))


class LoadStreams:
    """Threaded multi-stream video loader. Each source's thread reads
    frames into a bounded deque (the oldest dropped when the consumer falls
    behind); iteration yields (paths, frames, metas), one frame a still-live
    stream, and ends when every stream has closed and drained. Video files
    open too, which is how a test fakes a stream."""

    def __init__(self, sources, vid_stride: int = 1, buffer_len: int = 30):
        cv2 = require("cv2", "reading streams")
        self.vid_stride = max(1, int(vid_stride))
        if isinstance(sources, (str, Path)) and str(sources).endswith(
                ".streams"):
            sources = [s for s in Path(sources).read_text().split() if s]
        elif isinstance(sources, (str, int, Path)):
            sources = [sources]
        self.sources = [str(s) for s in sources]
        n = len(self.sources)
        if n == 0:
            raise ValueError("no stream sources given")
        self.caps, self.threads = [], []
        self.buffers = [deque(maxlen=buffer_len) for _ in range(n)]
        self.fps = [30.0] * n
        self.alive = [True] * n
        self.running = True
        for i, s in enumerate(self.sources):
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            if not cap.isOpened():
                self.close()
                raise ConnectionError(f"could not open stream {i}: {s}")
            self.fps[i] = cap.get(cv2.CAP_PROP_FPS) or 30.0
            ok, frame = cap.read()  # one frame before returning
            if not ok or frame is None:
                self.close()
                raise ConnectionError(f"could not read from stream {i}: {s}")
            self.buffers[i].append(frame)
            self.caps.append(cap)
            self.threads.append(threading.Thread(
                target=self._update, args=(i, cap), daemon=True))
            LOGGER.info(f"stream {i}: {s} opened ({frame.shape[1]}x"
                        f"{frame.shape[0]} @ {self.fps[i]:.0f} FPS)")
        for t in self.threads:
            t.start()

    def _update(self, i: int, cap):
        n = 0
        try:
            while self.running and cap.isOpened():
                if len(self.buffers[i]) == self.buffers[i].maxlen:
                    self.buffers[i].popleft()   # prefer fresh frames
                n += 1
                if not cap.grab():
                    break
                if n % self.vid_stride == 0:
                    ok, frame = cap.retrieve()
                    if not ok or frame is None:
                        break
                    self.buffers[i].append(frame)
        finally:
            self.alive[i] = False

    def __iter__(self):
        return self

    def __next__(self):
        paths, frames, metas = [], [], []
        frame_idx = getattr(self, "_tick", 0)
        self._tick = frame_idx + 1
        for i in range(len(self.sources)):
            t0 = time.time()
            while not self.buffers[i]:
                if not self.alive[i] or not self.running:
                    break
                if time.time() - t0 > 30.0:
                    LOGGER.warning(f"stream {i} stalled >30s; dropping")
                    break
                time.sleep(0.002)
            if self.buffers[i]:
                paths.append(self.sources[i])
                frames.append(self.buffers[i].popleft())
                metas.append((frame_idx, self.fps[i], 0))  # total unknown
        if not frames:
            self.close()
            raise StopIteration
        return paths, frames, metas

    def close(self):
        self.running = False
        for t in self.threads:
            if t.is_alive():
                t.join(timeout=2.0)
        for cap in self.caps:
            try:
                cap.release()
            except Exception:
                pass
        self.caps, self.threads = [], []

    def __del__(self):
        self.close()


class LoadScreenshots:
    """Screen capture through `mss`: "screen" or "screen N [left top width
    height]"."""

    def __init__(self, source: str = "screen", max_frames: int | None = None):
        mss = require("mss", "screen capture (source='screen')")
        parts = str(source).split()[1:]
        self.screen = int(parts[0]) if parts else 0
        self.sct = mss.mss()
        mon = self.sct.monitors[self.screen]
        left, top = mon["left"], mon["top"]
        width, height = mon["width"], mon["height"]
        if len(parts) == 5:
            left = mon["left"] + int(parts[1])
            top = mon["top"] + int(parts[2])
            width, height = int(parts[3]), int(parts[4])
        self.monitor = {"left": left, "top": top,
                        "width": width, "height": height}
        self.max_frames = max_frames
        self.frame = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.max_frames is not None and self.frame >= self.max_frames:
            raise StopIteration
        img = np.asarray(self.sct.grab(self.monitor))[:, :, :3]  # BGRA -> BGR
        self.frame += 1
        path = (f"screen {self.screen} (LTWH): "
                f"{self.monitor['left']},{self.monitor['top']},"
                f"{self.monitor['width']},{self.monitor['height']}")
        return [path], [img], [(self.frame - 1, 30.0, 0)]


def pil_to_bgr(im) -> np.ndarray:
    """PIL.Image -> BGR uint8 array."""
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.ascontiguousarray(np.asarray(im)[:, :, ::-1])


def tensor_to_bgr_list(t) -> list:
    """(3, H, W) or (B, 3, H, W) RGB tensor, float in [0, 1] or uint8 ->
    list of BGR uint8 (H, W, 3) arrays. A float tensor above 1 is taken as
    0-255 and divided by 255, with a warning."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
    arr = np.asarray(t)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[1] != 3:
        raise ValueError(f"tensor source must be (3,H,W) or (B,3,H,W) RGB, "
                         f"got {arr.shape}")
    if arr.dtype != np.uint8:
        if float(arr.max(initial=0.0)) > 1.0 + 1e-3:
            LOGGER.warning("float tensor source has values >1.0; assuming "
                           "0-255 range and dividing by 255")
            arr = arr / 255.0
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return [np.ascontiguousarray(im.transpose(1, 2, 0)[:, :, ::-1])
            for im in arr]
