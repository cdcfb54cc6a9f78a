"""Batched, prefetching data loader of fixed-shape batches (JAX data/loader.py
:52-189, the thread path).

Each item is made by `transforms(dataset, index, rng)` in a thread pool,
with the JAX package's per-item seed (`seed * 100003 + epoch + position *
7919 + index`, position within the batch) and its index order (with
`shuffle`, `random.Random(seed + epoch)` shuffles the indices; `set_epoch`
reshuffles), so the two loaders give the same batches. The collate stacks
uint8 (B, H, W, 3) images and pads the labels to `max_boxes` with a
validity mask; a task's `collate_fn` takes the batch's list of items
instead (the classify task's images and class ids), as the JAX loader's
does (data/loader.py:75-83).

With `use_processes` the items are made in a pool of forked processes
instead (JAX data/loader.py:22-49, 95-105, 157-166): the pool's
initializer holds (dataset, transforms, seed * 100003), each task carries
(index, position, epoch), and the per-item seed is the thread path's, so
switching modes never changes a batch. The pool forks once and serves
every epoch; `close()` terminates it. A parent that has initialised CUDA
may fork: the children run only numpy (`data/imgops.py`), never a torch
op, whose thread pool can hang after a fork, and they reset the signal
handlers they inherit (see `_mp_init`).

Under a mesh of several ranks each rank reads its own rows, as JAX's
per-host sharding does (`process_index` / `process_count`, JAX
data/loader.py:119-139): after the epoch's shuffle the index list is
wrap-padded to a multiple of the rank count, so every rank gets as many
rows and enters the step's collectives as often, and rank r takes every
count-th index from r. `batch_size` is then each rank's rows. The
validator reads in order (no shuffle, seed 0, epoch 0).
"""

from __future__ import annotations

import queue
import random
import signal
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# seconds the process workers may take for one batch; past that a worker
# is taken as stuck (a fork that inherited a held lock) and the pass raises
# multiprocessing.TimeoutError instead of waiting for ever
MP_BATCH_TIMEOUT = 600.0

# the forked workers' state, set by the pool's initializer
_MP_STATE: dict = {}


def _mp_init(dataset, transforms, base_seed):
    # a worker inherits the parent's signal handlers: the trainer's SIGTERM
    # handler only flags a stop, and a worker running it would outlive the
    # pool's terminate() (whose join then waits for ever); SIGINT is the
    # parent's to handle
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # OpenCV's thread pool does not survive a fork: one thread in each worker
    # (the items decode files with cv2 only where it is installed)
    cv2 = sys.modules.get("cv2")
    if cv2 is not None:
        cv2.setNumThreads(0)
    _MP_STATE.update(dataset=dataset, transforms=transforms,
                     base_seed=base_seed)


def _mp_make(task):
    i, pos, epoch = task
    rng = random.Random(_MP_STATE["base_seed"] + epoch + pos * 7919 + i)
    return _MP_STATE["transforms"](_MP_STATE["dataset"], i, rng)


def collate(items, max_boxes=128):
    """items: list of (img HWC uint8, xywh (n,4), cls (n,)) -> fixed-shape batch."""
    b = len(items)
    h, w = items[0][0].shape[:2]
    imgs = np.zeros((b, h, w, 3), np.uint8)
    bboxes = np.zeros((b, max_boxes, 4), np.float32)
    cls = np.zeros((b, max_boxes), np.float32)
    mask = np.zeros((b, max_boxes), np.float32)
    for i, (img, xywh, c) in enumerate(items):
        imgs[i] = img
        n = min(len(c), max_boxes)
        if n:
            bboxes[i, :n] = xywh[:n]
            cls[i, :n] = c[:n]
            mask[i, :n] = 1.0
    return {"img": imgs, "bboxes": bboxes, "cls": cls, "mask_gt": mask}


class DataLoader:
    """Iterable over fixed-shape batches with threaded decode/transform;
    `prefetch` batches are made ahead of the consumer (JAX loader.py:73)."""

    def __init__(self, dataset, transforms, batch_size, max_boxes=128,
                 shuffle=True, seed=0, workers=8, drop_last=True,
                 process_index=0, process_count=1, prefetch=2, indices=None,
                 collate_fn=None, use_processes=False):
        self.dataset = dataset
        self.indices = list(indices) if indices is not None else None
        self.transforms = transforms
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        # a task's collate (run in this process, never in a worker);
        # the detect collate pads the labels to max_boxes
        self.collate_fn = collate_fn or (lambda items: collate(items,
                                                               max_boxes))
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.use_processes = bool(use_processes)
        self.process_index, self.process_count = process_index, process_count
        self.prefetch = prefetch
        self._mp_pool = None

    def _pool(self):
        """The fork-start process pool, made at first use and kept."""
        if self._mp_pool is None:
            import multiprocessing as mp
            self._mp_pool = mp.get_context("fork").Pool(
                self.workers, initializer=_mp_init,
                initargs=(self.dataset, self.transforms, self.seed * 100003))
        return self._mp_pool

    def close(self):
        """Terminate the process pool, if any (the next pass forks anew)."""
        if self._mp_pool is not None:
            self._mp_pool.terminate()
            self._mp_pool.join()
            self._mp_pool = None

    def set_epoch(self, epoch):
        """The epoch whose order and item seeds the next pass uses
        (reference sampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        idx = list(self.indices) if self.indices is not None \
            else list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.process_count > 1:
            per = -(-len(idx) // self.process_count)
            pad = per * self.process_count - len(idx)
            if pad:
                reps = -(-pad // len(idx))
                idx = idx + (idx * reps)[:pad]
            idx = idx[self.process_index::self.process_count]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = self._indices()
        nb = len(self)
        base_seed = self.seed * 100003 + self.epoch

        def make_item(i, pos):
            rng = random.Random(base_seed + pos * 7919 + i)
            return self.transforms(self.dataset, i, rng)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            """Queue an item unless the consumer has gone; True if queued."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def batches(make):
            for bi in range(nb):
                chunk = idx[bi * self.batch_size:(bi + 1) * self.batch_size]
                if not put(self.collate_fn(make(chunk))):
                    return
            put(None)

        # the pool forks here, on the consumer's thread, not the producer's
        pool = self._pool() if self.use_processes else None

        def producer():
            try:
                if pool is not None:
                    epoch = self.epoch
                    batches(lambda chunk: pool.map_async(_mp_make, [
                        (i, pos, epoch) for pos, i in enumerate(chunk)
                    ]).get(MP_BATCH_TIMEOUT))
                    return
                with ThreadPoolExecutor(max_workers=self.workers) as ex:
                    batches(lambda chunk: list(ex.map(
                        lambda t: make_item(t[1], t[0]), enumerate(chunk))))
            except Exception as e:         # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()
