"""Batched, prefetching data loader of fixed-shape batches (JAX data/loader.py
:52-189, the thread path).

Each item is made by `transforms(dataset, index, rng)` in a thread pool,
with the JAX package's per-item seed (`seed * 100003 + epoch + position *
7919 + index`, position within the batch) and its index order (with
`shuffle`, `random.Random(seed + epoch)` shuffles the indices; `set_epoch`
reshuffles), so the two loaders give the same batches. The collate stacks
uint8 (B, H, W, 3) images and pads the labels to `max_boxes` with a
validity mask.

One process: the JAX loader's per-host sharding (`process_index` /
`process_count`) stays at 0 of 1. The validator reads in order (no
shuffle, seed 0, epoch 0). Not ported: the forked-process workers
(`use_processes`) and task collates (`collate_fn`).
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PREFETCH = 2    # batches made ahead of the consumer


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
    """Iterable over fixed-shape batches with threaded decode/transform."""

    def __init__(self, dataset, transforms, batch_size, max_boxes=128,
                 workers=8, drop_last=True, indices=None, shuffle=False,
                 seed=0):
        self.dataset = dataset
        self.indices = list(indices) if indices is not None else None
        self.transforms = transforms
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        """The epoch whose order and item seeds the next pass uses
        (reference sampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        idx = list(self.indices) if self.indices is not None \
            else list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
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

        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
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

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as ex:
                    for bi in range(nb):
                        chunk = idx[bi * self.batch_size:(bi + 1) * self.batch_size]
                        items = list(ex.map(lambda t: make_item(t[1], t[0]),
                                            enumerate(chunk)))
                        if not put(collate(items, self.max_boxes)):
                            return
                put(None)
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
