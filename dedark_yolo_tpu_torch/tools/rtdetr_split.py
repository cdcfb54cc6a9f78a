"""Where RT-DETR's card-against-CPU readings that `chip_smoke.py`'s rtdetr
phase reports and does not hold come from (ROADMAP C16, C17), measured on
one device, by default the CPU.

    kinks   yolov8l-rtdetr (nc 3, seed 0) at 128, b2, the c14_split batch:
            the share of each level's deformable sampling points that lie
            within 1e-5 px of a pixel centre, where bilinear sampling has
            a kink (the init puts the queries' boxes on the anchors and
            the offsets on a ring whose axis-aligned heads add 0), and the
            relative change of every gradient leaf when the anchors move by
            1e-6 of themselves: the sampling offsets' leaves jump, the
            others stay (C17).
    threads the NMS-free val of the same model (BN set from the images) on
            8 seeded low-light images at 128 with torch at 8 threads and at
            1: the detections' score differences and each metric's relative
            difference; P at the F1-best point interpolates in the scores,
            the mAPs follow their order only (C16).

One JSON line each:

    python -m dedark_yolo_tpu_torch.tools.rtdetr_split [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..nn import heads as H
from ..nn import transformer as T
from .c14_split import TRAIN_SMALL, train_batch

MODEL = "yolov8l-rtdetr.yaml"


def _grads(yolo, batch, device):
    from ..engine.trainer import DetectionTrainer
    tr = DetectionTrainer(
        {"batch": 2, "nbs": 2, "optimizer": "SGD", "imgsz": TRAIN_SMALL},
        model=yolo.model, nb=1000, device=device)
    names = list(tr.params)
    tr.model.train()
    total, _ = tr.loss(tr.to_device(batch))
    g = torch.autograd.grad(total, [tr.params[n] for n in names],
                            allow_unused=True)
    tr.model.eval()
    return {n: x.detach().cpu() for n, x in zip(names, g) if x is not None}


@contextlib.contextmanager
def _patched(mod, name, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def kinks(device="cpu", seed=0):
    from ..engine.model import YOLO
    yolo = YOLO(MODEL, nc=3, device=device, seed=seed)
    start = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    batch = train_batch(2, TRAIN_SMALL, seed)
    shares = []

    def recording(sample):
        def call(value, loc, h, w):
            with torch.no_grad():
                x, y = loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5
                on = lambda t: float(((t - t.round()).abs() < 1e-5).float()
                                     .mean())
                shares.append([on(x), on(y)])
            return sample(value, loc, h, w)
        return call

    def nudged(anchors):
        def call(shapes, dev, eps=1e-2):
            a, valid = anchors(shapes, dev, eps)
            return torch.where(torch.isfinite(a), a * (1 + 1e-6), a), valid
        return call

    with _patched(T, "sample_level", recording):
        base = _grads(yolo, batch, device)
    yolo.model.load_state_dict(start)
    with _patched(H, "rtdetr_anchors", nudged):
        moved = _grads(yolo, batch, device)
    rel = {n: float((base[n] - w).norm() / w.norm())
           for n, w in moved.items() if w.abs().max() > 0}
    offsets = {n: e for n, e in rel.items() if "sampling_offsets" in n}
    others = {n: e for n, e in rel.items() if "sampling_offsets" not in n}
    nl = len(yolo.model.strides)
    return {"split": "kinks", "model": MODEL, "device": device,
            "imgsz": TRAIN_SMALL, "seed": seed,
            # the forward's calls: each decoder layer samples every level
            "share_at_pixel_centre_xy": shares[:nl],
            "offsets_grad_rel_change_max": max(offsets.values()),
            "offsets_grad_rel_change_min": min(offsets.values()),
            "others_grad_rel_change_max": max(others.values()),
            "others_grad_rel_change_median":
                sorted(others.values())[len(others) // 2]}


def _val_images(root, n=8, imgsz=TRAIN_SMALL, seed=0):
    """n seeded low-light images with 1-8 boxes each as .npy sidecars, in a
    YOLO layout; the dataset dict."""
    rng = np.random.default_rng(seed)
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for k in range(n):
        img = rng.uniform(0, 0.3, (imgsz, imgsz, 3))
        rows = []
        for _ in range(int(rng.integers(1, 9))):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            bw, bh = rng.uniform(0.1, 0.3, 2)
            x0, y0 = int((cx - bw / 2) * imgsz), int((cy - bh / 2) * imgsz)
            x1, y1 = int((cx + bw / 2) * imgsz), int((cy + bh / 2) * imgsz)
            img[y0:y1, x0:x1] = rng.uniform(0.3, 1.0, 3)
            rows.append(f"{int(rng.integers(0, 3))} {cx} {cy} {bw} {bh}")
        np.save(img_dir / f"{k}.npy", (img ** 3 * 255).astype(np.uint8))
        (img_dir / f"{k}.jpg").write_bytes(b"")
        (lbl_dir / f"{k}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "val": "images/val",
            "names": {0: "c0", 1: "c1", 2: "c2"}}


def _calibrate_bn(model, data, n=8):
    """Every BN's running stats set to its input's statistics over the n
    images (chip_smoke.py's calibrate_bn: a random-weight model keeps O(1)
    activations and spread-out scores)."""
    from ..nn.layers import BatchNorm
    root = Path(data["path"]) / data["val"]
    x = np.stack([np.load(root / f"{k}.npy")[..., ::-1] for k in range(n)])
    x = torch.from_numpy(np.ascontiguousarray(x)).float() / 255

    def hook(mod, args):
        mod.running_mean.copy_(args[0].mean((0, 2, 3)))
        mod.running_var.copy_(args[0].var((0, 2, 3), unbiased=False))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()


def threads(seed=0):
    from ..cfg import get_cfg
    from ..engine import validator as V
    from ..engine.model import YOLO
    yolo = YOLO(MODEL, nc=3, device="cpu", seed=seed)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = _val_images(Path(tmp) / "val", seed=seed)
        _calibrate_bn(yolo.model.eval(), data)
        kw = {"data": data, "imgsz": TRAIN_SMALL, "batch": 4, "cache": "disk",
              "plots": False, "verbose": False, "device": "cpu"}
        n = torch.get_num_threads()
        for t in (8, 1):
            torch.set_num_threads(t)
            confs = []
            with _patched(V.DetMetrics, "process", lambda p: lambda m, tp,
                          conf, *a: (confs.append(np.array(conf)),
                                     p(m, tp, conf, *a))[1]):
                res = V.DetectionValidator(args=get_cfg(overrides=kw))(
                    model=yolo.model)
            runs.append(({k: float(v) for k, v in res.items()}, confs[0]))
        torch.set_num_threads(n)
    (a, ca), (b, cb) = runs
    return {"split": "threads", "model": MODEL, "imgsz": TRAIN_SMALL,
            "seed": seed, "detections": [len(ca), len(cb)],
            "score_max_abs_diff": (float(np.abs(np.sort(ca) - np.sort(cb))
                                         .max()) if len(ca) == len(cb)
                                   else None),
            "metric_rel_diff": {k: abs(a[k] - b[k]) / abs(b[k]) if b[k]
                                else abs(a[k]) for k in a},
            "metrics_8_threads": a}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(kinks(a.device)), flush=True)
    print(json.dumps(threads()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
