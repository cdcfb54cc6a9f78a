"""The train step's card-against-CPU measurement (`chip_smoke.py`'s
`train_parity`), and the split of ROADMAP C14 over it.

`train_parity` takes one SGD micro-step of a model at a small size, b2,
TF32 off, on the card and on the CPU from one state dict and one batch,
and holds the loss items, the gradients, the update, the BN stats and the
EMA to `TRAIN_TOL`; it also counts the anchors the task-aligned assigner
chose otherwise on the two (`tools/assign_probe.py`). C14: the flagship holds the bar at seed 0 and not at
seeds 1-3, while three zoo variants without layer 0 hold it at all four.
The split runs the measurement over seeds (weights and batch) for

    a  the flagship as the smoke runs it (128);
    b  yolov8l-dedark.yaml: layer 0 without ASFF (128);
    c  the flagship with layer 0's forward on the card computed by its
       plain version (`fused_enhance_reference`, stock torch ops) in place
       of the fused_enhance kernel, patched here only (128);
    d  the flagship at 256, where ASFF's compress BNs see 4x the values.

One JSON line a run. On a machine with one CUDA device:

    python -m dedark_yolo_tpu_torch.tools.c14_split --seeds 0,1,2,3 \
        --variants a,b,c,d
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

# the parity size and the label rows an image
TRAIN_SMALL, TRAIN_BOXES = 128, 8
# small-size card vs CPU, TF32 off, one SGD micro-step that applies the
# update (nbs = batch). cuDNN's convolutions sum in other orders than the
# CPU's, and the f32 train forward of these random weights is itself
# ill-conditioned: the port's and the JAX package's CPU forwards each sit
# ~2e-4 of the largest map value from a float64 forward
# (tests/test_torch_train_flagship.py), and the gradients of layer 0's
# parameter CNN differ by 5e-3 of their largest entry between the two
# packages on the CPU (tests/test_torch_train_slice.py). A leaf's gradient
# is held by its norm: the bias of a BN whose output feeds another
# train-mode BN gets a gradient that nearly cancels (a constant shift is
# taken out by the next layer's batch mean, but for the activation between),
# so its largest entry is a poor yardstick (4.9e-2 of it on an H100, where
# the median leaf read 3.4e-3). So: loss items 5e-3 relative;
# each gradient within 5e-2 of its norm; each parameter's and EMA entry's
# move 5e-2 of the largest move of its tensor (plus 1e-6); BN running stats
# 1e-3 absolute.
TRAIN_TOL = {"items_rel": 5e-3, "grad_rel": 5e-2, "move_rel": 5e-2,
             "stats_abs": 1e-3}

# variant -> (model, imgsz, layer 0's forward by its plain version)
VARIANTS = {"a": ("yolov8l.yaml", TRAIN_SMALL, False),
            "b": ("yolov8l-dedark.yaml", TRAIN_SMALL, False),
            "c": ("yolov8l.yaml", TRAIN_SMALL, True),
            "d": ("yolov8l.yaml", 2 * TRAIN_SMALL, False)}


def train_batch(n, imgsz, seed):
    """The JAX loader's batch dict: seeded clean u8 frames (32-px colour
    blocks with noise; the trainer darkens them) and TRAIN_BOXES label rows
    an image, a quarter of them padding."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, imgsz // 32, imgsz // 32, 3)) / 255
    img = np.kron(base, np.ones((1, 32, 32, 1)))
    img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    m = TRAIN_BOXES
    xy = rng.uniform(0.2, 0.8, (n, m, 2))
    wh = rng.uniform(0.05, 0.4, (n, m, 2))
    return {"img": (img * 255).astype(np.uint8),
            "cls": rng.integers(0, 3, (n, m)).astype(np.float32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask_gt": (rng.uniform(size=(n, m)) > 0.25).astype(np.float32)}


@contextlib.contextmanager
def plain_layer0_forward():
    """Within the block, `FusedEnhance`'s forward runs the plain chain
    (`fused_enhance_reference`) on a CUDA tensor instead of the kernel:
    variant c of the split, and nowhere else."""
    from ..ops import enhance_kernel as K
    kernel = K.fused_enhance
    K.fused_enhance = K.fused_enhance_reference
    try:
        yield
    finally:
        K.fused_enhance = kernel


def train_parity(name="yolov8l.yaml", imgsz=TRAIN_SMALL, seed=0,
                 device=None):
    """One micro-step of the model `name` at `imgsz`, b2, on `device` (None:
    cuda) and on the CPU from the same `seed`ed weights and batch: first the
    loss and gradients (the BN stats put back after), then `step` (update,
    BN stats, EMA). Returns the record, `ok` when it holds TRAIN_TOL."""
    return _parity(name, imgsz, seed, device, plain_layer0=False)


def train_parity_plain_layer0(name="yolov8l.yaml", imgsz=TRAIN_SMALL, seed=0,
                              device=None):
    """train_parity with layer 0's forward on `device` computed by its plain
    version (`plain_layer0_forward`): variant c of the split only."""
    return _parity(name, imgsz, seed, device, plain_layer0=True)


def _parity(name, imgsz, seed, device, plain_layer0):
    from ..engine.model import YOLO
    from ..engine.predictor import matmul_precision
    from ..engine.trainer import DetectionTrainer
    from . import assign_probe
    over = {"batch": 2, "nbs": 2, "optimizer": "SGD", "imgsz": imgsz}
    nb, step_index = 1000, 1500                # inside the 3000-step warmup
    gpu = YOLO(name, nc=3, device=device, seed=seed)
    cpu = YOLO(name, nc=3, device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    start = {k: v.cpu().clone() for k, v in cpu.state_dict().items()}
    batch = train_batch(2, imgsz, seed)
    got = {}
    with matmul_precision("float32"):
        for key, yolo, dev in (("gpu", gpu, device), ("cpu", cpu, "cpu")):
            tr = DetectionTrainer(yolo.model, over, nb=nb, device=dev)
            names = list(tr.params)
            with (plain_layer0_forward() if plain_layer0 and key == "gpu"
                  else contextlib.nullcontext()), \
                    assign_probe.record() as calls:
                tr.model.train()
                total, items = tr.loss(tr.to_device(batch))
                grads = torch.autograd.grad(
                    total, [tr.params[n] for n in names], allow_unused=True)
                tr.model.eval()
                tr.model.load_state_dict(start)
                _, step_items = tr.step(batch, step_index)
            got[key] = {"items": items, "step_items": step_items,
                        "grads": {n: g for n, g in zip(names, grads)
                                  if g is not None},
                        "state": tr.model.state_dict(), "ema": tr.ema,
                        "updates": (tr.opt_state.step, tr.ema_updates),
                        "assign": calls}
    g, c = got["gpu"], got["cpu"]
    cpu_of = lambda t: t.detach().cpu()
    rel = lambda a, b: float((cpu_of(a) - b).abs().max() / b.abs().max())
    items_rel = max(rel(torch.stack(list(g["items"])), torch.stack(list(c["items"]))),
                    rel(g["step_items"], c["step_items"]))
    grad_rel = {n: float(torch.linalg.vector_norm(cpu_of(g["grads"][n]) - w)
                         / torch.linalg.vector_norm(w))
                for n, w in c["grads"].items() if w.abs().max() > 0}
    worst_grad = max(grad_rel, key=grad_rel.get)
    grad_max_rel = max(rel(g["grads"][n], c["grads"][n]) for n in grad_rel)
    stats_err, move_err = 0.0, {}
    for k, w in c["state"].items():
        if "running_" in k:
            stats_err = max(stats_err, float((cpu_of(g["state"][k]) - w).abs().max()),
                            float((cpu_of(g["ema"][k]) - c["ema"][k]).abs().max()))
            continue
        moved = float((w - start[k]).abs().max())
        err = max(float((cpu_of(g["state"][k]) - w).abs().max()),
                  float((cpu_of(g["ema"][k]) - c["ema"][k]).abs().max()))
        move_err[k] = (err - 1e-6) / moved if moved else (0.0 if err <= 1e-6 else float("inf"))
    worst_move = max(move_err, key=move_err.get)
    rec = {"model": name, "imgsz": imgsz, "batch": 2, "seed": seed,
           "layer0_forward": "plain" if plain_layer0 else "kernel",
           "items_gpu": [float(x) for x in g["items"]],
           "items_cpu": [float(x) for x in c["items"]],
           "items_max_rel_err": items_rel,
           "grad_norm_rel_err": grad_rel[worst_grad], "grad_worst_leaf": worst_grad,
           "grad_norm_rel_err_median": sorted(grad_rel.values())[len(grad_rel) // 2],
           "grad_max_entry_rel_err": grad_max_rel,
           "move_max_rel_err": move_err[worst_move], "move_worst": worst_move,
           "bn_stats_and_ema_max_abs_err": stats_err,
           # anchors the assigner gave another GT or none, loss then step
           "assign_flips": assign_probe.flips(g["assign"], c["assign"]),
           "assign_least_margins": [min(x["topk"], x["claim"])
                                    for x in c["assign"]],
           "updates_gpu": g["updates"], "updates_cpu": c["updates"],
           "tol": TRAIN_TOL}
    rec["ok"] = (items_rel <= TRAIN_TOL["items_rel"]
                 and rec["grad_norm_rel_err"] <= TRAIN_TOL["grad_rel"]
                 and rec["move_max_rel_err"] <= TRAIN_TOL["move_rel"]
                 and stats_err <= TRAIN_TOL["stats_abs"]
                 and g["updates"] == c["updates"] == (1, 1))
    return rec


def split(seeds=(0, 1, 2, 3), variants="abcd", device=None):
    """train_parity of each variant at each seed: a list of records, each
    tagged with its variant."""
    out = []
    for v in variants:
        name, imgsz, plain = VARIANTS[v]
        measure = train_parity_plain_layer0 if plain else train_parity
        for s in seeds:
            rec = measure(name, imgsz, s, device=device)
            out.append({"variant": v, **rec})
            if device is None:
                torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--variants", default="a,b,c,d")
    a = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(s) for s in a.seeds.split(",")]
    for rec in split(seeds, a.variants.replace(",", "")):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
