"""Data-parallel runs in spawned ranks: the train step and val of a group
against one process (`chip_smoke.py`'s `dist` phase and the CPU tests).

`launch(n, argv)` starts n ranks of this module as subprocesses with
torchrun's variables (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT on a free local port) and returns each rank's exit code and
output. A rank joins the group with `parallel.init_from_env(device,
backend)` and runs one scenario:

    step  `DetectionTrainer.step` at the global batch indices `--steps` on
          this rank's rows of the global batches in `--batches` (an .npz
          of img_k, cls_k, bboxes_k, mask_gt_k), from `--state` (an .npz
          state dict) or the seeded weights; writes the items, totals,
          state dict, EMA and optimizer buffers to `--out`_rank{r}.npz
    val   `DetectionValidator(mesh=)` of `--model` (and `--state`) on the
          dataset `--data` (a .json dict or a yaml path); writes the
          results and launches to `--out`_rank{r}.json
    step_val  `step`, then in the same ranks and group `val` with
          `--val-state`, `--val-imgsz`, `--val-overrides` and `--val-out`
          in place of `--state`, `--imgsz`, `--overrides` and `--out`
          (one launch of the group for both)

`--spatial N` (N > 1) adds a 'spatial' axis of N devices a rank (the
rank's device N times): `step` then runs on the data x spatial mesh;
`step_val` runs the data-only step, then the data x spatial step from the
same state to `--out`_spatial and the data-only step from every float
parameter one ulp up to `--out`_ulp (what a rounding-sized change moves),
the group's val, then rank 0's val over a mesh of its N devices to
`--val-out`_local.

`--spatial-ranks N` (N > 1) puts the 'spatial' axis over N ranks instead
(the group's dp * N ranks, one device a rank: JAX's multi-process mesh,
`parallel.mesh.rank_spatial_mesh`): `step` runs on that mesh (each data
coordinate's rows of the global batch, each rank its slab of them);
`infer` runs `spatial_infer` of `--frames` (an .npz of `img` (B, H, W, 3)
in [0, 1]) over the ranks and, on rank 0, over a local mesh of its device
N times, to `--out`_rank{r}.npz (`step` with `--frames` runs it after its
window, to `--out`_infer); `step --also-remat K` runs its window again with
`remat=K` to `--out`_remat; `step_val` adds, after its other runs,
the window on that mesh to `--out`_ranks and rank 0's window on a local
(1, N) mesh of its device N times from the same state and rows to
`--out`_local, and, after the val, `infer` with the val's state to
`--out`_infer. `--rows K` takes the first K rows of each global batch
for those windows (all by default). `--group-timeout S` is the group's
collective timeout (a rank that waits longer on a mismatched collective
fails instead of hanging).

Two ranks on one card need `--device cuda:0 --backend gloo` (NCCL refuses
two ranks on one GPU); on the CPU `--device cpu` (gloo).

    python -m dedark_yolo_tpu_torch.tools.dist_probe step --model \\
        yolov8l.yaml --imgsz 128 --batches b.npz --steps 1500 --out out

`window_errors` holds a window of the ranks against one process's
(`one_window`) leaf by leaf in TRAIN_TOL's terms (`chip_smoke.py`'s dist
phase). `split` (run in the parent process, no group of its own) splits
that difference: the flagship's window at 128 on two gloo ranks (b2 each,
BN's moments all-reduced in flax's E[x^2] - E[x]^2 form), on one rank with
BN forced through the same group form (`--bn-global`, b4), and in one
process without a group (b4, `F.batch_norm`'s variance), each pair's
errors printed as one JSON line:

    python -m dedark_yolo_tpu_torch.tools.dist_probe split --out /tmp/split
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BATCH_KEYS = ("img", "cls", "bboxes", "mask_gt")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n, argv, timeout=600, threads=2, env=None,
           target=("-m", "dedark_yolo_tpu_torch.tools.dist_probe")):
    """Run n ranks of `target` (this module, or a script path) with `argv`;
    returns [(returncode, output)] in rank order. A rank past `timeout`
    seconds is killed with the others and its code is None."""
    port = str(free_port())
    procs = []
    for r in range(n):
        e = {**os.environ, **(env or {}), "WORLD_SIZE": str(n),
             "RANK": str(r), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
             "OMP_NUM_THREADS": str(threads),
             "PYTHONPATH": os.pathsep.join(
                 [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        procs.append(subprocess.Popen(
            [sys.executable, *target, *map(str, argv)], cwd=str(ROOT),
            env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, o))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs[len(out):]:
            o, _ = p.communicate()
            out.append((None, o))
    return out


def save_batches(path, batches):
    """Write global batches (a list of the loader's dicts) for `step`."""
    np.savez(path, **{f"{k}_{i}": b[k] for i, b in enumerate(batches)
                      for k in BATCH_KEYS})


def _rows(batch, mesh, rows=0):
    """This rank's data coordinate's rows of the global batch (of its
    first `rows` rows, where given)."""
    if rows:
        batch = {k: v[:rows] for k, v in batch.items()}
    per = batch["img"].shape[0] // mesh.data_size
    i = mesh.data_index
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


# {(model, nc, seed, device): (facade, its state as built)}: the runs of one
# launch build each model once and start each from its state as built
_BUILT: dict = {}


def _model(a, mesh):
    """The facade of `--model` (seeded, or an .npz checkpoint) on the
    rank's device, with `--state`'s state dict when one is given."""
    import torch
    from ..engine.model import YOLO
    spec = str(a.model)
    key = (spec, a.nc, a.seed, str(a.device))
    if key not in _BUILT:
        yolo = (YOLO(spec, device=a.device) if spec.endswith(".npz")
                else YOLO(spec, nc=a.nc, device=a.device, seed=a.seed))
        _BUILT[key] = (yolo, {k: v.clone() for k, v in
                              yolo.model.state_dict().items()})
    yolo, built = _BUILT[key]
    yolo.model.load_state_dict(built)
    if a.state:
        with np.load(a.state) as z:
            yolo.model.load_state_dict({k: torch.from_numpy(z[k])
                                        for k in z.files})
        yolo.model.to(mesh.device)
    return yolo


def run_step(a, mesh):
    import torch
    from ..engine.trainer import DetectionTrainer
    from ..ops import _build
    model = _model(a, mesh).model
    if getattr(a, "ulp", False):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    over = json.loads(a.overrides)
    tr = DetectionTrainer(over, model=model, nb=a.nb, device=mesh.device)
    tr.mesh = mesh
    if a.bn_global:     # the group's forms even at one rank (split only)
        DetectionTrainer.group = property(
            lambda self: torch.distributed.group.WORLD)
    with np.load(a.batches) as z:
        n = len({f.rsplit("_", 1)[1] for f in z.files})
        batches = [{k: z[f"{k}_{i}"] for k in BATCH_KEYS} for i in range(n)]
    steps = [int(s) for s in a.steps.split(",")]
    for v in _build.LAUNCHES:
        _build.LAUNCHES[v] = 0
    out = {}
    for j, (i, batch) in enumerate(zip(steps, batches)):
        total, items = tr.step(_rows(batch, mesh, a.rows), i)
        out[f"total_{j}"] = total.cpu().numpy()
        out[f"items_{j}"] = items.cpu().numpy()
    for k, v in tr.model.state_dict().items():
        out[f"state/{k}"] = v.cpu().numpy()
    for k, v in tr.ema.items():
        out[f"ema/{k}"] = v.cpu().numpy()
    for k, v in tr.opt_state.buf.items():
        out[f"buf/{k}"] = v.cpu().numpy()
    for k, v in tr.opt_state.buf2.items():
        out[f"buf2/{k}"] = v.cpu().numpy()
    out["counts"] = np.asarray([tr.opt_state.step, tr.opt_state.micro,
                                tr.ema_updates])
    out["launches"] = np.asarray(json.dumps(dict(_build.LAUNCHES)))
    np.savez(f"{a.out}_rank{mesh.rank}.npz", **out)


def one_window(model, batch, imgsz, step, nb, device):
    """One process's SGD window of the seeded `model` on the whole `batch`
    (nbs = its rows, so one micro-step applies the update), TF32 off:
    ({items, state, ema, buf} on the CPU, the start state on the CPU)."""
    from ..engine.model import YOLO
    from ..engine.predictor import matmul_precision
    from ..engine.trainer import DetectionTrainer
    yolo = YOLO(model, nc=3, device=device, seed=0)
    cpu = lambda sd: {k: v.detach().cpu().clone() for k, v in sd.items()}
    start = cpu(yolo.model.state_dict())
    n = batch["img"].shape[0]
    tr = DetectionTrainer(
        {"batch": n, "nbs": n, "optimizer": "SGD", "imgsz": imgsz},
        model=yolo.model, nb=nb, device=device)
    with matmul_precision("float32"):
        _, items = tr.step(batch, step)
    return ({"items": items.cpu(), "state": cpu(tr.model.state_dict()),
             "ema": cpu(tr.ema), "buf": cpu(tr.opt_state.buf)}, start)


def as_window(z):
    """A rank's `step` npz as `one_window`'s record (its first items)."""
    import torch
    return {"items": torch.from_numpy(np.asarray(z["items_0"])),
            **{sec: {k[len(sec) + 1:]: torch.from_numpy(np.asarray(v))
                     for k, v in z.items() if k.startswith(sec + "/")}
               for sec in ("state", "ema", "buf")}}


def window_errors(two, one, start):
    """A rank's window (`two`: its `step` npz) against one process's
    (`one_window`) from `start`, leaf by leaf in TRAIN_TOL's terms: the
    items; each momentum buffer (the first step's gradient plus decay) by
    its norm; each parameter's and EMA entry's move against its tensor's
    largest move; BN stats and their EMA absolute. Each leaf that misses
    is listed."""
    import torch
    from .c14_split import TRAIN_TOL
    t = lambda k: torch.from_numpy(np.asarray(two[k]))
    items_rel = float((t("items_0") - one["items"]).abs().max()
                      / one["items"].abs().max())
    miss, worst = [], {"grad": (0.0, ""), "move": (0.0, ""),
                       "stats": (0.0, "")}

    def note(kind, err, name, bar):
        if err > worst[kind][0]:
            worst[kind] = (err, name)
        if err > bar:
            miss.append({"leaf": name, "kind": kind, "err": err})
    for k, w in one["buf"].items():
        if w.abs().max() > 0:
            note("grad", float(torch.linalg.vector_norm(t(f"buf/{k}") - w)
                               / torch.linalg.vector_norm(w)), k,
                 TRAIN_TOL["grad_rel"])
    for k, w in one["state"].items():
        err = max(float((t(f"state/{k}") - w).abs().max()),
                  float((t(f"ema/{k}") - one["ema"][k]).abs().max()))
        if "running_" in k:
            note("stats", err, k, TRAIN_TOL["stats_abs"])
            continue
        moved = float((w - start[k]).abs().max())
        rel = ((err - 1e-6) / moved if moved
               else (0.0 if err <= 1e-6 else float("inf")))
        note("move", rel, k, TRAIN_TOL["move_rel"])
    if items_rel > TRAIN_TOL["items_rel"]:
        miss.append({"leaf": "items", "kind": "items", "err": items_rel})
    return {"items_two": t("items_0").tolist(),
            "items_one": one["items"].tolist(),
            "items_max_rel_err": items_rel,
            "grad_norm_rel_err": worst["grad"][0],
            "grad_worst_leaf": worst["grad"][1],
            "move_max_rel_err": worst["move"][0],
            "move_worst": worst["move"][1],
            "bn_stats_and_ema_max_abs_err": worst["stats"][0],
            "misses": miss, "tol": TRAIN_TOL}


def split(out, device="cuda:0", imgsz=128, ranks=2, per=2, step=1500,
          nb=1000):
    """The flagship's window on `ranks` gloo ranks, on one rank in the
    group's BN form and in one process, pair by pair (see the module
    docstring); a list of records."""
    from .c14_split import train_batch
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    batch = train_batch(ranks * per, imgsz, 0)
    save_batches(out / "batches.npz", [batch])
    runs = {}
    for name, n, extra in (("two_ranks", ranks, []),
                           ("one_rank_group_form", 1, ["--bn-global"])):
        b = per * ranks // n
        res = launch(n, ["step", "--model", "yolov8l.yaml", "--imgsz", imgsz,
                         "--batches", out / "batches.npz", "--steps", step,
                         "--nb", nb, "--device", device, "--backend", "gloo",
                         "--overrides", json.dumps({
                             "batch": b, "nbs": b, "optimizer": "SGD",
                             "imgsz": imgsz}), "--out", out / name, *extra],
                     timeout=600)
        for r, (rc, text) in enumerate(res):
            if rc != 0:
                raise RuntimeError(f"{name} rank {r} ({rc}):\n{text[-3000:]}")
        runs[name] = dict(np.load(out / f"{name}_rank0.npz"))
    one, start = one_window("yolov8l.yaml", batch, imgsz, step, nb,
                            device.split(":")[0])
    return [{"pair": "two_ranks vs one_process",
             **window_errors(runs["two_ranks"], one, start)},
            {"pair": "two_ranks vs one_rank_group_form",
             **window_errors(runs["two_ranks"],
                             as_window(runs["one_rank_group_form"]), start)},
            {"pair": "one_rank_group_form vs one_process",
             **window_errors(runs["one_rank_group_form"], one, start)}]


def run_infer(a, mesh, ranks):
    """`spatial_infer` of `--frames` over the rank-spanning mesh `ranks`
    and, on rank 0, over a local mesh of its device as many times: each
    output and its launches to `--out`_rank{r}.npz."""
    import torch
    from ..ops import _build
    from ..parallel.mesh import local_mesh
    from ..parallel.spatial import spatial_infer
    model = _model(a, mesh).model.to(mesh.device)
    with np.load(a.frames) as z:
        img = torch.from_numpy(z["img"]).to(mesh.device)
    runs = {"ranks": ranks}
    if mesh.is_main:
        runs["local"] = local_mesh([mesh.device] * ranks.spatial,
                                   axes=("spatial",))
    out = {}
    for name, m in runs.items():
        for v in _build.LAUNCHES:
            _build.LAUNCHES[v] = 0
        boxes, scores = spatial_infer(model, img, m)
        out[f"{name}/boxes"] = boxes.cpu().numpy()
        out[f"{name}/scores"] = scores.cpu().numpy()
        out[f"{name}/launches"] = np.asarray(json.dumps(dict(_build.LAUNCHES)))
    np.savez(f"{a.out}_rank{mesh.rank}.npz", **out)


def run_val(a, mesh):
    from ..cfg import get_cfg
    from ..engine.validator import DetectionValidator
    from ..ops import _build
    yolo = _model(a, mesh)
    data = (json.loads(Path(a.data).read_text()) if a.data.endswith(".json")
            else a.data)
    args = get_cfg(overrides={"data": data, "imgsz": a.imgsz, "batch": a.batch,
                    "device": str(mesh.device), "plots": False,
                    "verbose": False, "workers": 2, "cache": a.cache or False,
                    **json.loads(a.overrides)})
    for v in _build.LAUNCHES:
        _build.LAUNCHES[v] = 0
    v = DetectionValidator(args=args, save_dir=Path(a.out).parent / "val")
    res = v(model=yolo.model, mesh=mesh)
    Path(f"{a.out}_rank{mesh.rank}.json").write_text(json.dumps({
        "results": {k: float(x) for k, x in res.items()},
        "launches": dict(_build.LAUNCHES)}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenario", choices=("step", "val", "step_val", "infer",
                                         "split"))
    ap.add_argument("--model", default="yolov8l.yaml")
    ap.add_argument("--nc", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state", default="")
    ap.add_argument("--batches", default="")
    ap.add_argument("--steps", default="0")
    ap.add_argument("--nb", type=int, default=1000)
    ap.add_argument("--imgsz", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", default="")
    ap.add_argument("--cache", default="")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--bn-global", action="store_true")
    ap.add_argument("--spatial", type=int, default=1)
    ap.add_argument("--spatial-ranks", type=int, default=1)
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--frames", default="")
    ap.add_argument("--group-timeout", type=float, default=3600.0)
    ap.add_argument("--also-remat", type=int, default=-1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--val-state", default="")
    ap.add_argument("--val-imgsz", type=int, default=None)
    ap.add_argument("--val-overrides", default="{}")
    ap.add_argument("--val-out", default="")
    a = ap.parse_args(argv)
    import torch
    if a.scenario == "split":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for rec in split(a.out):
            print(json.dumps(rec), flush=True)
        return 0
    import datetime
    from ..parallel import init_from_env, make_mesh
    from ..parallel.mesh import barrier, local_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_from_env(device=a.device, backend=a.backend,
                  timeout=datetime.timedelta(seconds=a.group_timeout))
    mesh = make_mesh()
    a.device = str(mesh.device)
    spatial = (make_mesh(shape=(mesh.world, a.spatial),
                         axes=("data", "spatial"),
                         devices=[mesh.device] * a.spatial)
               if a.spatial > 1 else None)
    n = a.spatial_ranks
    ranks = (make_mesh(shape=(mesh.world // n, n), axes=("data", "spatial"))
             if n > 1 else None)
    with_ = lambda **kw: argparse.Namespace(**{**vars(a), **kw})
    if a.scenario == "step":
        run_step(a, ranks or spatial or mesh)
        if a.also_remat >= 0:
            over = {**json.loads(a.overrides), "remat": a.also_remat}
            run_step(with_(out=f"{a.out}_remat", overrides=json.dumps(over)),
                     ranks or spatial or mesh)
        if ranks is not None and a.frames:
            run_infer(with_(out=f"{a.out}_infer"), mesh, ranks)
    if a.scenario == "step_val":
        run_step(with_(rows=0), mesh)
    if a.scenario == "infer":
        run_infer(a, mesh, ranks)
    if a.scenario == "step_val":
        if spatial is not None:
            run_step(with_(out=f"{a.out}_spatial", rows=0), spatial)
            run_step(with_(out=f"{a.out}_ulp", ulp=True, rows=0), mesh)
        if ranks is not None:
            run_step(with_(out=f"{a.out}_ranks"), ranks)
            if mesh.is_main:      # the same rows' window on local slabs
                run_step(with_(out=f"{a.out}_local"), local_mesh(
                    [mesh.device] * n, (1, n), ("data", "spatial")))
        a = with_(state=a.val_state, out=a.val_out, overrides=a.val_overrides,
                  imgsz=a.val_imgsz or a.imgsz, scenario="val")
    if a.scenario == "val":
        run_val(a, mesh)
        if spatial is not None:
            if mesh.is_main:      # rank 0's val over its own devices
                run_val(with_(out=f"{a.out}_local"),
                        local_mesh(spatial.devices))
        if ranks is not None and a.frames:
            run_infer(with_(out=f"{a.out}_infer"), mesh, ranks)
    # every rank's collectives done before any rank tears the group down
    barrier(mesh)
    torch.distributed.destroy_process_group()
    print(f"rank {mesh.rank} of {mesh.world} done on {mesh.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
