"""Torch port vs the JAX package: validation and the train loop over two
gloo ranks (CPU).

A two-rank `DetectionValidator(mesh=)` (tools/dist_probe.py's `val`, each
rank its rows of every batch, rank 0 gathering the images' stats in image
order) of tests/test_torch_val.py's tiny model and weights on a
tests/synth.py dataset of 7 val images at imgsz 96, batch 4 (the second
batch of 3 does not divide over two ranks: rank 0 runs it whole, as JAX
shards only a batch that divides): its results equal the one-process
port's and JAX's `validator(mesh=make_mesh(shape=(2,)))`'s within
test_torch_val.py's METRIC_TOL, and both ranks return the same results.

The two-rank train loop (the port of JAX tests/test_distributed.py): one
launch through `python -m torch.distributed.run -m dedark_yolo_tpu_torch
train ... mesh_shape=[2]` (two epochs on 8 images at 64, b2 a rank), then
the same run stopped after epoch 0 by a flag on rank 1 alone (the stop is
an OR over the ranks) and resumed in a fresh launch: both ranks exit 0,
only rank 0 wrote the run's files (one results.csv row an epoch), and the
resumed last.npz equals the uninterrupted one bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine import validator as jax_validator  # noqa: E402
from dedark_yolo_tpu.parallel import make_mesh as jax_mesh  # noqa: E402

from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.tools.dist_probe import free_port, launch  # noqa: E402
from dedark_yolo_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_torch_val import (IMGSZ, METRIC_TOL, RESULT_KEYS, TINY,  # noqa: E402
                            tiny_variables)
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKER = str(HERE / "torch_dist_worker.py")
TIMEOUT = 240


def _ok(res):
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} ({rc}):\n{text[-3000:]}"


def test_two_rank_val_equals_one_process_and_jax(tmp_path):
    data = make_synth_dataset(tmp_path / "ds", n_train=0, n_val=7,
                              imgsz=IMGSZ)
    jm, v = tiny_variables()
    kw = {"data": str(data), "imgsz": IMGSZ, "batch": 4, "workers": 2,
          "plots": False, "verbose": False}
    want = jax_validator.DetectionValidator(
        args=jax_get_cfg(DEFAULT_CFG_DICT, kw), save_dir=tmp_path / "jax")(
        model=jm, params=v["params"], batch_stats=v["batch_stats"],
        mesh=jax_mesh(shape=(2,)))
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    sd = state_dict_from_jax(v, tm)
    tm.load_state_dict(sd, strict=True)
    one = validator.DetectionValidator(
        args=get_cfg(overrides={**kw, "device": "cpu"}), save_dir=tmp_path / "one")(
        model=tm)
    np.savez(tmp_path / "state.npz", **{k: t.numpy() for k, t in sd.items()})
    _ok(launch(2, ["val", "--model", TINY, "--state", tmp_path / "state.npz",
                   "--data", data, "--imgsz", IMGSZ, "--batch", 4,
                   "--device", "cpu", "--out", tmp_path / "two"],
               timeout=TIMEOUT))
    two = [json.loads((tmp_path / f"two_rank{r}.json").read_text())
           for r in range(2)]
    assert two[0] == two[1]
    got = two[0]["results"]
    assert set(got) == set(one) == set(want) == set(RESULT_KEYS)
    for k in RESULT_KEYS:
        assert abs(got[k] - float(one[k])) <= METRIC_TOL, k
        assert abs(got[k] - float(want[k])) <= METRIC_TOL, k
    assert float(one["metrics/recall(B)"]) > 0


def _torchrun(data, out):
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(ROOT)] + [
               p for p in [os.environ.get("PYTHONPATH")] if p])}
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
         "-m", "dedark_yolo_tpu_torch", "train", f"model={TINY}",
         f"data={data}", "device=cpu", "mesh_shape=[2]", "epochs=2",
         "imgsz=64", "batch=2", "workers=1", "plots=False", f"project={out}",
         "name=dist", "exist_ok=True", "max_boxes=8", "max_nms=64",
         "max_det=10"], cwd=str(out), env=env, capture_output=True,
        text=True, timeout=TIMEOUT)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return p.stdout


def test_two_rank_train_and_resume(tmp_path):
    data = make_synth_dataset(tmp_path / "ds", n_train=8, n_val=4, imgsz=64)
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()
    text = _torchrun(data, full)
    # each rank printed the CLI's results line; rank 0's holds the metrics
    lines = [ln for ln in text.splitlines() if ln.startswith("results ")]
    assert len(lines) == 2 and any("fitness" in ln for ln in lines)
    run = full / "dist"
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                   if p.is_file())
    assert files == ["args.yaml", "metrics.jsonl", "results.csv",
                     "weights/best.npz", "weights/last.npz"]
    assert len((run / "results.csv").read_text().splitlines()) == 3
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2

    _ok(launch(2, ["train", data, part, "interrupt"], timeout=TIMEOUT,
               target=(WORKER,)))
    meta, _ = load_checkpoint(part / "dist" / "weights" / "last.npz")
    assert meta["epoch"] == 0
    _ok(launch(2, ["train", data, part, "resume"], timeout=TIMEOUT,
               target=(WORKER,)))
    done = [json.loads((part / f"done_resume_rank{r}.json").read_text())
            for r in range(2)]
    assert [d["epoch"] for d in done] == [1, 1]
    assert done[1]["metrics"] == {}           # rank 0 validates alone
    meta_a, a = load_checkpoint(run / "weights" / "last.npz")
    meta_b, b = load_checkpoint(part / "dist" / "weights" / "last.npz")
    assert meta_a["epoch"] == meta_b["epoch"] == 1
    assert meta_a["updates"] == meta_b["updates"]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len((part / "dist" / "results.csv").read_text().splitlines()) == 3
