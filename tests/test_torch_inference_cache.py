"""Caches of device tensors must not hand inference tensors to autograd
(ROADMAP C10).

`nn/enhance._blur_matrix`, `ops/anchors._anchors_on` and
`ops/enhance_kernel.gaussian_taps` keep one tensor per shape and device.
Predict and val run under `torch.inference_mode()`; had a cache built its
tensor there, a later train step at the same image side would get an
inference tensor back, and its backward would raise "Inference tensors
cannot be saved for backward". The sequence runs in fresh processes, so that
no earlier test file fills the caches first: predict and val of the tiny
model at imgsz 64, then one `DetectionTrainer.step` at 64, against the step
alone. The two steps' loss items must be equal bit for bit (same process
image, same seeds, same threads).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
IMGSZ = 64

SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from dedark_yolo_tpu_torch import YOLO
from dedark_yolo_tpu_torch.cfg import model_yaml_load
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer
from dedark_yolo_tpu_torch.nn.graph import DetectionModel
from dedark_yolo_tpu_torch.utils.weights import init_weights

tiny, data, imgsz, first = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
rng = np.random.default_rng(0)
if first == "predict_val":
    m = YOLO(tiny, device="cpu", seed=1)
    frames = [rng.integers(0, 256, (imgsz, imgsz, 3), np.uint8) for _ in range(2)]
    m.predict(frames, device="cpu", imgsz=imgsz, batch=2, conf=0.001,
              max_det=20, max_nms=256)
    m.val(data=data, device="cpu", imgsz=imgsz, batch=2, workers=0,
          max_det=20, max_nms=256, plots=False)
net = DetectionModel(model_yaml_load(tiny), nc=3)
init_weights(net, 0)
tr = DetectionTrainer(
    {"batch": 2, "nbs": 4, "imgsz": imgsz, "prior_mode": "computed"},
    model=net, nb=10, device="cpu")
rng = np.random.default_rng(7)
batch = {"img": rng.integers(0, 256, (2, imgsz, imgsz, 3), np.uint8),
         "cls": rng.integers(0, 3, (2, 4)).astype(np.float32),
         "bboxes": rng.uniform(0.2, 0.6, (2, 4, 4)).astype(np.float32),
         "mask_gt": np.ones((2, 4), np.float32)}
total, items = tr.step(batch, 0)
print(json.dumps({"total": float(total), "items": items.tolist()}))
"""


def _run(first, data):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(TESTS), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(TESTS / "tiny_model.yaml"),
         str(data), str(IMGSZ), first],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_train_step_after_predict_and_val_in_one_process(tmp_path):
    from synth import make_synth_dataset
    data = make_synth_dataset(tmp_path / "ds", n_train=0, n_val=2,
                              imgsz=IMGSZ, seed=3)
    after = _run("predict_val", data)     # raised before the fix
    fresh = _run("none", data)
    assert after == fresh
    assert all(v == v for v in after["items"]) and after["total"] > 0
