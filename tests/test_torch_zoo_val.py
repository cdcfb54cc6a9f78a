"""Torch port vs the JAX package: the AsffDetect head through the facade's
predict and val (CPU, f32), on `yolov8n-faster-twohead` (P3 and P4, one
biased 1x1 a branch).

The JAX package's own `save_checkpoint` writes the architecture with raw
`params` and different `ema` trees (seeded numpy draws, the box branch's
DFL logits biased toward small bins, as tests/test_torch_val.py does, so
boxes are object-sized and some hit the labels). `YOLO(npz)` must hold
exactly `state_dict_from_jax` of the EMA trees and the architecture of the
checkpoint's meta, and predict like the JAX facade on the same frames
(detections paired, tests/pairing.py, boxes within 4e-4 px and scores
within 1e-6, the flagship's bars). `YOLO("yolov8n-faster-twohead.yaml")`
with those weights validates like the JAX facade on a tests/synth.py
dataset, per image and by the results dict, under test_torch_val's bars.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine import validator as jax_validator  # noqa: E402
from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_results_paired  # noqa: E402
from synth import make_synth_dataset  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401
from test_torch_val import (IMGSZ, N_VAL, assert_same_images,  # noqa: E402
                            assert_same_results, record_matches)

NAME = "yolov8n-faster-twohead.yaml"
NAMES = {0: "car", 1: "bus", 2: "train"}
BOX_TOL, SCORE_TOL = 4e-4, 1e-6


def variables(jm, seed):
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(seed)))
    head = v["params"][f"mods_{len(jm.specs) - 1}"]
    for name, sub in head.items():
        if name.startswith("cv2_"):
            sub["bias"] = np.tile(-0.5 * np.arange(16, dtype=np.float32), 4)
    return v


@pytest.fixture(scope="module")
def twohead(tmp_path_factory):
    root = tmp_path_factory.mktemp("twohead")
    data = make_synth_dataset(root / "ds", n_train=0, n_val=N_VAL, imgsz=IMGSZ)
    jm = JaxModel(jax_yaml_load(NAME), nc=3)
    ema, raw = variables(jm, 0), variables(jm, 1)
    path = save_checkpoint(
        root / "twohead.npz", params=raw["params"],
        batch_stats=raw["batch_stats"], ema_params=ema["params"],
        ema_batch_stats=ema["batch_stats"], epoch=2,
        train_args={"names": NAMES, "imgsz": IMGSZ, "data": str(data)},
        model_yaml=jm.yaml)
    return str(path), ema, data, jm


def test_npz_loads_and_predicts_like_jax(twohead, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path, ema, _, jm = twohead
    y = YOLO(path, device="cpu")
    assert y.model.yaml["head"][-1][2] == "AsffDetect"
    assert tuple(y.model.strides) == (8, 16) and y.model.names == NAMES
    want_sd = state_dict_from_jax(ema, y.model)
    assert set(y.state_dict()) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(y.state_dict()[k], v), k
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)
              for _ in range(3)]
    kw = dict(imgsz=IMGSZ, batch=2, conf=0.05, iou=0.7, max_det=300)
    want = JaxYOLO(path).predict(frames, save=False, **kw)
    got = y.predict(frames, device="cpu", **kw)
    assert sum(len(r) for r in got) > 0
    assert_results_paired(want, got, BOX_TOL, SCORE_TOL)


def test_yaml_model_validates_like_jax(twohead, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # both facades default to runs/detect/val
    path, ema, data, _ = twohead
    y = YOLO(NAME, nc=3, device="cpu")
    y.load_state_dict(state_dict_from_jax(ema, y.model))
    kw = {"data": str(data), "imgsz": IMGSZ, "batch": 4, "workers": 2,
          "plots": False, "verbose": False}
    jrec = record_matches(monkeypatch, jax_validator)
    trec = record_matches(monkeypatch, validator)
    want = JaxYOLO(path).val(**kw)
    got = y.val(device="cpu", **kw)
    assert_same_images(jrec, trec)
    assert_same_results(want, got)
    assert sum(int(tp[:, 0].sum()) for _, _, tp in trec) > 0
