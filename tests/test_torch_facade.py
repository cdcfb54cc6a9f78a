"""Torch port vs the JAX package: the rest of the YOLO facade, the tuner and
the port's `perform.py`, on the CPU.

`load()` of a checkpoint of another nc transfers the same counts as the
JAX facade's, `info()` counts the same parameters (the tiny model and the
flagship), the tuner draws the same candidates from the same seed, and the
port's `perform.predict` and `calculate_detection_metrics` give what the
root `perform.py` gives on the same .npz and dataset (the results dict
within METRIC_TOL, the bar of tests/test_torch_val.py; the rates equal).
The root script is imported here only: the port never imports it.
"""

import json
import logging
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils import tuner as jax_tuner  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import perform  # noqa: E402
from dedark_yolo_tpu_torch.utils import tuner  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from synth import make_synth_dataset  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_val import tiny_variables  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import perform as root_perform  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ = 96
METRIC_TOL = 1e-6
VAL = {"workers": 2, "plots": False, "verbose": False}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A dataset of 6 val images, a .npz of the tiny model at nc 3 and one
    at nc 5 (JAX container, numpy-drawn weights)."""
    root = tmp_path_factory.mktemp("facade")
    data = str(make_synth_dataset(root / "ds", n_train=0, n_val=6,
                                  imgsz=IMGSZ))
    jm, v = tiny_variables()
    npz = root / "tiny.npz"
    jax_save(npz, params=v["params"], batch_stats=v["batch_stats"],
             model_yaml=jm.yaml)
    jm5 = JaxModel(jax_yaml_load(TINY), nc=5)
    t5 = jax.eval_shape(jm5.module.init, jax.random.PRNGKey(0),
                        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    v5 = to_plain(randomize(t5, np.random.default_rng(5)))
    npz5 = root / "tiny_nc5.npz"
    jax_save(npz5, params=v5["params"], batch_stats=v5["batch_stats"],
             model_yaml=jm5.yaml)
    return root, data, str(npz), str(npz5)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(logger_name, fn):
    h = _Records()
    log = logging.getLogger(logger_name)
    log.addHandler(h)
    try:
        fn()
    finally:
        log.removeHandler(h)
    return h.lines


def test_load_transfers_the_same_counts_as_jax(setup):
    _, _, npz, npz5 = setup
    want = [ln for ln in _logged("dedark_yolo_tpu",
                                 lambda: JaxYOLO(npz).load(npz5))
            if ln.startswith("transferred")]
    m = YOLO(TINY, device="cpu")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    got = [ln for ln in _logged("dedark_yolo_tpu_torch",
                                lambda: m.load(npz5))
           if ln.startswith("transferred")]
    assert got == want and len(got) == 1
    n, total = map(int, got[0].split()[1].split("/"))
    assert 0 < n < total
    src = YOLO(npz5, device="cpu").state_dict()
    kept = [k for k, v in m.state_dict().items()
            if torch.equal(v, before[k]) and not torch.equal(v, src[k])]
    assert len(kept) == total - n    # the head entries of the other nc


def test_info_counts_the_jax_parameters(setup):
    _, _, npz, _ = setup
    assert YOLO(npz, device="cpu").info() == JaxYOLO(npz).info()
    jm = JaxModel(jax_yaml_load("yolov8l.yaml"), nc=3)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = jm.num_params(shapes)
    layers, n = YOLO("yolov8l.yaml", nc=3, device="cpu").info()
    assert n == want and layers == len(jm.specs)


def test_reset_weights_differs_each_time():
    m = YOLO(TINY, device="cpu")
    seen = [{k: v.clone() for k, v in m.state_dict().items()}]
    for _ in range(2):
        m.reset_weights()
        seen.append({k: v.clone() for k, v in m.state_dict().items()})
    key = "model.1.conv.weight"
    for i in range(3):
        for j in range(i):
            assert not torch.equal(seen[i][key], seen[j][key])
    fresh = YOLO(TINY, device="cpu").state_dict()
    assert torch.equal(fresh[key], seen[0][key])


def test_small_members(setup, tmp_path):
    _, _, npz, _ = setup
    m = YOLO(npz, device="cpu")
    assert m.fuse() is m and m.transforms is None
    assert m.names == {0: "0", 1: "1", 2: "2"}
    assert m.to("cpu") is m and m.device == torch.device("cpu")
    m.add_callback("on_train_start", print)
    m.clear_callback("on_train_start")
    assert m._user_callbacks["on_train_start"] == []
    frame = np.random.default_rng(0).integers(0, 256, (80, 96, 3), np.uint8)
    called = m(frame, imgsz=IMGSZ, max_nms=256, max_det=20)
    assert m.predictor.args.conf == 0.4
    np.save(tmp_path / "f.npy", frame)
    again = m.predict(str(tmp_path), imgsz=IMGSZ, conf=0.4, max_nms=256,
                      max_det=20)
    np.testing.assert_array_equal(called[0].boxes.data, again[0].boxes.data)


def test_tuner_draws_the_jax_candidates(monkeypatch, tmp_path):
    """Same seed, same fitness: both tuners propose the same configs in the
    same order; the port writes them to its results file."""
    def fake(calls):
        class Fake:
            def __init__(self, *a, **k):
                pass

            def train(self, data=None, epochs=None, name=None, exist_ok=None,
                      **cfg):
                calls.append({k: cfg[k] for k in tuner.DEFAULT_SPACE})
                lo, hi = tuner.DEFAULT_SPACE["lr0"]
                return {"fitness": (cfg["lr0"] - lo) / (hi - lo)}
        return Fake

    import dedark_yolo_tpu.engine.model as jax_em
    import dedark_yolo_tpu_torch.engine.model as em
    want, got = [], []
    monkeypatch.setattr(jax_em, "YOLO", fake(want))
    monkeypatch.setattr(em, "YOLO", fake(got))
    jbest, jres = jax_tuner.run_tune("m.yaml", "d.yaml", trials=8, seed=3)
    out = tmp_path / "tune.json"
    best, res = tuner.run_tune("m.yaml", "d.yaml", trials=8, seed=3,
                               results_file=out)
    assert got == want and len(got) == 8
    assert best == jbest and [r["fitness"] for r in res] == \
        [r["fitness"] for r in jres]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert tuner.DEFAULT_SPACE == jax_tuner.DEFAULT_SPACE
    rng, jrng = random.Random(0), random.Random(0)
    parent = tuner.sample(tuner.DEFAULT_SPACE, rng)
    jax_tuner._sample(jax_tuner.DEFAULT_SPACE, jrng)
    assert tuner.mutate(parent, tuner.DEFAULT_SPACE, rng) == \
        jax_tuner._mutate(parent, jax_tuner.DEFAULT_SPACE, jrng)


def test_yolo_tune_runs_trials(setup, monkeypatch):
    _, data, npz, _ = setup
    seen = []
    import dedark_yolo_tpu_torch.utils.tuner as T
    monkeypatch.setattr(T, "run_tune",
                        lambda model, data, **kw: seen.append((model, data, kw))
                        or ("best", []))
    assert YOLO(npz, device="cpu").tune(data=data, trials=2) == ("best", [])
    assert seen == [(npz, data, {"trials": 2})]


def test_perform_predict_equals_root(setup):
    _, data, npz, _ = setup
    want = root_perform.predict(npz, data, imgsz=IMGSZ, batch=4, **VAL)
    got = perform.predict(npz, data, imgsz=IMGSZ, batch=4, device="cpu", **VAL)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= METRIC_TOL, k
    assert got["metrics/mAP50(B)"] > 0


def test_perform_detection_rates_equal_root(setup, tmp_path):
    _, data, npz, _ = setup
    kw = {"max_nms": 2048, "max_det": 300, "workers": 2}
    want = root_perform.calculate_detection_metrics(
        npz, data, imgsz=IMGSZ, batch=4, save_dir=str(tmp_path / "j"), **kw)
    got = perform.calculate_detection_metrics(
        npz, data, imgsz=IMGSZ, batch=4, save_dir=str(tmp_path / "t"),
        device="cpu", **kw)
    assert got == want and len(got) == 3


def test_perform_flops_params_and_unported(setup):
    _, _, npz, _ = setup
    n, flops = perform.flops_params(npz, imgsz=64, device="cpu")
    assert n == JaxYOLO(npz).info()[1] and flops > 1e6
    with pytest.raises(RuntimeError, match="'onnx' package"):
        perform.onnx(npz, imgsz=64, fmt="onnx", device="cpu")
