"""The port's AutoBackend (dedark_yolo_tpu_torch/engine/autobackend.py) and
what an exported artifact unblocks, on the CPU: tests/tiny_model.yaml at
imgsz 64 from one JAX checkpoint of seeded weights, exported once at batch
3 in f32 and once in half.

- AutoBackend(pt2) against its live branch AutoBackend(npz), at f32 and at
  half (bf16 parameters through the benchmark's functional_call route),
  bit for bit: the program is the live model's function.
- `YOLO(pt2).predict` against the live predict, `YOLO(pt2).val` at the
  artifact's batch 3 over 4 images (the last batch padded) against the
  live val, image by image (tests/pairing.py) at val's bars with the
  metrics within METRIC_TOL, and with save_hybrid; `InferenceServer(pt2)` answering like
  predict; `benchmark(formats=)` rows.
- The artifact's rules: its imgsz and batch win, train and export raise,
  augment/save_enhanced/visualize are ignored with a warning, no card
  without device='cpu' raises.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.engine.server import InferenceServer  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired  # noqa: E402
from synth import make_synth_dataset  # noqa: E402
from test_torch_val import (BOX_TOL_PX, METRIC_TOL, RESULT_KEYS,  # noqa: E402
                            SCORE_TOL, record_matches, tiny_variables)

IMGSZ, BATCH = 64, 3
NAMES = {0: "car", 1: "bus", 2: "train"}
PREDICT = dict(conf=0.02, max_det=40, max_nms=256, device="cpu")
VAL = dict(imgsz=IMGSZ, batch=BATCH, device="cpu", plots=False, workers=0,
           verbose=False)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """{"npz", "pt2", "pt2_half"}: the checkpoint and its two artifacts."""
    root = tmp_path_factory.mktemp("autobackend")
    jm, v = tiny_variables(seed=0)
    npz = str(save_checkpoint(
        root / "tiny.npz", params=v["params"], batch_stats=v["batch_stats"],
        train_args={"imgsz": IMGSZ, "names": NAMES}, model_yaml=jm.yaml))
    y = YOLO(npz, device="cpu")
    out = {"npz": npz}
    for key, half in (("pt2", False), ("pt2_half", True)):
        out[key] = y.export(format="pt2", imgsz=IMGSZ, batch=BATCH,
                            half=half, device="cpu", project=str(root / key))
    out["data"] = str(make_synth_dataset(root / "ds", n_train=0, n_val=4,
                                         imgsz=IMGSZ))
    return out


@pytest.fixture(scope="module")
def frames():
    """Five low-light BGR frames of other sizes than the letterbox's: a
    full batch of 3 and a short one."""
    rng = np.random.default_rng(7)
    return [(rng.uniform(0, 1, (h, w, 3)) ** 2 * 255).astype(np.uint8)
            for h, w in ((60, 80), (64, 64), (50, 70), (90, 60), (61, 77))]


def images(seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)


@pytest.mark.parametrize("half", [False, True])
def test_pt2_equals_live_branch(art, half):
    pt2 = AutoBackend(art["pt2_half" if half else "pt2"], device="cpu")
    live = AutoBackend(art["npz"], half=half, device="cpu")
    assert (pt2.format, live.format) == ("pt2", "checkpoint")
    assert (pt2.imgsz, pt2.batch, pt2.nc, pt2.task, pt2.names) == \
        (IMGSZ, BATCH, 3, "detect", NAMES)
    assert live.names == NAMES and live.nc == 3
    u8 = images()
    for got, want in zip(pt2(u8), live(torch.from_numpy(u8))):
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want)
    assert pt2.warmup() is pt2


def test_no_card_raises(art):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoBackend(art["pt2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO(art["pt2"]).predict(np.zeros((8, 8, 3), np.uint8))


def test_predict_pt2_equals_live(art, frames, caplog):
    live = YOLO(art["npz"], device="cpu").predict(
        frames, imgsz=IMGSZ, batch=BATCH, **PREDICT)
    y = YOLO(art["pt2"], device="cpu")
    assert y.names == NAMES
    with caplog.at_level("WARNING", logger="dedark_yolo_tpu_torch"):
        got = y.predict(frames, imgsz=128, batch=1, augment=True,
                        save_enhanced=True, visualize=True, **PREDICT)
    for key in ("augment", "save_enhanced", "visualize"):
        assert f"{key}=True is ignored for exported artifacts" in caplog.text
    a = y.predictor.args
    assert (a.imgsz, a.batch) == (IMGSZ, BATCH)     # the artifact's win
    assert sum(len(r) for r in live) > 0
    for g, w in zip(got, live):
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
        assert g.enhanced_img is None and g.features is None
    assert g.names == NAMES


@pytest.mark.parametrize("hybrid", [False, True])
def test_val_pt2_paired_with_live(art, monkeypatch, hybrid):
    kw = dict(VAL, data=art["data"], save_hybrid=hybrid)
    rec_live = record_matches(monkeypatch, validator)
    want = YOLO(art["npz"], device="cpu").val(**kw)
    monkeypatch.undo()
    rec_art = record_matches(monkeypatch, validator)
    y = YOLO(art["pt2"], device="cpu")
    got = y.val(**{**kw, "batch": 2, "rect": True})
    assert (y.validator.args.batch, y.validator.args.rect) == (BATCH, False)
    assert len(rec_live) == len(rec_art) == 4
    for i, (w, g) in enumerate(zip(rec_live.detections(),
                                   rec_art.detections())):
        # the padded last batch runs the convolutions at batch 3, the
        # live one at 1: last-bit differences, within val's bars
        assert_paired(w, g, BOX_TOL_PX, SCORE_TOL, f"image {i}")
    for k in RESULT_KEYS:
        assert abs(got[k] - want[k]) <= METRIC_TOL, k
    if hybrid:
        assert float(got["metrics/recall(B)"]) == 1.0


def test_serve_pt2_answers_like_predict(art, frames):
    kw = {k: v for k, v in PREDICT.items() if k != "device"}
    want = YOLO(art["pt2"], device="cpu").predict(frames, **PREDICT)
    s = InferenceServer(art["pt2"], imgsz=128, max_batch=8, max_wait_ms=400,
                        device="cpu", **kw)
    try:
        assert (s.imgsz, s.max_batch, s.names) == (IMGSZ, BATCH, NAMES)
        got = []
        for i in range(0, len(frames), BATCH):
            futs = [s.submit(f) for f in frames[i:i + BATCH]]
            got += [f.result(timeout=120) for f in futs]
    finally:
        s.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["boxes"], w.boxes.data)
        assert g["names"] == NAMES


def test_benchmark_formats_rows(art, tmp_path):
    y = YOLO(art["npz"], device="cpu")
    rows = y.benchmark(formats=True, imgsz=IMGSZ, batch=2, iters=1,
                       data=art["data"], export_dir=str(tmp_path),
                       plots=False, workers=0, verbose=False, device="cpu")
    assert [r["format"] for r in rows] == ["live", "pt2", "tflite",
                                           "saved_model"]
    live, pt2, *rest = rows
    assert set(live) == set(pt2) == {"format", "size_mb", "img_per_sec",
                                     "mAP50-95"}
    assert live["size_mb"] is None and pt2["size_mb"] > 0
    assert pt2["mAP50-95"] == live["mAP50-95"]
    assert (tmp_path / "pt2" / "model.pt2").is_file()
    for r in rest:
        assert set(r) == {"format", "error"} and "JAX package" in r["error"]
    rows = y.benchmark(formats=["pt2"], imgsz=IMGSZ, batch=2, iters=1,
                       device="cpu")
    assert [r["format"] for r in rows] == ["pt2"] and "error" not in rows[0]
    with pytest.raises(ValueError, match="live model"):
        YOLO(art["pt2"], device="cpu").benchmark(formats=True)


def test_artifact_facade_needs_live_weights_for_train_and_export(art,
                                                                 tmp_path):
    y = YOLO(art["pt2"], device="cpu")
    for call in (lambda: y.train(data=art["data"], device="cpu"),
                 lambda: y.export(format="pt2", device="cpu"),
                 lambda: y.benchmark(device="cpu")):
        with pytest.raises(ValueError, match="live weights"):
            call()
    with pytest.raises(ValueError, match="unrecognized model format"):
        AutoBackend(str(Path(art["pt2"]).with_suffix(".onnx")), device="cpu")
