"""Torch port vs the JAX package: the DetectionValidator, on the CPU.

The slice gate of validation: tests/tiny_model.yaml at imgsz 96 on a
tests/synth.py dataset of 6 val images of 56-135 px a side (so the loader
resizes and `scale_boxes` undoes a real letterbox), with numpy-drawn
weights that reach the port only through `state_dict_from_jax`. The DFL
logits of the box branch are biased toward the small bins, so the random
model's boxes are object-sized and some hit the labels: the TP matrices
and the mAP are not all zero. Each variant runs both validators at conf
0.001 (300 detections an image) and holds, per image in processing order:
equal detection counts and classes, boxes within BOX_TOL_PX, equal TP
matrices; then the results dict within 1e-6.

BOX_TOL_PX: the two forwards sum their convolutions in other orders; the
native-space boxes differ by at most 2.9e-5 px here (the flagship slice
gate holds 4e-4 px at imgsz 128). No IoU of these seeds lies that close to
one of the 10 thresholds, so the TP matrices are equal, and the metrics of
the results dict came out bit-equal (METRIC_TOL is the bar).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine import validator as jax_validator  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ = 96
N_VAL = 6
BOX_TOL_PX = 2e-4
METRIC_TOL = 1e-6
# with_loss: the v8 loss of the eval maps sums over every anchor in another
# order than XLA, on maps that differ in the last bits: 2.3e-7 relative at
# worst here, held to 2e-6 (the train slice holds 3e-5 after a train-mode
# forward).
LOSS_RTOL = 2e-6
RESULT_KEYS = ("metrics/precision(B)", "metrics/recall(B)",
               "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness")


def tiny_variables(seed=0):
    """Random flax trees of the tiny model, the box branch's DFL bins
    biased toward small distances (-0.5 per bin)."""
    jm = JaxModel(jax_yaml_load(TINY), nc=3)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(seed)))
    head = v["params"][f"mods_{len(jm.specs) - 1}"]
    for name, sub in head.items():
        if name.startswith("cv2_") and name.endswith("_2"):
            sub["bias"] = np.tile(-0.5 * np.arange(16, dtype=np.float32), 4)
    return jm, v


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    return make_synth_dataset(root / "ds", n_train=0, n_val=N_VAL, imgsz=IMGSZ)


@pytest.fixture(scope="module")
def weights():
    return tiny_variables()


def record_matches(monkeypatch, module):
    """Wrap `module.match_predictions`: every image's (boxes, classes, TP)."""
    rec = []
    match = module.match_predictions

    def recorded(pred_boxes, pred_cls, gt_boxes, gt_cls):
        tp = match(pred_boxes, pred_cls, gt_boxes, gt_cls)
        rec.append((np.array(pred_boxes), np.array(pred_cls), tp))
        return tp
    monkeypatch.setattr(module, "match_predictions", recorded)
    return rec


def assert_same_images(want, got):
    assert len(want) == len(got) == N_VAL
    for i, ((jb, jc, jtp), (tb, tc, ttp)) in enumerate(zip(want, got)):
        assert len(tc) == len(jc), f"image {i}: detection counts"
        np.testing.assert_array_equal(tc, jc, err_msg=f"image {i}: classes")
        np.testing.assert_allclose(tb, jb, rtol=0, atol=BOX_TOL_PX,
                                   err_msg=f"image {i}: boxes")
        np.testing.assert_array_equal(ttp, jtp, err_msg=f"image {i}: TP")


def assert_same_results(want, got, loss=False):
    keys = RESULT_KEYS + (("val/box_loss", "val/cls_loss", "val/dfl_loss")
                          if loss else ())
    assert set(got) == set(want) == set(keys)
    for k in RESULT_KEYS:
        assert abs(float(got[k]) - float(want[k])) <= METRIC_TOL, k
    for k in keys[len(RESULT_KEYS):]:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def run_both(tmp_path, monkeypatch, dataset, weights, overrides,
             with_loss=False):
    """The JAX validator and the port's on the same data and weights:
    (JAX results, port results, JAX per-image records, port records, the
    two validators)."""
    jm, v = weights
    kw = {"data": str(dataset), "imgsz": IMGSZ, "batch": 4, "workers": 2,
          "plots": False, "verbose": False, **overrides}
    jrec = record_matches(monkeypatch, jax_validator)
    trec = record_matches(monkeypatch, validator)
    jv = jax_validator.DetectionValidator(
        args=jax_get_cfg(DEFAULT_CFG_DICT, kw), save_dir=tmp_path / "jax")
    want = jv(model=jm, params=v["params"], batch_stats=v["batch_stats"],
              with_loss=with_loss)
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    tv = validator.DetectionValidator(args=get_cfg({**kw, "device": "cpu"}),
                                      save_dir=tmp_path / "torch")
    got = tv(model=tm, with_loss=with_loss)
    return want, got, jrec, trec, jv, tv


def read_txt(path):
    return [[float(x) for x in line.split()]
            for line in path.read_text().splitlines()]


def assert_same_files(jdir, tdir, overrides):
    """save_txt: the same files, the same lines; class ids equal and the
    %g-printed coordinates (and confidences) within one unit of their 6th
    significant digit (the boxes differ by up to BOX_TOL_PX). save_json:
    the same records; ids equal, bbox (3 decimals) within 1e-3 + BOX_TOL_PX
    and score (5 decimals) within 1e-5."""
    if overrides.get("save_txt"):
        jfiles = sorted(p.name for p in (jdir / "labels").glob("*.txt"))
        tfiles = sorted(p.name for p in (tdir / "labels").glob("*.txt"))
        assert jfiles == tfiles and len(tfiles) == N_VAL
        for name in jfiles:
            want = read_txt(jdir / "labels" / name)
            got = read_txt(tdir / "labels" / name)
            assert len(want) == len(got), name
            for w, g in zip(want, got):
                assert len(w) == len(g) and w[0] == g[0], name
                np.testing.assert_allclose(g[1:], w[1:], rtol=2e-6,
                                           atol=1e-6, err_msg=name)
    if overrides.get("save_json"):
        want = json.loads((jdir / "predictions.json").read_text())
        got = json.loads((tdir / "predictions.json").read_text())
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            assert (w["image_id"], w["category_id"]) == (g["image_id"],
                                                         g["category_id"])
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                       atol=1e-3 + BOX_TOL_PX)
            assert abs(g["score"] - w["score"]) <= 1e-5


@pytest.mark.parametrize("overrides,with_loss", [
    ({"save_txt": True, "save_json": True, "plots": True}, False),
    ({"rect": True}, False),
    ({"save_hybrid": True, "save_txt": True, "save_conf": True}, False),
    ({}, True),
], ids=["square_txt_json_plots", "rect", "save_hybrid", "with_loss"])
def test_validator_matches_jax(tmp_path, monkeypatch, dataset, weights,
                               overrides, with_loss):
    want, got, jrec, trec, jv, tv = run_both(
        tmp_path, monkeypatch, dataset, weights, overrides, with_loss)
    assert_same_images(jrec, trec)
    assert_same_results(want, got, loss=with_loss)
    assert sum(int(tp[:, 0].sum()) for _, _, tp in trec) > 0
    assert_same_files(tmp_path / "jax", tmp_path / "torch", overrides)
    if overrides.get("plots"):
        np.testing.assert_array_equal(tv.confusion_matrix.matrix,
                                      jv.confusion_matrix.matrix)
    if overrides.get("save_hybrid"):
        # every label came back as a detection of score 1
        assert float(got["metrics/recall(B)"]) == 1.0


def test_get_validator_and_unported_branches():
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tr = DetectionTrainer(tm, {"batch": 2}, device="cpu")
    v = tr.get_validator(save_dir="unused")
    assert v.args.conf == 0.001 and v.device.type == "cpu"
    assert v.args.batch == 2 and v.save_dir == Path("unused")
    with pytest.raises(NotImplementedError, match="AutoBackend"):
        v(model=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        v(model=tm, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validator.DetectionValidator(args=get_cfg())
