"""Torch port vs the JAX package: the DetectionValidator, on the CPU.

The slice gate of validation: tests/tiny_model.yaml at imgsz 96 on a
tests/synth.py dataset of 6 val images of 56-135 px a side (so the loader
resizes and `scale_boxes` undoes a real letterbox), with numpy-drawn
weights that reach the port only through `state_dict_from_jax`. The DFL
logits of the box branch are biased toward the small bins, so the random
model's boxes are object-sized and some hit the labels: the TP matrices
and the mAP are not all zero. Each variant runs both validators at conf
0.001 (300 detections an image) and holds, per image in processing order:
equal detection counts, and each port detection paired (tests/pairing.py)
with a JAX detection of the same class and TP row, its box within
BOX_TOL_PX and its score within SCORE_TOL; then the results dict within
1e-6. The pairs are not compared rank by rank: two scores that tie within
the forwards' sum-order error may leave NMS in either order, and which
order depends on the host's conv kernels (detections 242 and 243 of image
0 came out swapped on one AVX-512 host, their boxes 10.3 px apart).

BOX_TOL_PX: the two forwards sum their convolutions in other orders; the
native-space boxes differ by at most 2.9e-5 px here (the flagship slice
gate holds 4e-4 px at imgsz 128). SCORE_TOL: the scores differ by at most
6e-8 here. No IoU of these seeds lies that close to one of the 10
thresholds, so the TP matrices are equal, and the metrics of the results
dict came out bit-equal (METRIC_TOL is the bar).
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

from pairing import assert_paired, pair, reordered  # noqa: E402
from synth import make_synth_dataset  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ = 96
N_VAL = 6
BOX_TOL_PX = 2e-4
SCORE_TOL = 1e-6
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


class Recorded(list):
    """Each image the validator matched, in processing order: (boxes,
    classes, TP matrix); `scores` holds all images' scores in the same
    order, as the validator hands them to `DetMetrics.process`."""

    scores = np.zeros(0, np.float32)

    def detections(self):
        """Per image: (boxes, classes, scores, TP matrix)."""
        ends = np.cumsum([len(c) for _, c, _ in self])
        assert ends[-1] == len(self.scores), "scores and matched detections"
        return [(b, c, s, tp) for (b, c, tp), s in
                zip(self, np.split(self.scores, ends[:-1]))]


def record_matches(monkeypatch, module):
    """Wrap `module.match_predictions` (every image's boxes, classes and TP)
    and `module.DetMetrics.process` (every score)."""
    rec = Recorded()
    match, process = module.match_predictions, module.DetMetrics.process

    def recorded(pred_boxes, pred_cls, gt_boxes, gt_cls):
        tp = match(pred_boxes, pred_cls, gt_boxes, gt_cls)
        rec.append((np.array(pred_boxes), np.array(pred_cls), tp))
        return tp

    def processed(metrics, tp, conf, pred_cls, target_cls):
        rec.scores = np.array(conf)
        return process(metrics, tp, conf, pred_cls, target_cls)
    monkeypatch.setattr(module, "match_predictions", recorded)
    monkeypatch.setattr(module.DetMetrics, "process", processed)
    return rec


def assert_same_images(want, got):
    """Image by image: equal counts, every port detection paired with a JAX
    one of the same class and TP row, box within BOX_TOL_PX and score
    within SCORE_TOL. Prints how many pairs sit at another rank."""
    assert len(want) == len(got) == N_VAL
    moved, box_err, score_err = 0, 0.0, 0.0
    for i, (w, g) in enumerate(zip(want.detections(), got.detections())):
        assert len(g[1]) == len(w[1]), f"image {i}: detection counts"
        order, db, ds = assert_paired(w, g, BOX_TOL_PX, SCORE_TOL,
                                      f"image {i}")
        moved += reordered(order)
        box_err, score_err = max(box_err, db), max(score_err, ds)
    print(f"paired: {moved} pairs at another rank; box {box_err:.3g} px, "
          f"score {score_err:.3g}")


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
    tv = validator.DetectionValidator(args=get_cfg(overrides={**kw, "device": "cpu"}),
                                      save_dir=tmp_path / "torch")
    got = tv(model=tm, with_loss=with_loss)
    return want, got, jrec, trec, jv, tv


def read_txt(path):
    return [[float(x) for x in line.split()]
            for line in path.read_text().splitlines()]


def assert_same_files(jdir, tdir, overrides):
    """save_txt: the same files, each line of the port's paired (pairing.py,
    in its order) with a JAX line of the same class id and the
    %g-printed coordinates (and confidences) within one unit of their 6th
    significant digit (the boxes differ by up to BOX_TOL_PX). save_json:
    the same records, paired image by image; ids equal, bbox (3 decimals)
    within 1e-3 + BOX_TOL_PX and score (5 decimals) within 1e-5."""
    if overrides.get("save_txt"):
        jfiles = sorted(p.name for p in (jdir / "labels").glob("*.txt"))
        tfiles = sorted(p.name for p in (tdir / "labels").glob("*.txt"))
        assert jfiles == tfiles and len(tfiles) == N_VAL
        for name in jfiles:
            want = read_txt(jdir / "labels" / name)
            got = read_txt(tdir / "labels" / name)

            def fits(j, i):
                w, g = want[j], got[i]
                return (len(w) == len(g) and w[0] == g[0]
                        and np.allclose(g[1:], w[1:], rtol=2e-6, atol=1e-6))
            assert pair(len(want), len(got), fits) is not None, name
    if overrides.get("save_json"):
        want = json.loads((jdir / "predictions.json").read_text())
        got = json.loads((tdir / "predictions.json").read_text())
        assert len(want) == len(got) > 0
        ids = sorted({r["image_id"] for r in want})
        assert ids == sorted({r["image_id"] for r in got})
        for k in ids:
            w = [r for r in want if r["image_id"] == k]
            g = [r for r in got if r["image_id"] == k]

            def fits(j, i):
                return (w[j]["category_id"] == g[i]["category_id"]
                        and np.allclose(g[i]["bbox"], w[j]["bbox"], rtol=0,
                                        atol=1e-3 + BOX_TOL_PX)
                        and abs(g[i]["score"] - w[j]["score"]) <= 1e-5)
            assert pair(len(w), len(g), fits) is not None, k


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
        # JAX's five plot files; the confusion matrix drawn alike
        for d in ("jax", "torch"):
            assert sorted(p.name for p in (tmp_path / d).glob("*.png")) == [
                "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
                "confusion_matrix.png"]
        import cv2
        np.testing.assert_array_equal(
            *(cv2.imread(str(tmp_path / d / "confusion_matrix.png"))
              for d in ("jax", "torch")))
    if overrides.get("save_hybrid"):
        # every label came back as a detection of score 1
        assert float(got["metrics/recall(B)"]) == 1.0


def test_get_validator_and_unported_branches():
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tr = DetectionTrainer({"batch": 2}, model=tm, device="cpu")
    v = tr.get_validator(save_dir="unused")
    assert v.args.conf == 0.001 and v.device.type == "cpu"
    assert v.args.batch == 2 and v.save_dir == Path("unused")
    with pytest.raises(TypeError, match="AutoBackend"):
        v(model=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        v(model=tm, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validator.DetectionValidator(args=get_cfg())
