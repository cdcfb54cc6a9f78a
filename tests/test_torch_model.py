"""Slice gate: the flagship Dedark-YOLOv8-L+ASFF (yolov8l.yaml, nc=3) in the
torch port vs the JAX package on shared weights, imgsz 128, batch 2, CPU f32.

Weights are drawn with numpy into the flax trees (no flax init compile) and
reach the port only through `state_dict_from_jax`. Stages compared: raw
head maps, the decode (ROADMAP targets: boxes within 4e-4 px, class scores
within 1e-6), NMS dets and counts, and both DetectionPredictors end to end
on 96x128 frames, which the letterbox only pads.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import (DEFAULT_CFG_DICT, get_cfg as jax_get_cfg,  # noqa: E402
                                 model_yaml_load as jax_model_yaml_load)
from dedark_yolo_tpu.engine.predictor import (  # noqa: E402
    DetectionPredictor as JaxPredictor)
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import decode_detections as jax_decode  # noqa: E402
from dedark_yolo_tpu.ops.nms import non_max_suppression as jax_nms  # noqa: E402
from dedark_yolo_tpu.utils.torch_import import export_state_dict  # noqa: E402

from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired, assert_results_paired  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402

IMGSZ, BATCH, NC = 128, 2, 3
BOX_TOL, SCORE_TOL = 4e-4, 1e-6
NMS_ARGS = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, max_nms=2048,
                multi_label=False)


@pytest.fixture(scope="module")
def flagship():
    jm = JaxModel(jax_model_yaml_load("yolov8l.yaml"), nc=NC)
    template = jax.eval_shape(
        jm.module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    variables = to_plain(randomize(template, np.random.default_rng(0)))
    tm = DetectionModel(model_yaml_load("yolov8l.yaml"), nc=NC).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    img = np.random.default_rng(1).uniform(
        0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)
    raw_j = [np.asarray(r) for r in jm.apply_eval(variables, jnp.asarray(img),
                                                  decode=False)]
    with torch.no_grad():
        raw_t = tm(torch.from_numpy(img))
    return jm, variables, tm, raw_j, raw_t


def test_state_dict_from_jax_equals_export(flagship):
    jm, variables, tm, _, _ = flagship
    want = export_state_dict(variables, jm)
    got = state_dict_from_jax(variables, tm)
    assert set(got) == set(want) == set(tm.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_raw_maps_match_jax(flagship):
    _, _, _, raw_j, raw_t = flagship
    assert [tuple(r.shape) for r in raw_t] == [r.shape for r in raw_j] == \
        [(BATCH, s, s, 64 + NC) for s in (16, 8, 4)]
    for j, t in zip(raw_j, raw_t):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4)


def test_decode_and_nms_match_jax(flagship):
    jm, _, tm, raw_j, raw_t = flagship
    jb, js = jax_decode([jnp.asarray(r) for r in raw_j], NC, jm.strides)
    tb, ts = tm.decode(raw_t)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    jd, jc = jax_nms(jb, js, **NMS_ARGS)
    td, tc = non_max_suppression(tb, ts, **NMS_ARGS)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.min()) > 0
    jd, td = np.asarray(jd), td.numpy()
    # paired (tests/pairing.py), not rank by rank: scores that tie within the
    # forwards' sum-order error may leave NMS in either order
    for i, n in enumerate(tc.numpy()):
        w, g = jd[i, :n], td[i, :n]
        assert_paired((w[:, :4], w[:, 5], w[:, 4]), (g[:, :4], g[:, 5], g[:, 4]),
                      BOX_TOL, SCORE_TOL, f"image {i}")
        np.testing.assert_array_equal(td[i, n:], jd[i, n:])


def test_predictors_match_jax(flagship, tmp_path):
    """Both DetectionPredictors on the same BGR frames and weights."""
    jm, variables, tm, _, _ = flagship
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
              for _ in range(3)]
    over = dict(imgsz=IMGSZ, batch=BATCH, conf=0.25, iou=0.7, max_det=300)
    jargs = jax_get_cfg(DEFAULT_CFG_DICT, dict(over, save=False))
    jp = JaxPredictor(args=jargs, model=jm, params=variables["params"],
                      batch_stats=variables["batch_stats"], names=jm.names,
                      save_dir=str(tmp_path))
    tp = DetectionPredictor(args=get_cfg(overrides=dict(over, device="cpu")), model=tm)
    want, got = jp(frames), tp(frames)
    assert len(got) == len(want) == 3
    assert sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.orig_img, w.orig_img)
    assert_results_paired(want, got, BOX_TOL, SCORE_TOL)
    assert set(tp.speed) == {"preprocess", "inference", "postprocess"}
