"""Torch port vs the JAX package: the detect architectures as whole graphs
(CPU, f32), at scale n, nc=3, imgsz 64 (a multiple of P6's stride), batch
2, on shared numpy-seeded weights carried by `state_dict_from_jax`.

Held per architecture as tests/test_torch_model.py holds the flagship: raw
head maps at 1e-4 (every level, in the head's order: two for the twohead,
four for P2 and P6), the decode's boxes at 4e-4 px and scores at 1e-6,
then NMS: equal counts and every detection paired (tests/pairing.py) at
those bars, with some detection in the batch.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_model_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import decode_detections as jax_decode  # noqa: E402
from dedark_yolo_tpu.ops.nms import non_max_suppression as jax_nms  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from pairing import assert_paired  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

IMGSZ, BATCH, NC = 64, 2, 3
RAW_TOL, BOX_TOL, SCORE_TOL = 1e-4, 4e-4, 1e-6
NMS_ARGS = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, max_nms=2048,
                multi_label=False)
# head strides of each architecture, in the head's order
STRIDES = {"yolov8": (8, 16, 32), "yolov8-dedark": (8, 16, 32),
           "yolov8-faster": (8, 16, 32), "yolov8-faster-twohead": (8, 16),
           "yolov8-rbf": (32, 16, 8), "yolov8-rbf-asff": (8, 16, 32),
           "yolov8-mfru-rbf-asff": (8, 16, 32),
           "yolov8-asff-threehead": (8, 16, 32),
           "yolov8-p2": (4, 8, 16, 32), "yolov8-p6": (8, 16, 32, 64)}


def variant_pair(arch, scale="n", seed=0):
    """(JAX model, its numpy variables, the port's model with them)."""
    name = arch.replace("yolov8", "yolov8" + scale) + ".yaml"
    jm = JaxModel(jax_model_yaml_load(name), nc=NC)
    template = jax.eval_shape(
        jm.module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    variables = to_plain(randomize(template, np.random.default_rng(seed)))
    tm = DetectionModel(model_yaml_load(name), nc=NC).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


def check_graph(arch):
    jm, variables, tm = variant_pair(arch)
    assert tuple(tm.strides) == tuple(jm.strides) == STRIDES[arch]
    img = np.random.default_rng(1).uniform(
        0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)
    raw_j = [np.asarray(r) for r in
             jax.jit(lambda v, x: jm.apply_eval(v, x, decode=False))(
                 variables, jnp.asarray(img))]
    with torch.no_grad():
        raw_t = tm(torch.from_numpy(img))
    assert [tuple(r.shape) for r in raw_t] == [r.shape for r in raw_j] == \
        [(BATCH, IMGSZ // s, IMGSZ // s, 64 + NC) for s in STRIDES[arch]]
    for j, t in zip(raw_j, raw_t):
        np.testing.assert_allclose(t.numpy(), j, rtol=RAW_TOL, atol=RAW_TOL)

    jb, js = jax_decode([jnp.asarray(r) for r in raw_j], NC, jm.strides)
    tb, ts = tm.decode([torch.from_numpy(np.array(r)) for r in raw_j])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    tb, ts = tm.decode(raw_t)
    jd, jc = jax_nms(jb, js, **NMS_ARGS)
    td, tc = non_max_suppression(tb, ts, **NMS_ARGS)
    jd, td = np.asarray(jd), td.numpy()
    for i, n in enumerate(tc.numpy()):
        w, g = jd[i, :int(jc[i])], td[i, :n]
        assert_paired((w[:, :4], w[:, 5], w[:, 4]), (g[:, :4], g[:, 5], g[:, 4]),
                      BOX_TOL, SCORE_TOL, f"{arch} image {i}")
    assert int(tc.sum()) > 0, f"{arch}: no detections at conf 0.25"


@pytest.mark.parametrize("arch", list(STRIDES))
def test_graph_matches_jax(arch):
    check_graph(arch)


@pytest.mark.parametrize("arch,hw", [("yolov8-faster-twohead", (224, 224)),
                                     ("yolov8-rbf", (128, 96)),
                                     ("yolov8-p6", (128, 128))])
def test_tta_matches_jax(arch, hw):
    """tta_eval (three passes, padded to the head's largest stride, the
    extreme passes' tails clipped by level count) on heads of 2 and 4
    levels and the rbf head's coarse-first order: boxes 4e-4 px, scores
    1e-6. Both packages pad to the HEAD's largest stride (JAX
    graph.py:639): the twohead's is 16 while its backbone reaches 32, so
    only a size whose scaled passes pad to multiples of 32 runs there
    (224: 192 and 160; at 640 the 0.67 pass pads to 432 and both raise,
    ROADMAP C13)."""
    jm, variables, tm = variant_pair(arch)
    img = np.random.default_rng(3).uniform(
        0, 1, (1, *hw, 3)).astype(np.float32)
    jb, js = jax.jit(jm.tta_eval)(variables, jnp.asarray(img))
    with torch.no_grad():
        tb, ts = tm.tta_eval(torch.from_numpy(img))
    assert tuple(tb.shape) == jb.shape and tuple(ts.shape) == js.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
