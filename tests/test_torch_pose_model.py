"""Torch port vs the JAX package: the pose model (CPU, f32), on JAX's
`POSE_TINY` (tests/test_pose_task.py, 3 keypoints of x, y, visibility),
`POSE_TINY_L0` (the same rows under a `lowlight_recovery` row 0) and the
packaged `yolov8-pose.yaml` / `yolov8-pose-p6.yaml`, with numpy-seeded
weights drawn into the flax trees. Bars, each with its reason:
  - parameter counts at every scale, the weight round trip: exact;
  - eval outputs (boxes, scores, keypoints) at 64 and 96: boxes and
    keypoint x, y 4e-4 px (f32 convolutions summing in another order than
    XLA's, times the stride), scores and keypoint visibilities 1e-5;
  - `decode_keypoints` on the same maps: 1e-5 px (one multiply-add and the
    sigmoid, no convolution).
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn import heads as JH  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn import heads as TH  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax, state_dict_to_jax)

from test_pose_task import POSE_TINY  # noqa: E402
from test_torch_segment_model import jax_variables, with_layer0  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

POSE_TINY_L0 = with_layer0(POSE_TINY)
GRAPHS = {"tiny": POSE_TINY, "tiny_l0": POSE_TINY_L0}


def pose_pair(d, seed=0):
    jm = JaxModel(copy.deepcopy(d))
    v = jax_variables(jm, seed=seed)
    tm = DetectionModel(copy.deepcopy(d)).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("name", [f"yolov8{s}-pose.yaml" for s in "nsmlx"]
                         + ["yolov8n-pose-p6.yaml", "yolov8l-pose-p6.yaml"])
def test_param_counts_equal_jax(name):
    jm = JaxModel(jax_yaml_load(name))
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = DetectionModel(model_yaml_load(name))
    assert tm.task == jm.task == "pose" and tm.nc == 1
    assert tm.kpt_shape == jm.kpt_shape == (17, 3)
    assert sum(p.numel() for p in tm.parameters()) == want


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_weights_round_trip(graph):
    """flax -> the port -> flax, equal, the keypoint branch `cv4_{i}_{j}`
    at `cv4.{i}.{j}` beside the inner Detect's."""
    jm, v, tm = pose_pair(GRAPHS[graph])
    back = state_dict_to_jax(tm.state_dict(), tm)
    for section in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(v[section])
        got = dict(jax.tree_util.tree_leaves_with_path(back[section]))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf)
    head = len(tm.specs) - 1
    k = v["params"][f"mods_{head}"]["cv4_2_2"]["kernel"]
    np.testing.assert_array_equal(
        tm.state_dict()[f"model.{head}.cv4.2.2.weight"].numpy(),
        np.transpose(k, (3, 2, 0, 1)))


@pytest.mark.parametrize("imgsz", [64, 96])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_eval_outputs_match_jax(graph, imgsz):
    jm, v, tm = pose_pair(GRAPHS[graph], seed=imgsz)
    x = np.random.default_rng(imgsz).uniform(0, 1, (2, imgsz, imgsz, 3)
                                             ).astype(np.float32)
    want = [np.asarray(o)
            for o in jax.jit(jm.eval_outputs)(v, jnp.asarray(x))]
    with torch.no_grad():
        got = [o.numpy() for o in tm.eval_outputs(torch.from_numpy(x))]
    n = int((imgsz // 8) ** 2 * (1 + 1 / 4 + 1 / 16))
    assert got[0].shape == (2, n, 4) and got[2].shape == (2, n, 3, 3)
    for g, w, tol in zip(got, want, (4e-4, 1e-5)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    np.testing.assert_allclose(got[2][..., :2], want[2][..., :2], rtol=0,
                               atol=4e-4)
    np.testing.assert_allclose(got[2][..., 2], want[2][..., 2], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)])
def test_decode_keypoints_matches_jax(kpt_shape):
    rng = np.random.default_rng(3)
    nk = kpt_shape[0] * kpt_shape[1]
    maps = [rng.normal(0, 2, (2, h, h, nk)).astype(np.float32)
            for h in (8, 4, 2)]
    want = np.asarray(JH.decode_keypoints([jnp.asarray(m) for m in maps],
                                          (8, 16, 32), kpt_shape))
    got = TH.decode_keypoints([torch.from_numpy(m) for m in maps],
                              (8, 16, 32), kpt_shape).numpy()
    assert got.shape == want.shape == (2, 84, *kpt_shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
