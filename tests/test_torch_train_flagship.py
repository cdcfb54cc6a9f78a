"""The flagship Dedark-YOLOv8-L+ASFF (yolov8l.yaml, nc=3) in train mode:
the port's forward against JAX `apply_train` at imgsz 64, batch 2, on shared
weights (CPU, f32). Raw head maps, and every BN's new running stats.

Tolerances: raw maps 1e-3 of their largest magnitude, running stats 2e-5
absolute. Every layer normalises with its own batch statistics, and on these
random weights that makes the f32 train forward itself ill-conditioned: the
port's and JAX's f32 maps are each 1.5e-4 to 2.3e-4 of the largest
magnitude away from a float64 forward of the port, and 1.5e-4 to 3.3e-4
from each other (2.7e-4 at imgsz 128 too, so not the 8 values a P5 channel
has here); stats differ by up to 7e-6. The eval forward holds 1e-5
(tests/test_torch_model.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from test_torch_layers import randomize, to_plain  # noqa: E402

IMGSZ, BATCH, NC = 64, 2, 3


def test_flagship_train_forward_matches_jax():
    jm = JaxModel(jax_yaml_load("yolov8l.yaml"), nc=NC)
    template = jax.eval_shape(
        jm.module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    tm = DetectionModel(model_yaml_load("yolov8l.yaml"), nc=NC)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    img = np.random.default_rng(1).uniform(
        0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32) ** 3
    raw_j, stats_j = jm.apply_train(v, jnp.asarray(img))
    tm.train()
    with torch.no_grad():
        raw_t = tm(torch.from_numpy(img))
    assert len(raw_t) == len(raw_j) == 3
    for t, j in zip(raw_t, raw_j):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-3 * np.abs(j).max())
    want = state_dict_from_jax({"params": {}, "batch_stats": to_plain(stats_j)},
                               tm)
    got = tm.state_dict()
    start = state_dict_from_jax(v, tm)
    assert len(want) == sum("running_" in k for k in got)
    for k, w in want.items():
        assert not torch.equal(got[k], start[k]), k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
