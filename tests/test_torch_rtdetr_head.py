"""Torch port vs the JAX package: RT-DETR's decoder head and its graph
(CPU, f32).

`RTDETRDecoder` alone (tests/test_rtdetr.py's widths: hd 32, ndl 2, nh 8)
on numpy-seeded flax weights carried by the port's name map: the selected
queries' indices equal JAX's `jax.lax.top_k` of the encoder's best class
scores, then the eval output (boxes and scores) and the train-mode dict
(every decoder layer's boxes and logits, the encoder's selected proposals)
and the BN stats' move within 1e-5. A second selection case puts an
80-wide map in, whose border anchors are invalid and tie exactly (their
features are masked to 0), with all 220 queries selected, so the queries'
order is the tie order (its 220-query decoder sums in another order than
XLA's: outputs there sit within 5e-5, not held).
Then DetectionModel: `yolov8-rtdetr.yaml` built at n and l on the meta
device with JAX's parameter counts (45,485,361 at l, nc 3), and
`eval_outputs` on a non-square input (boxes scaled by its w and h) against
JAX's `apply_eval`, on tests/tiny_rtdetr.yaml.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import RTDETRDecoder as JaxDecoder  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.nn.heads import RTDETRDecoder  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import top_k  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    module_state_from_jax, state_dict_from_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

TINY = str(Path(__file__).resolve().parent / "tiny_rtdetr.yaml")
RTOL = ATOL = 1e-5
CH, NC = (16, 32, 64), 5


def _feats(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
            for (h, w), c in zip(sizes, CH)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


CASES = {"square": (((8, 8), (4, 4), (2, 2)), 16),
         "ties": (((2, 80), (1, 40), (1, 20)), 1000)}


@pytest.fixture(scope="module")
def head_pair():
    return make_head_pair("square")


def make_head_pair(name):
    """JAX's head and the port's on the same weights and maps: JAX's eval
    output, train dict, moved BN stats and selected query indices."""
    sizes, nq = CASES[name]
    feats = _feats(sizes)
    jf = [jnp.asarray(f) for f in feats]
    j = JaxDecoder(nc=NC, hd=32, nq=nq, ndl=2, strides=(8, 16, 32))
    v = to_plain(randomize(j.init(jax.random.PRNGKey(0), jf),
                           np.random.default_rng(1)))
    out, inter = j.apply(v, jf, capture_intermediates=lambda m, n:
                         m.name == "enc_score_head", mutable=["intermediates"])
    enc = inter["intermediates"]["enc_score_head"]["__call__"][0]
    nsel = min(nq, enc.shape[1])
    jsel = np.asarray(jax.lax.top_k(enc.max(-1), nsel)[1])
    train, upd = j.apply(v, jf, train=True, mutable=["batch_stats"])
    t = RTDETRDecoder(NC, CH, (8, 16, 32), hd=32, nq=nq, ndl=2)
    start = module_state_from_jax(v, "RTDETRDecoder", (NC, 32, nq, 2), CH)
    t.load_state_dict(start, strict=True)
    moved = module_state_from_jax({"batch_stats": to_plain(upd["batch_stats"])},
                                  "RTDETRDecoder", (NC, 32, nq, 2), CH)
    return {"name": name, "feats": feats, "t": t, "start": start,
            "eval": np.asarray(out), "train": {k: np.asarray(a) for k, a in
                                               train.items()},
            "stats": moved, "sel": jsel}


@pytest.mark.parametrize("name", list(CASES))
def test_selected_queries_equal_jax(name, head_pair):
    r = head_pair if name == "square" else make_head_pair(name)
    t = r["t"].eval()
    seen = []
    hook = t.enc_score_head.register_forward_hook(
        lambda m, i, o: seen.append(o))
    with torch.no_grad():
        t([_nchw(f) for f in r["feats"]])
    hook.remove()
    got = top_k(seen[0].amax(-1), r["sel"].shape[1])[1].numpy()
    np.testing.assert_array_equal(got, r["sel"])
    if r["name"] == "ties":   # the masked border anchors tie exactly
        scores = seen[0].amax(-1)[0].numpy()
        assert (scores == scores[0]).sum() >= 4


def test_eval_output_equals_jax(head_pair):
    r = head_pair
    t = r["t"].eval()
    with torch.no_grad():
        got = t([_nchw(f) for f in r["feats"]]).numpy()
    assert got.shape == r["eval"].shape
    np.testing.assert_allclose(got, r["eval"], rtol=RTOL, atol=ATOL)
    assert ((got >= 0) & (got <= 1)).all()


def test_train_outputs_equal_jax(head_pair):
    r = head_pair
    t = r["t"]
    t.load_state_dict(r["start"])
    t.train()
    got = t([_nchw(f) for f in r["feats"]])
    t.eval()
    assert set(got) == set(r["train"])
    for k, want in r["train"].items():
        np.testing.assert_allclose(got[k].detach().numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    sd = t.state_dict()
    for k, want in r["stats"].items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    t.load_state_dict(r["start"])


@pytest.mark.parametrize("scale,nc", [("n", 80), ("l", 3)])
def test_param_count_equals_jax(scale, nc):
    d = jax_yaml_load("yolov8-rtdetr.yaml")
    d["scale"] = scale
    jm = JaxModel(copy.deepcopy(d), nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes["params"]))
    pd = model_yaml_load("yolov8-rtdetr.yaml")
    pd["scale"] = scale
    with torch.device("meta"):
        tm = DetectionModel(pd, nc=nc)
    assert tm.head["name"] == "RTDETRDecoder" and tm.task == "detect"
    assert sum(p.numel() for p in tm.parameters()) == want
    if (scale, nc) == ("l", 3):
        assert want == 45_485_361


def test_eval_outputs_scale_non_square():
    """Boxes times (w, h, w, h) of a 64x96 input, scores as they are."""
    d = model_yaml_load(TINY)
    jm = JaxModel(copy.deepcopy(d))
    tmpl = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    v = to_plain(randomize(tmpl, np.random.default_rng(0)))
    tm = DetectionModel(d).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 96, 3)).astype(
        np.float32)
    jb, js = jax.jit(jm.apply_eval)(v, jnp.asarray(x))
    with torch.no_grad():
        tb, ts = tm.eval_outputs(torch.from_numpy(x))
        raw = tm(torch.from_numpy(x))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        tb.numpy(), (raw[..., :4] * torch.tensor([96., 64., 96., 64.])).numpy())
