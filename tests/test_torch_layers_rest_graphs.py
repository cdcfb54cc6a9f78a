"""Torch port vs the JAX package: user graphs of the rest of nn/layers.py
(CPU, f32, imgsz 64, nc 3, batch 2), on shared numpy-seeded weights carried
by `state_dict_from_jax`, held as tests/test_torch_zoo_graphs.py holds the
zoo: raw head maps at 1e-4, the decode's boxes at 4e-4 px and scores at
1e-6, then NMS with every detection paired (tests/pairing.py).

The graphs: one row of each block (C3 built on the JAX side with k=(1, 3)
through a test-scoped monkeypatch of `dedark_yolo_tpu.nn.layers.C3`, the
reference's C3: JAX's default k raises a TypeError; no file changes), a
Bottleneck x2 row (two modules in a chain), `chip_smoke.py`'s yolov8-ghost
rows at scale n and its HGNetv2 + RepC3 detector at an eighth of its
widths and a third of its depth. Then RepConv's fusion on the JAX test's
`REP_YAML` (YOLO.fuse(), export(fuse=True), the deploy tree both ways), the
state dict's round trip through the JAX trees, the full-width parameter
counts and the rows that still raise.
"""

import copy
import functools
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import decode_detections as jax_decode  # noqa: E402
from dedark_yolo_tpu.ops.nms import non_max_suppression as jax_nms  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.nn.layers import RepConv, fuse_repconv  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402
from dedark_yolo_tpu_torch.utils.checkpoint import load_checkpoint, section_tree  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax, state_dict_to_jax)

import chip_smoke  # noqa: E402
from pairing import assert_paired  # noqa: E402
from test_repconv_fuse import REP_YAML  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

IMGSZ, BATCH, NC = 64, 2, 3
RAW_TOL, BOX_TOL, SCORE_TOL = 1e-4, 4e-4, 1e-6
NMS_ARGS = dict(iou_thres=0.7, max_det=300, max_nms=2048, multi_label=False)
# tests/test_repconv_fuse.py's bars for the deploy form
FUSE_BOX = dict(rtol=1e-4, atol=1e-3)
FUSE_SCORE = dict(rtol=0, atol=1e-5)

EVERY = {"nc": NC, "backbone": [
    [-1, 1, "HGStem", [16, 32]], [-1, 1, "HGBlock", [16, 32, 3]],
    [-1, 1, "Focus", [32, 3]], [-1, 1, "C1", [32, 1]],
    [-1, 1, "BottleneckCSP", [32, 1]], [-1, 1, "C3", [32, 1]],
    [-1, 2, "Bottleneck", [32]], [-1, 1, "GhostBottleneck", [64, 3, 2]],
    [-1, 1, "C3x", [64, 1]], [-1, 1, "C3Ghost", [64, 1]],
    [-1, 1, "RepC3", [64, 1]], [-1, 1, "GhostConv", [128, 3, 2]],
    [-1, 1, "C3TR", [128, 1]], [-1, 1, "SPP", [128, [3, 5, 7]]],
    [-1, 1, "CBAM", [128]], [-1, 1, "DWConv", [128, 3, 1]]],
    "head": [[9, 1, "ConvTranspose", [64, 2, 2]],
             [[5, 16, 15], 1, "Detect", ["nc"]]]}
CHAIN = {"nc": NC, "backbone": [
    [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
    [-1, 2, "Bottleneck", [32]], [-1, 2, "Conv", [32, 3, 2]],
    [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[3, 4, 5], 1, "Detect", ["nc"]]]}


def narrow_hgnet():
    """chip_smoke's HGNET at an eighth of its widths (the stem's a fourth)
    and HGBlock's six convs cut to two, RepC3's three RepConvs to one."""
    d = copy.deepcopy(chip_smoke.HGNET)
    for row in d["backbone"] + d["head"]:
        f, n, m, a = row
        if m == "HGStem":
            row[3] = [a[0] // 4, a[1] // 4]
        elif m == "HGBlock":
            row[1], row[3] = 2, [a[0] // 8, a[1] // 8, *a[2:]]
        elif m in ("DWConv", "Conv"):
            row[3] = [a[0] // 8, *a[1:]]
        elif m == "RepC3":
            row[1], row[3] = 1, [a[0] // 8]
    return d


GRAPHS = {"every": lambda: EVERY, "chain": lambda: CHAIN,
          "yolov8n-ghost": lambda: chip_smoke.ghost_graph("n"),
          "hgnet": narrow_hgnet}


@pytest.fixture
def jax_c3(monkeypatch):
    """JAX's C3 with the reference's kernels (1, 3), for this test only."""
    monkeypatch.setattr(JL, "C3", functools.partial(JL.C3, k=(1, 3)))


def graph_pair(graph, seed=0):
    """(JAX model, its numpy variables, the port's model with them)."""
    jm = JaxModel(copy.deepcopy(graph))
    template = jax.eval_shape(
        jm.module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    variables = to_plain(randomize(template, np.random.default_rng(seed)))
    tm = DetectionModel(graph, imgsz=IMGSZ).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


def _image(seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_matches_jax(name, jax_c3):
    jm, variables, tm = graph_pair(GRAPHS[name]())
    assert tuple(tm.strides) == tuple(jm.strides)
    img = _image()
    raw_j = [np.asarray(r) for r in
             jax.jit(lambda v, x: jm.apply_eval(v, x, decode=False))(
                 variables, jnp.asarray(img))]
    with torch.no_grad():
        raw_t = tm(torch.from_numpy(img))
    assert [tuple(r.shape) for r in raw_t] == [r.shape for r in raw_j]
    for j, t in zip(raw_j, raw_t):
        np.testing.assert_allclose(t.numpy(), j, rtol=RAW_TOL, atol=RAW_TOL)
    jb, js = jax_decode([jnp.asarray(r) for r in raw_j], NC, jm.strides)
    tb, ts = tm.decode(raw_t)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    # a conf that keeps some detections of these random weights
    conf = float(np.sort(np.asarray(js).max(-1).ravel())[-20])
    jd, jc = jax_nms(jb, js, conf_thres=conf, **NMS_ARGS)
    td, tc = non_max_suppression(tb, ts, conf_thres=conf, **NMS_ARGS)
    jd, td = np.asarray(jd), td.numpy()
    for i, n in enumerate(tc.numpy()):
        w, g = jd[i, :int(jc[i])], td[i, :n]
        assert_paired((w[:, :4], w[:, 5], w[:, 4]),
                      (g[:, :4], g[:, 5], g[:, 4]), BOX_TOL, SCORE_TOL,
                      f"{name} image {i}")
    assert int(tc.sum()) > 0


@pytest.mark.parametrize("name", ["every", "hgnet"])
def test_state_dict_round_trip(name, jax_c3):
    """state_dict_to_jax -> state_dict_from_jax gives the state dict back
    bit for bit, and the JAX tree it makes is the one it came from (the
    chained row's mods_{i}_{k}, the attention's 3-D kernels, the
    transposed conv's mirrored kernel)."""
    _, variables, tm = graph_pair(GRAPHS[name]())
    trees = state_dict_to_jax(tm.state_dict(), tm)
    back = state_dict_from_jax(trees, tm)
    sd = tm.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                        jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = leaves(variables), leaves(trees)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_rep_fused_matches_jax():
    """RepConv's fusion on REP_YAML: the port's fused model against its
    unfused one and against JAX's deploy graph on JAX's fused tree, at
    tests/test_repconv_fuse.py's bars; the fused state dict is that tree
    (within the folds' rounding) and crosses back bit for bit."""
    jm, variables, tm = graph_pair(REP_YAML)
    img = _image(0)
    x = torch.from_numpy(img)
    with torch.no_grad():
        b0, s0 = tm.decode(tm(x))
        assert fuse_repconv(tm) == 2
        b1, s1 = tm.decode(tm(x))
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), **FUSE_BOX)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), **FUSE_SCORE)
    fused = to_plain(JL.fuse_repconv_variables(variables))
    jd = JaxModel(copy.deepcopy(REP_YAML), repconv_deploy=True)
    jb, js = jax.jit(jd.apply_eval)(fused, jnp.asarray(img))
    np.testing.assert_allclose(b1.numpy(), np.asarray(jb), **FUSE_BOX)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), **FUSE_SCORE)
    trees = state_dict_to_jax(tm.state_dict(), tm)
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                        jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = leaves(fused), leaves(trees)
    assert set(got) == set(want) and any("fused" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    back = state_dict_from_jax(trees, tm)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def test_facade_fuse_and_export(tmp_path):
    """YOLO.fuse() turns every RepConv into its deploy form in place and is
    then a no-op; export(fuse=True) writes the fused graph (npz: JAX's
    deploy tree; pt2: equal to the fused live model) and leaves the facade
    as it was; a graph without RepConv fuses to itself."""
    path = tmp_path / "rep.json"
    path.write_text(json.dumps(REP_YAML))
    y = YOLO(str(path), device="cpu", seed=0)
    npz = y.export(format="npz", fuse=True, imgsz=IMGSZ, batch=1,
                   device="cpu", project=str(tmp_path / "npz"))
    _, flat = load_checkpoint(npz)
    assert any("fused" in k for k in flat)
    pt2 = y.export(format="pt2", fuse=True, imgsz=IMGSZ, batch=1,
                   device="cpu", project=str(tmp_path / "pt2"))
    reps = lambda form: sum(isinstance(m, RepConv) and hasattr(m, form)
                            for m in y.model.modules())
    assert reps("conv1") == 2 and reps("conv") == 0
    u8 = torch.from_numpy((_image(3)[:1] * 255).astype(np.uint8))
    with torch.no_grad():
        unfused = y.model.eval_outputs(u8.float() / 255)
    assert y.fuse() is y and reps("conv") == 2 and reps("conv1") == 0
    y.fuse()
    with torch.no_grad():
        live = y.model.eval_outputs(u8.float() / 255)
    for a, b in zip(AutoBackend(pt2, device="cpu")(u8), live):
        assert torch.equal(a, b)
    np.testing.assert_allclose(live[0].numpy(), unfused[0].numpy(),
                               **FUSE_BOX)
    np.testing.assert_allclose(live[1].numpy(), unfused[1].numpy(),
                               **FUSE_SCORE)
    variables = {"params": section_tree(flat, "params"),
                 "batch_stats": section_tree(flat, "batch_stats")}
    sd = state_dict_from_jax(variables, y.model)
    assert all(torch.equal(sd[k], v) for k, v in y.model.state_dict().items())
    plain = YOLO("yolov8n.yaml", nc=3, device="cpu", seed=0)
    before = {k: v.clone() for k, v in plain.model.state_dict().items()}
    plain.fuse()
    assert all(torch.equal(before[k], v)
               for k, v in plain.model.state_dict().items())


@pytest.mark.parametrize("name,want", [
    ("ghost-l", 14_218_489), ("hgnet", 80_802_857), ("every", None)])
def test_param_count_equals_jax(name, want, jax_c3):
    """yolov8l-ghost and the HGNetv2 detector at full width, and the tiny
    every-block graph: the port's parameter count (built on the meta
    device) is JAX's `eval_shape` count."""
    graph = {"ghost-l": lambda: chip_smoke.ghost_graph("l"),
             "hgnet": lambda: chip_smoke.HGNET, "every": lambda: EVERY}[name]()
    jm = JaxModel(copy.deepcopy(graph))
    shapes = jax.eval_shape(
        jm.module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))["params"]
    jax_n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = DetectionModel(graph, imgsz=IMGSZ)
    assert sum(p.numel() for p in m.parameters()) == jax_n
    assert want is None or jax_n == want


def test_smoke_blocks_graph_builds():
    """chip_smoke's every-block graph: its C3TR's position table sized by
    the map at 640 (20 x 20 at P5, where parse_model's stride says 16: it
    counts no GhostBottleneck stride, as JAX's does), and a 640 forward
    shape-checked on the meta device."""
    with torch.device("meta"):
        m = DetectionModel(chip_smoke.BLOCKS)
    pos = [mod.pos for mod in m.modules() if hasattr(mod, "pos")]
    assert [tuple(p.shape) for p in pos] == [(1, 400, 128)]
    out = m(torch.zeros(1, 640, 640, 3, device="meta"))
    assert [tuple(o.shape)[1:3] for o in out] == [(80, 80), (78, 78), (20, 20)]
