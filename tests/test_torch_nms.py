"""Torch port's batched NMS vs the JAX package's (CPU, f32).

Same inputs through both; dets and counts must be EQUAL (the port repeats the
JAX arithmetic op for op), including exact score ties, where both must keep
the lower index first (ROADMAP C2), and a dense scene that fills max_det.
"""

import ast
import inspect
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.ops.nms import _nms_single  # noqa: E402
from dedark_yolo_tpu.ops.nms import non_max_suppression as jax_nms  # noqa: E402
from dedark_yolo_tpu_torch.engine import predictor as P  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator as V  # noqa: E402
from dedark_yolo_tpu_torch.ops import nms as N  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402
from dedark_yolo_tpu_torch.tools.nms_scenes import SCENES, draw, scene  # noqa: E402


def _scene(b=3, n=400, nc=4, seed=0, ties=False, dense=False):
    """Seeded boxes and scores (tools/nms_scenes.py `draw`); with ties,
    quantised scores (many exact ties, also across classes) and duplicated
    boxes."""
    return draw(b, n, nc, seed, ties=ties, dense=dense)


def _both(boxes, scores, **kw):
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = non_max_suppression(torch.from_numpy(boxes),
                              torch.from_numpy(scores), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


CASES = {
    "multi_label": dict(multi_label=True),
    "single_label": dict(multi_label=False),
    "agnostic": dict(multi_label=True, agnostic=True),
    "single_agnostic": dict(multi_label=False, agnostic=True),
    "return_idx": dict(multi_label=True, return_idx=True),
    "low_cap": dict(multi_label=True, max_nms=64, max_det=20),
}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_equals_jax(case, ties):
    boxes, scores = _scene(ties=ties, seed=len(case))
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=100, max_nms=512)
    kw.update(CASES[case])
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1].min() > 0


def test_nms_dense_scene_fills_max_det():
    boxes, scores = _scene(b=2, n=3000, nc=3, seed=7, dense=True)
    kw = dict(conf_thres=0.05, iou_thres=0.7, max_det=300, max_nms=2048)
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 300).all()


def test_nms_empty_image_in_batch():
    """An image with nothing above conf ends at once while the others go on."""
    boxes, scores = _scene(b=2, seed=3)
    scores[1] = 0.0
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=50, max_nms=256)
    want, got = _both(boxes, scores, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    dets, counts = got
    assert counts[0] > 0 and counts[1] == 0 and (dets[1, :, 5] == -1).all()


# ---- the greedy loop: the `nms` kernel's wrapper and its plain version ----

NMS_SOURCE = (Path(__file__).resolve().parents[1] / "dedark_yolo_tpu_torch"
              / "csrc" / "nms.cu")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_greedy_nms_equals_jax_greedy_loop(name):
    """The kernel's scenes (chip_smoke.py holds the kernel to `_greedy` on
    them): the wrapper on CPU tensors, i.e. `_greedy`, keeps exactly what the
    JAX package's while_loop keeps, index for index and score for score."""
    boxes, scores, kw = scene(name, "cpu")
    got_i, got_s = N.greedy_nms(boxes, scores, **kw)
    want_i, want_s = jax.vmap(
        lambda b, s: _nms_single(b, s, kw["iou_thres"], kw["max_det"]))(
            jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_i.dtype == torch.long and got_s.dtype == torch.float32
    assert boxes.shape[1] <= N.MAX_K
    if name == "empty_image":
        assert (got_i[1] == -1).all() and (got_i[0] >= 0).any()
    if name == "dense":
        assert (got_i >= 0).all()


def _calls_in(fn):
    """Names of the functions and methods `fn`'s source calls."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            out.add(f.attr if isinstance(f, ast.Attribute) else
                    getattr(f, "id", ""))
    return out


def test_nms_reaches_greedy_through_the_wrapper(monkeypatch):
    """non_max_suppression goes through greedy_nms (which on the CPU runs
    `_greedy`, its plain version), and nothing that runs on the card path
    asks the host: no .item(), bool(), int(), .cpu(), .tolist(), .numpy()
    or synchronize in the gate, the wrapper, the NMS, predict's step, the
    device step it shares with val, or val's hybrid candidates."""
    seen = []
    real = N._greedy
    monkeypatch.setattr(N, "_greedy",
                        lambda *a, **k: seen.append(a[0].shape) or real(*a, **k))
    boxes, scores = _scene(b=2, n=50, nc=3, seed=1)
    dets, counts = N.non_max_suppression(torch.from_numpy(boxes),
                                         torch.from_numpy(scores),
                                         conf_thres=0.3, max_det=20)
    assert seen == [(2, 150, 4)] and counts.min() > 0
    syncs = {"item", "bool", "int", "cpu", "tolist", "numpy", "synchronize"}
    for fn in (N.non_max_suppression, N.nms_candidates, N.greedy_nms,
               P.DetectionPredictor.step, P.detect_step, V.hybrid_candidates):
        assert not (_calls_in(fn) & syncs), (fn.__name__, _calls_in(fn) & syncs)
    # upload waits only on a pinned buffer's copy from two uploads back
    assert _calls_in(P.PinnedUpload.__call__) & syncs == {"synchronize",
                                                          "numpy"}


def test_nms_constants_mirror_the_kernel_source():
    """MAX_K and the block's shared memory in ops/nms.py are csrc/nms.cu's:
    its THREADS and PER, and its Smem (MAX_K float4 boxes, then two
    double-buffered sets of WARPS float scores and int indices). The card
    run holds smem_bytes() to the library's nms_smem_bytes()."""
    src = NMS_SOURCE.read_text()
    const = {k: int(v) for k, v in
             re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}
    assert (const["THREADS"], const["PER"]) == (N.THREADS, N.PER)
    assert "MAX_K = THREADS * PER" in src and N.MAX_K == 2048
    assert "WARPS = THREADS / 32" in src
    smem = re.search(r"struct Smem \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(float4|float|int) (\w+)((?:\[\w+\])+);", smem,
                        re.M)
    size = {"float4": 16, "float": 4, "int": 4}
    dims = {"MAX_K": N.MAX_K, "WARPS": N.THREADS // 32, "2": 2}
    total = 0
    for typ, _, ext in fields:
        n = size[typ]
        for d in re.findall(r"\[(\w+)\]", ext):
            n *= dims[d]
        total += n
    assert [f[1] for f in fields] == ["box", "win_s", "win_i"]
    assert total == N.smem_bytes() == 32896
    assert N.smem_bytes() <= 48 * 1024   # static shared memory
