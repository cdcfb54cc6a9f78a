"""Torch port's batched NMS vs the JAX package's (CPU, f32).

Same inputs through both; dets and counts must be EQUAL (the port repeats the
JAX arithmetic op for op), including exact score ties, where both must keep
the lower index first (ROADMAP C2), and a dense scene that fills max_det.
"""

import ast
import ctypes
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
from dedark_yolo_tpu_torch.tools.nms_scenes import (  # noqa: E402
    SCENES, draw, scene, walk_depth)


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
    """CHUNK, MAX_K, the mask's size and the launch's arguments in
    ops/nms.py are csrc/nms.cu's: a mask word covers CHUNK candidates, an
    image has at most MAX_K, the scratch mask is (B, K, ceil(K / CHUNK))
    u64, and `nms_launch` takes the mask last. The card run holds CHUNK, MAX_K and mask_bytes to the library's
    nms_chunk, nms_max_k and nms_mask_bytes."""
    src = NMS_SOURCE.read_text()
    const = {k: v for k, v in
             re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M)}
    assert int(const["CHUNK"]) == N.CHUNK == 64
    assert int(const["MAX_K"]) == N.MAX_K == 2048
    body = re.search(r"long long nms_mask_bytes\(int B, int K\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    assert body == "8LL * B * K * ((K + CHUNK - 1) / CHUNK)"
    for b, k in [(16, 2048), (3, 1998), (1, 1), (2, 64), (2, 65)]:
        want = eval(body.replace("8LL", "8").replace("/", "//"),
                    {"B": b, "K": k, "CHUNK": N.CHUNK})
        assert N.mask_bytes(b, k) == want == 8 * b * k * N.mask_words(k)
    assert N.mask_bytes(16, 2048) == 16 * 2048 * 32 * 8   # 8.4 MB
    params = re.search(r'extern "C" int nms_launch\(([^)]*)\)', src).group(1)
    types = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    assert [ctype[t] for t in types] == N.ARGTYPES
    assert params.replace("\n", " ").split()[-1] == "mask"


# ---- a model of the kernel's algorithm (csrc/nms.cu), in torch and numpy ----

MODEL_IMAGES = 4     # the first images of each scene


def _mask_model(boxes, scores, iou_thres, rng):
    """nms_mask for one image: (K, W) u64 words, bit t of word w in row i
    set iff j = 64w + t > i, j < K and IoU(i, j) > iou_thres, with
    `_greedy`'s expression and rounding (row i the winner). Words the
    kernel never writes (below the diagonal, rows whose score is <= 0)
    hold random bits, as torch.empty scratch may."""
    k, w = boxes.shape[0], N.mask_words(boxes.shape[0])
    x1, y1, x2, y2 = (v[:, None] for v in boxes.unbind(-1))   # rows: winners
    cx1, cy1, cx2, cy2 = (v[None, :] for v in boxes.unbind(-1))
    area = ((boxes[:, 2] - boxes[:, 0]).clamp(min=0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0))
    iw = (torch.minimum(cx2, x2) - torch.maximum(cx1, x1)).clamp(min=0)
    ih = (torch.minimum(cy2, y2) - torch.maximum(cy1, y1)).clamp(min=0)
    inter = iw * ih
    hit = inter / (area[None, :] + area[:, None] - inter + 1e-7) > iou_thres
    if iou_thres >= 0:           # the kernel skips the division there
        hit &= inter != 0
    hit &= torch.ones(k, k, dtype=torch.bool).triu(1)
    bits = np.zeros((k, w * N.CHUNK), bool)
    bits[:, :k] = hit.numpy()
    words = np.packbits(bits.reshape(k, w, 8, 8), axis=-1,
                        bitorder="little").reshape(k, w, 8).view("<u8")[..., 0]
    rows = np.arange(k)
    unwritten = ((np.arange(w)[None, :] < (rows // N.CHUNK)[:, None])
                 | ~(scores.numpy() > 0)[:, None])
    garbage = rng.integers(0, 2 ** 63, (k, w), dtype=np.uint64) * 2 + 1
    return np.where(unwritten, garbage, words)


def _scan_model(mask, scores, max_det):
    """nms_scan for one image on `_mask_model`'s words: chunk by chunk,
    stop at the first score <= 0 or max_det kept, resolve the chunk on its
    live word (lowest bit first, its diagonal word clears what it
    suppresses), then OR the kept rows' later words into `removed`.
    Returns keep_idx, keep_scores and the candidates walked."""
    k, w = mask.shape
    s = scores.numpy()
    removed = np.zeros(w, np.uint64)
    keep = []
    depth = 0
    for c in range(w):
        lo = c * N.CHUNK
        positive = np.zeros(N.CHUNK, bool)
        positive[:min(k - lo, N.CHUNK)] = s[lo:lo + N.CHUNK] > 0
        first_stop = N.CHUNK if positive.all() else int(np.argmin(positive))
        alive = ((1 << first_stop) - 1) & ~int(removed[c])
        kept_here = []
        while alive and len(keep) < max_det:
            t = (alive & -alive).bit_length() - 1
            keep.append(lo + t)
            kept_here.append(lo + t)
            depth = lo + t + 1
            alive &= alive - 1
            alive &= ~int(mask[lo + t, c])
        if first_stop < N.CHUNK or len(keep) == max_det:
            if len(keep) < max_det:
                depth = lo + first_stop
            break
        depth = min(lo + N.CHUNK, k)
        if kept_here and c + 1 < w:
            removed[c + 1:] |= np.bitwise_or.reduce(mask[kept_here, c + 1:], 0)
    keep_idx = np.full(max_det, -1, np.int64)
    keep_scores = np.zeros(max_det, np.float32)
    keep_idx[:len(keep)] = keep
    keep_scores[:len(keep)] = s[keep]
    return keep_idx, keep_scores, depth


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_scores_meet_the_kernel_contract(name):
    """Every scene's scores (the gate's output) are non-increasing along K
    in every image, with the zeros after every positive score."""
    _, scores, _ = scene(name, "cpu")
    assert (scores[:, 1:] <= scores[:, :-1]).all()
    assert (scores >= 0).all()
    pos = scores > 0
    assert (pos.sum(1) == pos.cumprod(1).sum(1)).all()     # a prefix


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_model_equals_greedy_and_jax(name):
    """The kernel's algorithm (mask words from the diagonal on, the
    diagonal word holding only j > i, the chunked walk with its early stop)
    keeps exactly what `_greedy` and the JAX while_loop keep on the first
    images of every scene, whatever the words it never writes hold; its
    walk depth is `walk_depth`'s, and the crowd scene's walk passes
    candidate 1500 in every image."""
    boxes, scores, kw = scene(name, "cpu")
    boxes, scores = boxes[:MODEL_IMAGES], scores[:MODEL_IMAGES]
    rng = np.random.default_rng(0)
    got = [_scan_model(_mask_model(b, s, kw["iou_thres"], rng), s,
                       kw["max_det"]) for b, s in zip(boxes, scores)]
    got_i = np.stack([g[0] for g in got])
    got_s = np.stack([g[1] for g in got])
    want_i, want_s = N._greedy(boxes, scores, **kw)
    jax_i, jax_s = jax.vmap(
        lambda b, s: _nms_single(b, s, kw["iou_thres"], kw["max_det"]))(
            jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_i, np.asarray(jax_i))
    np.testing.assert_array_equal(got_s, np.asarray(jax_s))
    depth = walk_depth(want_i, scores, kw["max_det"])
    assert [g[2] for g in got] == depth.tolist()
    if name == "crowd":
        assert (depth > 1500).all()


def test_greedy_nms_is_called_only_on_the_gates_output():
    """The kernel's contract (scores sorted by the gate) holds because
    `greedy_nms`'s one caller in the port is `non_max_suppression`, which
    hands it the class-offset boxes and scores of `nms_candidates`."""
    pkg = Path(N.__file__).resolve().parents[1]
    callers = []
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and (
                        getattr(node.func, "id", None) == "greedy_nms"
                        or getattr(node.func, "attr", None) == "greedy_nms"):
                    callers.append((path.relative_to(pkg).as_posix(),
                                    fn.name, node))
    assert [(p, f) for p, f, _ in callers] == [("ops/nms.py",
                                                "non_max_suppression")]
    fn = next(n for n in ast.walk(ast.parse(inspect.getsource(
        N.non_max_suppression))) if isinstance(n, ast.FunctionDef))
    gate = next(n for n in fn.body if isinstance(n, ast.Assign)
                and isinstance(n.value, ast.Call)
                and getattr(n.value.func, "id", None) == "nms_candidates")
    outs = [e.id for e in gate.targets[0].elts]
    call = callers[0][2]
    assert [a.id for a in call.args[:2]] == outs[3:5]
