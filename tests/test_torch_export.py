"""The port's exporter (dedark_yolo_tpu_torch/engine/exporter.py) and the
enhance kernels as torch ops, on the CPU, tests/tiny_model.yaml at imgsz 64
from one JAX checkpoint of seeded weights.

- The ops `fused_enhance` and `usm` (ops/enhance_kernel.py): on CPU
  tensors each equals its `*_reference` bit for bit, and
  `torch.library.opcheck` passes (schema, fake version, autograd).
- The exported program keeps layer 0's kernel as one op node: the
  `fused_enhance` op in 'channel' mode, the `usm` op behind stock point
  ops in 'reference' mode, never the plain chain's ops.
- The `.pt2` program's outputs equal JAX's `eval_outputs` on the shared
  weights at the flagship slice's bars (tests/test_torch_model.py:37).
- The npz equals JAX `Exporter(format="npz")`'s key by key, and the
  sidecar what JAX exporter.py:113-127 builds, with JAX's output shapes
  from `jax.eval_shape`.
- The cache trap: the device-tensor caches (anchors, blur and resize
  matrices) are empty when the export runs; a live predict after it, at
  f32 and at half, returns real tensors in the caches and results equal to
  a predict before the export.
- The guards (onnx, the JAX package's formats, an unknown format, bf16
  npz, JAX artifacts), the CLI's `export` and `perform.onnx`.

The module exports the f32 program once (`exported`) and a half one in the
cache test.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine.exporter import Exporter as JaxExporter  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch import perform  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.nn import enhance as E  # noqa: E402
from dedark_yolo_tpu_torch.ops import anchors  # noqa: E402
from dedark_yolo_tpu_torch.ops import enhance_kernel as K  # noqa: E402

from test_torch_model import BOX_TOL, SCORE_TOL  # noqa: E402
from test_torch_val import tiny_variables  # noqa: E402

IMGSZ, BATCH = 64, 2
NAMES = {0: "car", 1: "bus", 2: "train"}
CACHES = (anchors._anchors_on, E._blur_matrix, E._bilinear_matrix,
          K.gaussian_taps)
PREDICT = dict(imgsz=IMGSZ, batch=BATCH, conf=0.02, max_det=40, max_nms=256,
               device="cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX model, flax variables, checkpoint path)."""
    jm, v = tiny_variables(seed=0)
    path = save_checkpoint(
        tmp_path_factory.mktemp("export") / "tiny.npz", params=v["params"],
        batch_stats=v["batch_stats"],
        train_args={"imgsz": IMGSZ, "names": NAMES}, model_yaml=jm.yaml)
    return jm, v, str(path)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return [(rng.uniform(0, 1, (h, w, 3)) ** 2 * 255).astype(np.uint8)
            for h, w in ((60, 80), (64, 64), (50, 70))]


def clear_caches():
    for c in CACHES:
        c.cache_clear()


def boxes_of(results):
    return [r.boxes.data.copy() for r in results]


def export_after_predict(npz, frames, tmp, **kw):
    """Live predict, then the caches cleared and the export (so that it is
    the caches' first caller), then the same predict again: (before,
    after, artifact path)."""
    y = YOLO(npz, device="cpu")
    before = boxes_of(y.predict(frames, half=kw.get("half", False),
                                **PREDICT))
    clear_caches()
    path = y.export(format="pt2", imgsz=IMGSZ, batch=BATCH, device="cpu",
                    project=str(tmp), **kw)
    assert all(c.cache_info().currsize == 0 for c in CACHES)
    after = boxes_of(y.predict(frames, half=kw.get("half", False), **PREDICT))
    return before, after, path


@pytest.fixture(scope="module")
def exported(tiny, frames, tmp_path_factory):
    _, _, npz = tiny
    return export_after_predict(npz, frames, tmp_path_factory.mktemp("pt2"))


def images(b=BATCH, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (b, IMGSZ, IMGSZ, 3), dtype=np.uint8)


def enhance_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(2, 20, 24, 3, generator=g)
    return {"fused_enhance": (img, torch.randn(2, 15, generator=g),
                              torch.rand(2, 3, generator=g),
                              torch.rand(2, 20, 24, 1, generator=g)),
            "usm": (img, torch.rand(2, 1, generator=g) * 5)}


@pytest.mark.parametrize("name", ["fused_enhance", "usm"])
def test_ops_equal_reference_and_pass_opcheck(name):
    args = enhance_inputs()[name]
    op = getattr(K, name)
    ref = getattr(K, f"{name}_reference")
    assert torch.equal(op(*args), ref(*args))
    bf16 = (args[0].to(torch.bfloat16),) + args[1:]
    assert torch.equal(op(*bf16), ref(*bf16))
    # the registered op, as a loaded program calls it
    assert torch.equal(getattr(getattr(torch.ops, K.OPS), name)(*args),
                       ref(*args))
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("mode,op", [("channel", "fused_enhance"),
                                     ("reference", "usm")])
def test_exported_graph_holds_the_op_node(tiny, tmp_path, exported, mode,
                                          op):
    _, _, npz = tiny
    path = (exported[2] if mode == "channel" else YOLO(npz, device="cpu")
            .export(format="pt2", imgsz=IMGSZ, batch=BATCH, device="cpu",
                    contrast_mode=mode, project=str(tmp_path)))
    from torch.export import load
    targets = [str(n.target) for n in load(path).graph.nodes
               if n.op == "call_function"]
    ours = [t for t in targets if t.startswith(K.OPS)]
    assert ours == [f"{K.OPS}.{op}.default"]
    # the plain chain's contrast curve and blur are not in the graph; the
    # reference mode's point filters (its cos) are stock ops
    assert ("aten.cos.default" in targets) == (mode == "reference")
    assert not any("einsum" in t for t in targets)


def test_pt2_equals_jax_eval_outputs(tiny, exported):
    jm, v, _ = tiny
    u8 = images()
    want = jm.eval_outputs(v, jnp.asarray(u8, jnp.float32) / 255.0)
    got = AutoBackend(exported[2], device="cpu")(u8)
    assert len(got) == len(want) == 2
    for g, w, tol in zip(got, want, (BOX_TOL, SCORE_TOL)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        print(f"pt2 vs JAX eval_outputs: {err:.3g}")
        assert err <= tol


def test_npz_equals_jax_exporter(tiny, tmp_path):
    jm, v, npz = tiny
    want = JaxExporter(jax_get_cfg(DEFAULT_CFG_DICT, {
        "format": "npz", "project": str(tmp_path / "jax")}))(
        jm, v["params"], v["batch_stats"])
    got = YOLO(npz, device="cpu").export(
        format="weights", device="cpu", project=str(tmp_path / "torch"))
    w, g = np.load(want), np.load(got)
    assert sorted(w.files) == sorted(g.files)
    for k in w.files:
        if k == "__meta__":
            wm, gm = (json.loads(str(z[k])) for z in (w, g))
            wm.pop("date"), gm.pop("date")
            assert gm == wm
        else:
            assert w[k].dtype == g[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sidecar_equals_jax(tiny, exported):
    jm, v, _ = tiny
    shapes = jax.eval_shape(
        lambda u8: jm.eval_outputs(v, u8.astype(jnp.float32) / 255.0),
        jax.ShapeDtypeStruct((BATCH, IMGSZ, IMGSZ, 3), jnp.uint8))
    # JAX exporter.py:113-127 for the facade YOLO(npz) gives its model
    want = {"imgsz": IMGSZ, "batch": BATCH, "nc": jm.nc, "task": "detect",
            "names": {int(k): v for k, v in NAMES.items()},
            "outputs": [{"name": n, "shape": list(s.shape)}
                        for n, s in zip(["boxes", "scores"], shapes)]}
    with open(exported[2] + ".json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize("half", [False, True])
def test_live_predict_after_export_is_real(tiny, frames, exported, tmp_path,
                                           half):
    _, _, npz = tiny
    before, after, _ = (exported if not half else export_after_predict(
        npz, frames, tmp_path, half=True))
    assert sum(len(b) for b in before) > 0
    for b, a in zip(before, after):
        assert type(a) is np.ndarray
        np.testing.assert_array_equal(a, b)
    filled = [c for c in CACHES if c.cache_info().currsize]
    assert anchors._anchors_on in filled
    assert (E._bilinear_matrix in filled) == half    # the bf16 resize
    # what the live predict left in them: real tensors, not fake ones
    kept = list(anchors.make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32)))
    if half:
        kept.append(E._bilinear_matrix(256, IMGSZ, torch.device("cpu"),
                                       torch.bfloat16))
    assert all(type(t) is torch.Tensor for t in kept)
    assert [c.cache_info().currsize for c in CACHES] == \
        [1 if c in filled else 0 for c in CACHES]


@pytest.mark.parametrize("fmt,exc,match", [
    ("onnx", RuntimeError, "'onnx' package"),
    ("stablehlo", NotImplementedError, "JAX package's XLA"),
    ("tflite", NotImplementedError, "JAX package's TensorFlow Lite"),
    ("saved_model", NotImplementedError, "JAX package's TensorFlow"),
    ("pb", NotImplementedError, "JAX package's TensorFlow"),
    ("torchscript", ValueError, "unsupported export format")])
def test_export_guards(tiny, tmp_path, fmt, exc, match):
    _, _, npz = tiny
    with pytest.raises(exc, match=match):
        YOLO(npz, device="cpu").export(format=fmt, device="cpu",
                                       project=str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_half_npz_and_jax_artifacts_raise(tiny, tmp_path):
    _, _, npz = tiny
    with pytest.raises(NotImplementedError, match="bf16"):
        YOLO(npz, device="cpu").export(format="npz", half=True, device="cpu",
                                       project=str(tmp_path))
    for spec in ("model.bin", "model.tflite"):
        with pytest.raises(NotImplementedError, match="JAX package"):
            AutoBackend(spec, device="cpu")
        with pytest.raises(NotImplementedError, match="JAX package"):
            YOLO(spec, device="cpu")
    (tmp_path / "saved_model.pb").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="JAX package"):
        AutoBackend(str(tmp_path), device="cpu")


def test_cli_export_and_perform_onnx(tiny, tmp_path, capsys, exported):
    _, _, npz = tiny
    rc = cli.entrypoint(["export", f"model={npz}", "format=pt2",
                         "device=cpu", f"imgsz={IMGSZ}", f"batch={BATCH}",
                         f"project={tmp_path / 'cli'}"])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("results ")][-1]
    path = json.loads(line[len("results "):])["path"]
    assert path == str(tmp_path / "cli" / "model.pt2")
    u8 = images()
    for got, want in zip(AutoBackend(path, device="cpu")(u8),
                         AutoBackend(exported[2], device="cpu")(u8)):
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="'onnx' package"):
        perform.onnx(npz, imgsz=IMGSZ, fmt="onnx", device="cpu")
    assert perform.onnx.__defaults__[1] == "pt2"
