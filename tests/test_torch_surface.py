"""The port's public surface held to the JAX package's, module by module.

For each module of `dedark_yolo_tpu/` (one case each), every public name
it defines (every top-level function, class and constant not starting
with `_`; a package's `__all__` as well) must be importable from the
port's module of the same path, or stand in ALLOWLIST with one of the
admitted reasons. Each counterpart of a function, of a class that is not a
flax module, and of a public method of such a class must take JAX's
parameters first, in JAX's order, with JAX's names and JAX's defaults
where JAX has one; a parameter only the port has comes after them, and
JAX's `*args`/`**kwargs` stay. A difference that stays is one ALLOWLIST
line `module:name(jax params->port params)`, the parameters taken out of
both sides before the comparison. No ALLOWLIST line may name something
that the port now has or that now matches: the list only shrinks.

A flax module's fields are not compared with its torch module's
constructor: flax infers the input widths at the first call, and the torch
module takes them first (`c1`, `ch`, `dims`); `parse_model` builds both
from the same yaml row (tests/test_torch_layers*.py, ..._zoo_*.py hold
each block to JAX's). The values of the functions added or changed to
match JAX's surface are held to JAX's in the `test_*_matches_jax` cases
below.
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JAX_ROOT = Path(__file__).resolve().parents[1] / "dedark_yolo_tpu"
# JAX modules whose counterparts live at another path of the port
MOVED = {
    "engine.results_extra": "engine.results",
    "ops.pallas": "ops",
    "ops.pallas.enhance_kernel": "ops.enhance_kernel",
    "ops.pallas.int8_conv": "ops.int8_conv",
}

# The reasons a JAX name may stay unported or differ, and nothing else.
TPU = "TPU layout"
TREE = "JAX tree or sharding idiom; port:"
PALLAS = "Pallas internal"
NOT_QUEUED = "ROADMAP Not queued:"
NO_YAML = "names JAX's default.yaml, which the port does not ship"
REASONS = (TPU, TREE, PALLAS, NOT_QUEUED, NO_YAML)
FUSED_OPT = f"{TPU}: the flat-master fused optimizer"
TRAINERS = (("trainer", "Base"), ("trainer", "Detection"),
            ("classify", "Classification"), ("segment", "Segmentation"),
            ("pose", "Pose"))

# `module:name` for a name (the line of the module that defines it covers
# a package's re-export), `module:name(jax->port)` for parameters,
# `module` for a whole module
ALLOWLIST = {
    # -- ROADMAP "Not queued" ------------------------------------------------
    "utils.downloads": f"{NOT_QUEUED} utils/downloads.py needs network",
    "utils.torch_import": f"{NOT_QUEUED} utils/torch_import.py; the port's "
                          "state_dict already uses the flax names",
    "ops.letterbox:letterbox_jax": f"{NOT_QUEUED} letterbox_jax",
    "nn.enhance:tone_filter": f"{NOT_QUEUED} tone_filter",
    "nn.layers:FC": f"{NOT_QUEUED} FC, which no module or yaml row of "
                    "either package builds",
    "nn.enhance:TONE_SLOTS": f"{NOT_QUEUED} tone_filter's slots",
    "nn.enhance:TONE_CURVE_RANGE": f"{NOT_QUEUED} tone_filter's range",
    "nn.enhance:CURVE_STEPS": f"{NOT_QUEUED} tone_filter's steps",
    "cfg:get_cfg(cfg->cfg)": f"{NOT_QUEUED} the stablehlo format: the "
                             "defaults' format is 'pt2'",
    "engine.benchmarks:benchmark_formats(formats->formats)":
        f"{NOT_QUEUED} the stablehlo format: 'pt2' in place of 'bin'",
    # -- cfg: the yaml the port does not ship (no PyYAML on the card) --------
    "cfg:CFG_DIR": NO_YAML,
    "cfg:DEFAULT_CFG_PATH": NO_YAML,
    # -- TPU layouts ---------------------------------------------------------
    **{f"engine.optim:{n}": FUSED_OPT for n in (
        "FlatSpec", "FusedOptState", "fused_opt_available", "flatten_for_opt",
        "flat_spec", "tree_to_flat", "flat_to_tree", "fused_init_opt_state",
        "fused_state_to_tree", "fused_state_from_tree", "fused_opt_update",
        "make_unflatten_diff", "fused_opt_update_flat", "fused_ema_update")},
    "nn.graph:LazyConcat": f"{TPU}: concat elision",
    "nn.graph:find_fpn_fuse": f"{TPU}: fpn_fuse",
    "nn.graph:find_s2d_stem": f"{TPU}: stem_s2d",
    "nn.layers:ELIDE_CONCAT": f"{TPU}: concat elision",
    "nn.layers:set_concat_elision": f"{TPU}: concat elision",
    "nn.layers:ASFF_COMMUTE": f"{TPU}: the ASFF weight-branch commute, "
                              "exact either way",
    "nn.layers:LazyUp": f"{TPU}: fpn_fuse",
    "nn.layers:ConcatConv": f"{TPU}: concat elision",
    "nn.layers:ConvS2DIn": f"{TPU}: stem_s2d",
    "nn.layers:ConvS2DOut": f"{TPU}: stem_s2d",
    "utils.autobatch:V5E_HBM_BYTES": f"{TPU}: a TPU v5e's HBM size",
    # -- JAX tree and sharding idioms, each with the port's counterpart ------
    "utils.checkpoint:restore_tree": f"{TREE} utils.checkpoint.section_tree",
    "utils.checkpoint:tree_to_npz_dict": f"{TREE} utils.checkpoint."
                                         "save_checkpoint",
    "utils:matmul_precision_wrap": f"{TREE} engine.predictor.matmul_precision",
    "utils.checks:check_bf16": f"{TREE} engine.benchmarks.benchmark_formats "
                               "(its bf16 rows)",
    "utils.autobatch:device_memory_limit": f"{TREE} utils.autobatch.autobatch "
                                           "(torch.cuda.mem_get_info)",
    "utils.settings:SETTINGS": f"{TREE} utils.settings.get_settings",
    "parallel.mesh:batch_sharding": f"{TREE} parallel.mesh.shard_batch",
    "parallel.mesh:replicated": f"{TREE} parallel.mesh.replicate",
    "nn.graph:YOLOGraph": f"{TREE} nn.graph.DetectionModel",
    "nn.layers:fuse_repconv_variables": f"{TREE} nn.layers.fuse_repconv",
    "nn.graph:DetectionModel.init": f"{TREE} utils.weights.init_weights",
    "nn.graph:DetectionModel.apply_train": f"{TREE} nn.graph.DetectionModel."
                                           "forward",
    "nn.graph:DetectionModel.apply_eval": f"{TREE} nn.graph.DetectionModel."
                                          "eval_outputs",
    "nn.graph:DetectionModel.num_params": f"{TREE} engine.model.YOLO.info",
    "nn.graph:DetectionModel.tta_eval(variables->)": f"{TREE} nn.graph."
                                                     "DetectionModel.tta_eval",
    "nn.graph:DetectionModel.eval_outputs(variables->)":
        f"{TREE} nn.graph.DetectionModel.eval_outputs",
    "ops.anchors:make_anchors(dtype->device)": f"{TREE} ops.anchors."
                                               "make_anchors",
    "parallel.mesh:shard_batch(axis,spatial_axis->keys)":
        f"{TREE} parallel.mesh.shard_batch",
    "parallel.mesh:replicate(tree->tensors)": f"{TREE} parallel.mesh.replicate",
    "parallel.spatial:spatial_infer(variables->)": f"{TREE} parallel.spatial."
                                                   "spatial_infer",
    "utils.autobatch:autobatch(step_fn,example_args_fn->measure,device)":
        f"{TREE} utils.autobatch.autobatch",
    **{f"engine.{m}:{c}Predictor(params,batch_stats->)": f"{TREE} engine."
       f"{m}.{c}Predictor (the weights of `model`)" for m, c in (
           ("predictor", "Detection"), ("classify", "Classification"),
           ("segment", "Segmentation"), ("pose", "Pose"))},
    **{f"engine.{m}:{c}Trainer.make_loss_fn": f"{TREE} engine.trainer."
       "BaseTrainer.loss" for m, c in TRAINERS},
    "engine.trainer:BaseTrainer.make_train_step": f"{TREE} engine.trainer."
                                                  "BaseTrainer.step",
    "engine.trainer:BaseTrainer.model_init_batch": f"{TREE} utils.weights."
                                                   "init_weights",
    # -- Pallas internals ----------------------------------------------------
    "ops.pallas.enhance_kernel:banded_blur_matrices": f"{PALLAS}: the blur "
                                                      "as MXU products",
    "ops.pallas.enhance_kernel:fused_enhance_pallas": f"{PALLAS}; the port's "
                                                      "op is fused_enhance",
    "ops.pallas.enhance_kernel:usm_pallas": f"{PALLAS}; the port's op is usm",
    "ops.pallas.enhance_kernel:fused_enhance_diff": f"{PALLAS}; the port's "
                                                    "op's autograd",
    "ops.pallas.enhance_kernel:fused_enhance(interpret->)": f"{PALLAS}: the "
                                                            "interpret mode",
    "ops.pallas.int8_conv:conv3x3_s1_w8a8(th,taps,interpret->)":
        f"{PALLAS}: the block rows, the taps and the interpret mode",
}


def jax_modules():
    out = []
    for p in sorted(JAX_ROOT.rglob("*.py")):
        rel = p.relative_to(JAX_ROOT).with_suffix("")
        out.append(".".join(x for x in rel.parts if x != "__init__"))
    return out


def public_names(path, module):
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    names += list(getattr(module, "__all__", ()))
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def source_of(rel):
    base = JAX_ROOT.joinpath(*rel.split("."))
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _same(a, b):
    try:
        return bool(a is b or a == b)
    except Exception:
        return repr(a) == repr(b)


def params_line(key):
    """The ALLOWLIST line `key(jax->port)` and its two sets, or None."""
    for line in ALLOWLIST:
        if line.startswith(key + "("):
            j, p = line[len(key) + 1:-1].split("->")
            return (line, set(filter(None, j.split(","))),
                    set(filter(None, p.split(","))))
    return None


def compare(jax_fn, port_fn, key, drop_j=(), drop_p=()):
    """Problems of port_fn's parameters against jax_fn's, with `drop_j` and
    `drop_p` taken out first."""
    port_fn = getattr(port_fn, "_init_fn", port_fn)   # a torch custom op
    try:
        js, ps = inspect.signature(jax_fn), inspect.signature(port_fn)
    except (TypeError, ValueError):
        return []
    P = inspect.Parameter
    fixed = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
    jpos = [q for q in js.parameters.values()
            if q.kind in fixed and q.name not in drop_j]
    ppos = [q for q in ps.parameters.values()
            if q.kind in fixed and q.name not in drop_p]
    pnames = {q.name: q for q in ps.parameters.values()}
    bad = []
    for i, q in enumerate(jpos):
        r = ppos[i] if i < len(ppos) else None
        if r is None or r.name != q.name:
            bad.append(f"{key}: parameter {i} is {r and r.name!r}, JAX's "
                       f"{q.name!r} ({js} against {ps})")
            break
        if q.default is not P.empty and not _same(q.default, r.default):
            bad.append(f"{key}({q.name}): default {r.default!r}, JAX's "
                       f"{q.default!r}")
    for q in js.parameters.values():
        if q.name in drop_j:
            continue
        if q.kind == P.KEYWORD_ONLY:
            r = pnames.get(q.name)
            if r is None or (q.default is not P.empty
                             and not _same(q.default, r.default)):
                bad.append(f"{key}: keyword {q.name!r} differs")
        elif q.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD) and not any(
                r.kind == q.kind for r in ps.parameters.values()):
            bad.append(f"{key}: JAX's {q} has no counterpart")
    return bad


def checked(jax_fn, port_fn, keys):
    """compare() under the first of `keys` that has a parameters line; a
    line whose difference is gone is itself a problem."""
    for key in keys:
        found = params_line(key)
        if found:
            line, dj, dp = found
            bad = compare(jax_fn, port_fn, key, dj, dp)
            if not bad and not compare(jax_fn, port_fn, key):
                bad = [f"{line} is allowlisted but matches"]
            return bad
    return compare(jax_fn, port_fn, keys[0])


def is_flax(obj):
    return isinstance(obj, type) and issubclass(obj, fnn.Module)


def home(rel, obj):
    """The JAX module that defines `obj`, relative to the package."""
    mod = getattr(obj, "__module__", None) or ""
    if mod.startswith("dedark_yolo_tpu."):
        return mod[len("dedark_yolo_tpu."):]
    return rel


def port_module(rel):
    rel = MOVED.get(rel, rel)
    return importlib.import_module(
        "dedark_yolo_tpu_torch" + (f".{rel}" if rel else ""))


def surface_problems(rel):
    jm = importlib.import_module("dedark_yolo_tpu" + (f".{rel}" if rel else ""))
    names = public_names(source_of(rel), jm)
    if rel in ALLOWLIST:
        with pytest.raises(ModuleNotFoundError):
            port_module(rel)
        return []
    pm = port_module(rel)
    bad = []
    for name in names:
        a = getattr(jm, name)
        keys = list(dict.fromkeys([f"{rel}:{name}", f"{home(rel, a)}:{name}"]))
        if any(k in ALLOWLIST for k in keys):
            if hasattr(pm, name):
                bad.append(f"{keys[0]} is allowlisted but the port has it")
            continue
        if not hasattr(pm, name):
            bad.append(f"{keys[0]} is missing from dedark_yolo_tpu_torch."
                       f"{MOVED.get(rel, rel)}")
            continue
        b = getattr(pm, name)
        if inspect.ismodule(a) or not callable(a) or is_flax(a):
            continue
        bad += checked(a, b, keys)
        if not isinstance(a, type):
            continue
        for meth, fn in vars(a).items():
            if meth.startswith("_") or not inspect.isfunction(fn):
                continue
            mkeys = [f"{k}.{meth}" for k in keys]
            other = inspect.getattr_static(b, meth, None)
            if isinstance(other, staticmethod):
                other = other.__func__
            if any(k in ALLOWLIST for k in mkeys):
                if inspect.isfunction(other) and not compare(fn, other,
                                                             mkeys[0]):
                    bad.append(f"{mkeys[0]} is allowlisted but matches")
            elif other is None:
                bad.append(f"{mkeys[0]} is missing")
            elif inspect.isfunction(other):
                bad += checked(fn, other, mkeys)
    return bad


@pytest.mark.parametrize("rel", jax_modules(), ids=lambda r: r or "package")
def test_surface_matches_jax(rel):
    bad = surface_problems(rel)
    assert not bad, "\n".join(bad)


def test_allowlist_reasons_and_entries():
    """Every line gives an admitted reason, names a JAX module or a name
    that JAX defines there, and a tree idiom's line names a counterpart
    that the port has."""
    mods = set(jax_modules())
    for key, why in ALLOWLIST.items():
        assert why.startswith(REASONS), (key, why)
        if ":" not in key:
            assert key in mods, key
            continue
        rel, name = key.split(":")
        assert rel in mods, key
        obj = importlib.import_module(f"dedark_yolo_tpu.{rel}")
        for part in name.split("(")[0].split("."):
            obj = getattr(obj, part)
        if why.startswith(TREE):
            parts = why[len(TREE):].split()[0].split(".")
            for cut in range(len(parts), 0, -1):
                try:
                    target = importlib.import_module(
                        "dedark_yolo_tpu_torch." + ".".join(parts[:cut]))
                    break
                except ModuleNotFoundError:
                    continue
            for part in parts[cut:]:
                target = getattr(target, part)


# -- the values of the added or changed functions, against JAX ---------------

def _boxes(rng, n, xywh):
    c = rng.uniform(20, 80, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    b = np.concatenate([c, wh], 1) if xywh else np.concatenate(
        [c - wh / 2, c + wh / 2], 1)
    return b.astype(np.float32)


IOU_KINDS = [{}, {"GIoU": True}, {"DIoU": True}, {"CIoU": True}]


@pytest.mark.parametrize("xywh", [True, False])
@pytest.mark.parametrize("kind", IOU_KINDS, ids=lambda k: next(iter(k), "IoU"))
def test_bbox_iou_matches_jax(xywh, kind):
    """Every combination of the box convention and the IoU kind, by keyword
    and by position, f32 within 1e-6; the Motivation's pair in both."""
    from dedark_yolo_tpu.ops import bbox_iou as jax_iou
    from dedark_yolo_tpu_torch.ops import bbox_iou
    rng = np.random.default_rng(7)
    b1, b2 = _boxes(rng, 64, xywh), _boxes(rng, 64, xywh)
    want = np.asarray(jax_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh,
                              **kind))
    got = bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh,
                   **kind).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    flags = [kind.get(k, False) for k in ("GIoU", "DIoU", "CIoU")]
    pos = bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh,
                   *flags).numpy()
    np.testing.assert_allclose(pos, np.asarray(jax_iou(
        jnp.asarray(b1), jnp.asarray(b2), xywh, *flags)), rtol=0, atol=1e-6)
    a, b = [[50.0, 50.0, 20.0, 40.0]], [[55.0, 45.0, 30.0, 30.0]]
    if not kind and xywh:
        got = bbox_iou(torch.tensor(a), torch.tensor(b)).item()
        assert got == pytest.approx(np.asarray(jax_iou(
            jnp.asarray(a), jnp.asarray(b))).item(), abs=1e-6)
        assert round(got, 4) == 0.5455
        assert bbox_iou(torch.tensor(a), torch.tensor(b), True).item() == \
            pytest.approx(got, abs=1e-7)


def test_box_converters_and_scaling_match_jax():
    from dedark_yolo_tpu.ops import boxes as JB
    from dedark_yolo_tpu_torch.ops import boxes as TB
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 600, (3, 20, 4)).astype(np.float32)
    for fn in ("ltwh2xyxy", "xyxy2ltwh"):
        np.testing.assert_allclose(getattr(TB, fn)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(JB, fn)(jnp.asarray(x))),
                                   rtol=0, atol=1e-6)
    boxes = rng.uniform(0, 640, (20, 4)).astype(np.float32)
    pts = rng.uniform(0, 640, (20, 17, 3)).astype(np.float32)
    for img1, img0, ratio_pad, padding in (
            ((640, 640), (480, 720), None, True),
            ((640, 640), (721, 1280), ((0.5, 0.5), (3.0, 140.5)), True),
            ((384, 640), (360, 640), None, False),
            ((640, 640), (480, 720), ((0.8, 0.8), (12, 7)), False)):
        got = TB.scale_boxes(img1, torch.from_numpy(boxes), img0,
                             ratio_pad=ratio_pad, padding=padding).numpy()
        want = JB.scale_boxes(img1, jnp.asarray(boxes), img0,
                              ratio_pad=ratio_pad, padding=padding)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
        got = TB.scale_coords(img1, torch.from_numpy(pts), img0,
                              ratio_pad=ratio_pad).numpy()
        want = JB.scale_coords(img1, jnp.asarray(pts), img0,
                               ratio_pad=ratio_pad)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_letterbox_geometry_and_checks_match_jax():
    from dedark_yolo_tpu.data.augment import letterbox as jax_letterbox
    from dedark_yolo_tpu.ops.letterbox import letterbox_params as jax_params
    from dedark_yolo_tpu.utils.checks import check_imgsz as jax_check
    from dedark_yolo_tpu_torch.data.augment import letterbox
    from dedark_yolo_tpu_torch.ops import letterbox_params
    from dedark_yolo_tpu_torch.utils.checks import check_imgsz
    for hw, new in (((480, 720), (640, 640)), ((721, 1280), (640, 640)),
                    ((100, 50), (320, 256)), ((640, 640), (640, 640))):
        assert letterbox_params(hw, new) == jax_params(hw, new)
    img = np.random.default_rng(0).integers(0, 256, (48, 80, 3), np.uint8)
    for kw in ({"scale_fill": True}, {"new_shape": 64, "scale_fill": True},
               {"new_shape": (96, 64), "auto": True, "scale_fill": True}, {}):
        got, want = letterbox(img, **kw), jax_letterbox(img, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    for args in ((100,), (640,), (100, 32, 1, 320), ([100, 200],),
                 ([100],), ([100], 32, 2), ([50, 60], 32, 1, 96), (90, 64)):
        assert check_imgsz(*args) == jax_check(*args), args


def test_losses_and_enhance_functions_match_jax():
    from dedark_yolo_tpu.losses.segment import classification_loss as jax_cls
    from dedark_yolo_tpu.nn import enhance as JE
    from dedark_yolo_tpu.nn.layers import get_act as jax_act
    from dedark_yolo_tpu_torch.losses.segment import classification_loss
    from dedark_yolo_tpu_torch.nn import enhance as TE
    from dedark_yolo_tpu_torch.nn.layers import get_act
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    for nbs in (64, 4):
        got = classification_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), nbs)
        want = jax_cls(jnp.asarray(logits), jnp.asarray(labels), nbs)
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), abs=1e-6)
    img = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    usm = rng.uniform(0, 5, (2, 1)).astype(np.float32)
    got = TE.usm_filter_conv(torch.from_numpy(img), torch.from_numpy(usm))
    want = JE.usm_filter_conv(jnp.asarray(img), jnp.asarray(usm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for dt in (np.float32, np.float64):
        k = TE.gaussian_kernel_25(5.0, dt)
        assert k.dtype == dt
        np.testing.assert_array_equal(k, JE.gaussian_kernel_25(5.0, dt))
    x = rng.normal(0, 2, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(TE.tanh_range(torch.from_numpy(x), l=0.1, r=1.0),
                               np.asarray(JE.tanh_range(jnp.asarray(x), l=0.1,
                                                        r=1.0)), atol=1e-6)
    for name in ("silu", "relu", "relu6", "leaky", "identity"):
        np.testing.assert_allclose(get_act(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_act(name)(jnp.asarray(x))),
                                   rtol=0, atol=1e-6)


JAX_BOTTLENECKS = ("PconvBottleneckN", "SCConvBottleneck", "SCPWBottleneck",
                   "SCConv3Bottleneck", "Conv3SCBottleneck", "SCPWPWBottleneck")


@pytest.mark.parametrize("name", JAX_BOTTLENECKS)
def test_jax_named_bottleneck_matches_jax(name):
    """Each JAX-named bottleneck against JAX's class of the same name on
    shared random weights, loaded through the port's name map, in eval
    (tests/test_torch_zoo_blocks.py holds the port's blocks by kind in
    train mode and their gradients too)."""
    import jax
    from dedark_yolo_tpu.nn import layers as JL
    from dedark_yolo_tpu_torch.nn import layers as TL
    from test_torch_layers import randomize
    from test_torch_zoo_blocks import ATOL, RTOL, _nchw, _nhwc, _x, module_sd
    jm, tm = getattr(JL, name)(c2=16), getattr(TL, name)(16, 16).eval()
    x = jnp.asarray(_x((2, 8, 6, 16)))
    v = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x),
                  np.random.default_rng(0))
    tm.load_state_dict(module_sd(v, name), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(np.asarray(x))))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), rtol=RTOL,
                               atol=ATOL)


def test_layers_helpers_and_kpt_shape_match_jax(monkeypatch):
    """NMS's class mask, dist2bbox by `axis`, model_kpt_shape of a pose
    graph with its yaml's and another kpt_shape, and native.available,
    against JAX's."""
    from dedark_yolo_tpu import native as jax_native
    from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load
    from dedark_yolo_tpu.engine.pose import model_kpt_shape as jax_kpt_shape
    from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel
    from dedark_yolo_tpu.ops import dist2bbox as jax_d2b
    from dedark_yolo_tpu.ops import non_max_suppression as jax_nms
    from dedark_yolo_tpu_torch import native
    from dedark_yolo_tpu_torch.cfg import model_yaml_load
    from dedark_yolo_tpu_torch.engine.pose import model_kpt_shape
    from dedark_yolo_tpu_torch.nn import DetectionModel
    from dedark_yolo_tpu_torch.ops import dist2bbox, non_max_suppression
    rng = np.random.default_rng(11)
    dist = rng.uniform(0, 5, (2, 4, 6)).astype(np.float32)
    anchors = rng.uniform(0, 20, (2, 1, 6)).astype(np.float32)
    np.testing.assert_allclose(
        dist2bbox(torch.from_numpy(dist), torch.from_numpy(anchors),
                  axis=1).numpy(),
        np.asarray(jax_d2b(jnp.asarray(dist), jnp.asarray(anchors), axis=1)),
        rtol=0, atol=1e-6)
    boxes = np.concatenate([rng.uniform(50, 500, (1, 300, 2)),
                            rng.uniform(10, 80, (1, 300, 2))], -1
                           ).astype(np.float32)
    scores = rng.uniform(0, 1, (1, 300, 4)).astype(np.float32)
    mask = np.asarray([1, 0, 1, 0], np.float32)
    dets, counts = non_max_suppression(torch.from_numpy(boxes),
                                       torch.from_numpy(scores),
                                       max_nms=256, class_mask=mask)
    jd, jc = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), max_nms=256,
                     class_mask=jnp.asarray(mask))
    assert int(counts[0]) == int(jc[0])
    np.testing.assert_allclose(dets.numpy()[0, :int(counts[0])],
                               np.asarray(jd)[0, :int(jc[0])], rtol=0,
                               atol=1e-4)
    assert set(dets.numpy()[0, :int(counts[0]), 5]) <= {0.0, 2.0}
    for kpt in (None, [5, 2]):
        d, jy = model_yaml_load("yolov8n-pose.yaml"), jax_yaml_load(
            "yolov8n-pose.yaml")
        if kpt:                        # the Pose row's [nc, kpt_shape]
            d["head"][-1][3][1] = jy["head"][-1][3][1] = kpt
        with torch.device("meta"):
            pose = DetectionModel(d, nc=1)
        want = jax_kpt_shape(JaxModel(jy, nc=1))
        assert model_kpt_shape(pose) == want == tuple(kpt or (17, 3))
    assert native.available() is jax_native.available() is True

    def fail(name):
        raise RuntimeError("no compiler")
    monkeypatch.setattr(native, "load", fail)
    assert native.available() is False
