"""Torch port vs the JAX package: graph parsing, conv blocks and the Detect
head, on shared random weights and inputs (CPU, f32).

The weights are drawn with numpy into the flax variable trees and reach the
port only through its own key mapping (utils/weights.py). Tolerances: f32
convs that sum in another order than XLA's differ by a few float32 ulps of
the partial sums; 1e-5 relative plus 1e-5 absolute on O(1) activations
leaves a margin of about 10x over what these shapes show.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402
from dedark_yolo_tpu.nn import heads as JH  # noqa: E402
from dedark_yolo_tpu.nn.graph import parse_model as jax_parse_model  # noqa: E402

from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402
from dedark_yolo_tpu_torch.nn import heads as TH  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import parse_model  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import _torch_base  # noqa: E402

RTOL = ATOL = 1e-5


def randomize(tree, rng):
    """Numpy copy of a flax variable tree with random values: kernels
    N(0, 1/fan_in), BN scale and var U(0.5, 1.5), biases and means N(0, 0.1)."""
    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def to_plain(tree):
    """flax (Frozen)dict tree -> nested plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def module_state_dict(variables, spec_name, spec_args=()):
    """Port state_dict of ONE module from its flax variables, through the
    port's own name mapping (the per-module part of state_dict_from_jax)."""
    sd = {}
    conv = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    for section in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables.get(section, {}))[0]:
            keys = [str(getattr(p, "key", p)) for p in path]
            base = _torch_base("/".join(keys[:-1]), spec_name, spec_args)
            arr = np.asarray(leaf)
            if keys[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))
            sd[f"{base}.{conv[keys[-1]]}"] = torch.from_numpy(arr.copy())
    return sd


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def run_pair(jmod, tmod, spec_name, xs, spec_args=(), seed=0):
    """Init `jmod` on xs (NHWC numpy or a list of them), randomize, load the
    same weights into `tmod`, and return (jax_out, torch_out) as NHWC."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(x) for x in xs] if isinstance(xs, list) else jnp.asarray(xs)
    v = randomize(jmod.init(jax.random.PRNGKey(0), jx), rng)
    want = jmod.apply(v, jx)
    tmod.load_state_dict(module_state_dict(v, spec_name, spec_args),
                         strict=True)
    tmod.eval()
    with torch.no_grad():
        tx = [nchw(x) for x in xs] if isinstance(xs, list) else nchw(xs)
        got = tmod(tx)
    return want, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2)])
def test_conv_matches_jax(k, s):
    want, got = run_pair(JL.Conv(c2=16, k=k, s=s), TL.Conv(8, 16, k, s),
                         "Conv", _x((2, 13, 10, 8)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c2f_matches_jax(shortcut):
    want, got = run_pair(JL.C2f(c2=16, n=2, shortcut=shortcut),
                         TL.C2f(12, 16, 2, shortcut), "C2f", _x((2, 9, 11, 12)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_sppf_matches_jax():
    want, got = run_pair(JL.SPPF(c2=24, k=5), TL.SPPF(16, 24, 5), "SPPF",
                         _x((2, 7, 9, 16)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_asff_tribe_level_matches_jax(level):
    """L-scale width ratio [P5, P4, P3] = [2c, 2c, c] at c=8; P3 16x16."""
    xs = [_x((2, 4, 4, 16), 1), _x((2, 8, 8, 16), 2), _x((2, 16, 16, 8), 3)]
    want, got = run_pair(JL.AsffTribeLevel(level=level),
                         TL.AsffTribeLevel(level, (16, 16, 8)),
                         "AsffTribeLevel", xs, spec_args=(level,))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_asff_rejects_widths_without_reference_names():
    """The widths the port once refused, (64, 32, 16), now build as JAX
    builds them: level 0 aligns the pooled P4 (32 -> 64) with an AddConv
    that the weight maps name `align_level_1`, ahead of the stride conv in
    the flax order; at equal widths no align conv exists."""
    m = TL.AsffTribeLevel(0, (64, 32, 16))
    assert tuple(m.align_level_1.conv.weight.shape) == (64, 32, 1, 1)
    assert _torch_base("AddConv_0/Conv_0", "AsffTribeLevel", (0,),
                       (64, 32, 16)) == "align_level_1.conv"
    assert _torch_base("AddConv_1/Conv_0", "AsffTribeLevel", (0,),
                       (64, 32, 16)) == "stride_level_2.conv"
    assert not hasattr(TL.AsffTribeLevel(0, (64, 64, 16)), "align_level_1")


def test_detect_and_decode_match_jax():
    """Raw maps equal within f32 conv rounding; the decode then holds boxes
    to 4e-4 px and scores to 1e-6, the ROADMAP's flagship targets."""
    strides = (8, 16, 32)
    xs = [_x((2, 16, 12, 16), 1), _x((2, 8, 6, 32), 2), _x((2, 4, 3, 32), 3)]
    want, got = run_pair(JH.Detect(nc=3, strides=strides),
                         TH.Detect(3, (16, 32, 32), strides), "Detect", xs)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # decode both from the SAME raw maps: the decode itself must agree
    raw = [np.array(w) for w in want]
    jb, js = JH.decode_detections([jnp.asarray(r) for r in raw], 3, strides)
    tb, ts = TH.decode_detections([torch.from_numpy(r) for r in raw], 3,
                                  strides)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=4e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def _jax_model_dicts():
    from pathlib import Path
    d = Path(__file__).resolve().parents[1] / "dedark_yolo_tpu" / "cfg" / "models"
    return sorted(d.glob("*.yaml"))


@pytest.mark.parametrize("path", _jax_model_dicts(), ids=lambda p: p.name)
def test_parse_model_equals_jax(path):
    """The port's copy of parse_model gives the JAX LayerSpecs, save-list and
    head for every architecture of the JAX package, at every scale it has."""
    import yaml
    d = yaml.safe_load(path.read_text())
    for scale in (d.get("scales") or {"": None}):
        dd = dict(d, scale=scale, nc=3)
        try:
            want = jax_parse_model(dd)
        except (NotImplementedError, KeyError, IndexError, ValueError) as e:
            with pytest.raises(type(e)):
                parse_model(dd)
            continue
        specs, save, head = parse_model(dd)
        assert [tuple(vars(s).values()) for s in specs] == \
            [tuple(vars(s).values()) for s in want[0]]
        assert save == want[1] and head == want[2]


def test_builtin_models_equal_jax_yamls():
    """cfg/models.py holds the same rows as the JAX package's yamls."""
    import yaml
    from dedark_yolo_tpu_torch.cfg.models import MODELS
    for path in _jax_model_dicts():
        if path.name in MODELS:
            d = yaml.safe_load(path.read_text())
            assert MODELS[path.name] == d, path.name
