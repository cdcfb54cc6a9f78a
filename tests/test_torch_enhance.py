"""Torch port of layer 0 vs the JAX package: the plain filter chain, the
resize, ExtractParameters2, LowlightRecovery and the gradient of the fused
enhance Function (CPU, f32).

Tolerances: the chain's gamma stage amplifies input rounding by up to
gamma * |log v| (< 30 here) and outputs reach ~10, so f32 agreement is held
to 2e-5 relative + 2e-5 absolute, several times what the inputs below show. The
JAX side runs its Pallas kernel as its own tests do: interpret mode on CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import enhance as JE  # noqa: E402
from dedark_yolo_tpu.ops.pallas.enhance_kernel import (  # noqa: E402
    fused_enhance as jax_fused_enhance, fused_enhance_pallas, _fits_full)

from dedark_yolo_tpu_torch.nn import enhance as TE  # noqa: E402
from dedark_yolo_tpu_torch.ops import enhance_kernel as TK  # noqa: E402
from dedark_yolo_tpu_torch.ops import _build  # noqa: E402

from test_torch_layers import randomize  # noqa: E402

RTOL = ATOL = 2e-5
SIZES = [(48, 64), (37, 45), (128, 128), (256, 256)]


def _inputs(b=2, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.02, 0.98, (b, h, w, 3)).astype(np.float32)
    feats = rng.normal(0, 0.7, (b, 15)).astype(np.float32)
    A = rng.uniform(0.6, 0.9, (b, 3)).astype(np.float32)
    ica = rng.uniform(0.2, 0.8, (b, h, w, 1)).astype(np.float32)
    return img, feats, A, ica


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("mode", ["channel", "reference"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_chain_matches_jax_chain(hw, mode):
    xs = _inputs(h=hw[0], w=hw[1], seed=hw[0])
    want = np.asarray(JE.apply_filter_chain(*map(jnp.asarray, xs), mode))
    got = TE.apply_filter_chain(*_t(*xs), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_wrapper_matches_jax_pallas_kernel(hw):
    """The port's kernel wrapper (plain version on CPU) against the JAX
    kernel dispatcher in interpret mode: fused_enhance_pallas where it takes
    the shape, else its blur-only Pallas kernel (37x45 fits no column
    tiling of the one-pass kernel)."""
    xs = _inputs(h=hw[0], w=hw[1], seed=hw[1])
    jx = list(map(jnp.asarray, xs))
    fn = fused_enhance_pallas if _fits_full(*hw) else jax_fused_enhance
    want = np.asarray(fn(*jx, interpret=True))
    before = _build.LAUNCHES[TK.NAME]
    got = TK.fused_enhance(*_t(*xs)).numpy()
    assert _build.LAUNCHES[TK.NAME] == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_default_priors_and_bf16_staging():
    img, feats, _, _ = _inputs(seed=3)
    b, h, w, _ = img.shape
    A = np.full((b, 3), TE.DEFAULT_A, np.float32)
    ica = np.full((b, h, w, 1), TE.DEFAULT_ICA, np.float32)
    want = np.asarray(fused_enhance_pallas(*map(jnp.asarray, (img, feats, A, ica)),
                                           interpret=True))
    np.testing.assert_allclose(TK.fused_enhance(*_t(img, feats, A, ica)).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    # bf16 image: f32 math, output rounded once to bf16 (<= 1 bf16 ulp, 2^-8)
    tb = torch.from_numpy(img).to(torch.bfloat16)
    out = TK.fused_enhance(tb, *_t(feats, A, ica))
    assert out.dtype == torch.bfloat16
    ref = TE.apply_filter_chain(tb.float(), *_t(feats, A, ica))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2 ** -8,
                               atol=1e-6)


def test_param_vec_matches_jax_slots():
    from dedark_yolo_tpu.ops.pallas.enhance_kernel import _param_vec
    _, feats, A, _ = _inputs(seed=4)
    want = np.asarray(_param_vec(jnp.asarray(feats), jnp.asarray(A)))
    np.testing.assert_allclose(TK.param_vec(*_t(feats, A)).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TK.gaussian_taps(torch.device("cpu")).numpy(),
                               JE.gaussian_kernel_25(), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(640, 480), (256, 256), (100, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_jax(hw):
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(JE.torch_bilinear_resize(jnp.asarray(x), 256, 256))
    got = TE.torch_bilinear_resize(torch.from_numpy(x), 256, 256).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _shared_module(jmod, x, seed=0):
    v = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                  np.random.default_rng(seed))
    return v, np.asarray(jmod.apply(v, jnp.asarray(x)))


def _lowlight_sd(params):
    """Port keys of LowlightRecovery from its flax params (one spec)."""
    from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax
    from dedark_yolo_tpu_torch.nn.graph import LayerSpec

    class One:
        specs = (LayerSpec(0, (-1,), 1, "lowlight_recovery", (3,), 3, 1),)
    sd = state_dict_from_jax({"params": {"mods_0": params},
                              "batch_stats": {}}, One)
    return {k[len("model.0."):]: v for k, v in sd.items()}


def test_extractor_matches_jax():
    x = np.random.default_rng(2).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    v, want = _shared_module(JE.ExtractParameters2(), x)
    mod = TE.LowlightRecovery()
    mod.load_state_dict(_lowlight_sd({"ExtractParameters2_0": v["params"]}))
    with torch.no_grad():
        got = mod.extractor(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["channel", "reference"])
def test_lowlight_recovery_matches_jax(mode):
    """Whole layer 0 on shared weights, default priors, 96x128 input."""
    x = np.random.default_rng(5).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    v, want = _shared_module(JE.LowlightRecovery(contrast_mode=mode), x)
    mod = TE.LowlightRecovery(contrast_mode=mode)
    mod.load_state_dict(_lowlight_sd(v["params"]), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_enhance_gradient_matches_jax_grad():
    """The fused_enhance op's backward (recompute through the plain chain) against
    jax.grad of apply_filter_chain, for every input, loss sum(out^2)."""
    xs = _inputs(h=40, w=56, seed=9)
    want = jax.grad(lambda *a: jnp.sum(JE.apply_filter_chain(*a) ** 2),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, xs))
    ts = [t.requires_grad_(True) for t in _t(*xs)]
    (TK.fused_enhance(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * scale)


def test_fused_enhance_gradient_only_where_needed():
    img, feats, A, ica = _t(*_inputs(h=20, w=24, seed=11))
    feats.requires_grad_(True)
    TK.fused_enhance(img, feats, A, ica).sum().backward()
    assert feats.grad is not None and img.grad is None
