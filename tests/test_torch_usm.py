"""Torch port of the blur-and-sharpen kernel (`ops/enhance_kernel.py` `usm`,
its autograd) and of layer 0's reference-contrast path, against the JAX package on
the CPU: the JAX side runs `usm_pallas` in interpret mode, as its own tests
run it, or its plain `usm_filter`.

Tolerance: 2e-5 relative + 2e-5 absolute in f32, as tests/test_torch_enhance.py
holds the chain (the blur sums 625 products in another order on each side).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import enhance as JE  # noqa: E402
from dedark_yolo_tpu.ops.pallas.enhance_kernel import usm_pallas  # noqa: E402

from dedark_yolo_tpu_torch.nn import enhance as TE  # noqa: E402
from dedark_yolo_tpu_torch.ops import enhance_kernel as TK  # noqa: E402
from dedark_yolo_tpu_torch.ops import _build  # noqa: E402

from test_torch_enhance import _lowlight_sd, _shared_module  # noqa: E402

RTOL = ATOL = 2e-5


def _inputs(b, h, w, seed):
    """A point-filtered-like image (values up to ~3) and strengths in the
    filter's (0, 5) range."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.0, 3.0, (b, h, w, 3)).astype(np.float32)
    s = rng.uniform(0.0, 5.0, (b, 1)).astype(np.float32)
    return y, s


@pytest.mark.parametrize("shape", [(2, 48, 64), (2, 37, 45), (1, 13, 13)],
                         ids=lambda s: "x".join(map(str, s)))
def test_usm_wrapper_matches_jax_pallas_kernel(shape):
    y, s = _inputs(*shape, seed=shape[1])
    want = np.asarray(usm_pallas(jnp.asarray(y), jnp.asarray(s),
                                 interpret=True))
    before = _build.LAUNCHES[TK.USM_NAME]
    got = TK.usm(torch.from_numpy(y), torch.from_numpy(s))
    assert _build.LAUNCHES[TK.USM_NAME] == before  # CPU tensors launch nothing
    assert got.dtype == torch.float32 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_usm_bf16_staging_rounds_once():
    """bf16 y: f32 math, the output rounded once to bf16, so within one bf16
    ulp (2^-8 relative) of the f32 plain result on the same values."""
    y, s = _inputs(2, 30, 41, seed=1)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    out = TK.usm(yb, torch.from_numpy(s))
    assert out.dtype == torch.bfloat16
    ref = TE.usm_filter(yb.float(), torch.from_numpy(s))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2 ** -8,
                               atol=1e-6)


def test_usm_gradient_matches_jax_grad():
    """usm's backward (recompute through the plain version) against jax.grad
    of usm_filter, for y and the strength, loss sum(out^2)."""
    y, s = _inputs(2, 24, 29, seed=7)
    want = jax.grad(lambda a, b: jnp.sum(JE.usm_filter(a, b) ** 2),
                    argnums=(0, 1))(jnp.asarray(y), jnp.asarray(s))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (y, s)]
    (TK.usm(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_reference_mode_runs_usm_and_matches_jax(monkeypatch):
    """LowlightRecovery(contrast_mode='reference') goes through the `usm`
    wrapper once and still equals JAX's module on shared weights."""
    calls = []
    real = TK.usm

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(TK, "usm", counting)
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 80, 3)).astype(np.float32)
    v, want = _shared_module(JE.LowlightRecovery(contrast_mode="reference"), x)
    mod = TE.LowlightRecovery(contrast_mode="reference")
    mod.load_state_dict(_lowlight_sd(v["params"]), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert len(calls) == 1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
