"""Torch port vs the JAX package: train-mode BN, the optimizer and the EMA
(CPU, f32), on shared numpy-seeded inputs. Tolerances are stated per test:
each side rounds the same f32 arithmetic once per op, in its own order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels,
    opt_update as jax_opt_update)
from dedark_yolo_tpu.nn import layers as JL  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_update as jax_ema_update  # noqa: E402

from dedark_yolo_tpu_torch.engine.optim import (  # noqa: E402
    init_opt_state, label_params, opt_update)
from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402
from dedark_yolo_tpu_torch.utils.ema import ema_update  # noqa: E402

from test_torch_layers import module_state_dict, nchw, nhwc, randomize  # noqa: E402

T = torch.from_numpy


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0.5, 1.2, shape).astype(np.float32)


def _train_pair(jmod, tmod, name, xs, args=()):
    """Apply `jmod` in train mode and `tmod` in train mode on the same
    randomised weights; return outputs and both sets of new BN stats."""
    jx = [jnp.asarray(x) for x in xs] if isinstance(xs, list) else jnp.asarray(xs)
    v = randomize(jmod.init(jax.random.PRNGKey(0), jx), np.random.default_rng(0))
    want, upd = jmod.apply(v, jx, train=True, mutable=["batch_stats"])
    tmod.load_state_dict(module_state_dict(v, name, args), strict=True)
    tmod.train()
    tx = [nchw(x) for x in xs] if isinstance(xs, list) else nchw(xs)
    got = tmod(tx)
    want_sd = module_state_dict({"batch_stats": upd["batch_stats"]}, name, args)
    return want, got, want_sd, tmod.state_dict()


def test_train_bn_matches_flax_on_three_samples():
    """Conv + BN + SiLU on a (3, 2, 2) batch: n = 12 values a channel, so an
    unbiased running variance would be 12/11 of the biased one."""
    x = _x((3, 2, 2, 5))
    want, got, want_sd, got_sd = _train_pair(JL.Conv(c2=6, k=1, s=1),
                                             TL.Conv(5, 6, 1, 1), "Conv", x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=0, atol=1e-6)
    assert "bn.num_batches_tracked" not in got_sd
    # what stock BatchNorm2d's update would give is far off
    with torch.no_grad():
        y = TL.Conv(5, 6, 1, 1)
        y.load_state_dict(got_sd)
        h = y.conv(nchw(x))
    rv0 = module_state_dict(randomize(JL.Conv(c2=6, k=1, s=1).init(
        jax.random.PRNGKey(0), jnp.asarray(x)), np.random.default_rng(0)),
        "Conv")["bn.running_var"]
    unbiased = 0.97 * rv0 + 0.03 * h.var((0, 2, 3), unbiased=True)
    assert (unbiased - got_sd["bn.running_var"]).abs().max() > 1e-3


def test_train_asff_commute_matches_jax():
    """AsffTribeLevel level 2 in training: the weight branches of the
    upsampled inputs are computed small and upsampled in both packages, and
    the batch stats of the small maps are those of the upsampled ones."""
    xs = [_x((2, 2, 2, 16), 1), _x((2, 4, 4, 16), 2), _x((2, 8, 8, 8), 3)]
    want, got, want_sd, got_sd = _train_pair(
        JL.AsffTribeLevel(level=2), TL.AsffTribeLevel(2, (16, 16, 8)),
        "AsffTribeLevel", xs, (2,))
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def _opt_trees(seed, scale):
    """A params tree with every label and gradients of the given scale."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"kernel": (3, 3, 4, 8)},
              "bn": {"scale": (8,), "bias": (8,)},
              "fc": {"kernel": (16, 8), "bias": (8,)}}
    draw = lambda s: {k: {n: rng.normal(0, scale, sh).astype(np.float32)
                          for n, sh in v.items()} for k, v in s.items()}
    return draw(shapes)


def _flat(tree):
    return {f"{k}.{n}": T(np.array(a)) for k, v in tree.items()
            for n, a in v.items()}


@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_opt_update_matches_jax(kind, clip):
    """Two windows of accumulate=2 (four calls): labels, the summed
    gradient, the global-norm clip at 10 (active with gradients of scale 5),
    the updates (1e-6 relative) and the buffers (1e-5 relative, or 1e-6 of
    the tensor's largest entry where mu * buf + g cancels)."""
    gscale = 5.0 if clip == "active" else 0.05
    params = _opt_trees(0, 0.5)
    grads = [_opt_trees(i + 1, gscale) for i in range(4)]
    kw = dict(kind=kind, weight_decay=0.0005 * 2, accumulate=2)
    hyp = [(0.08, 0.002, 0.85), (0.06, 0.003, 0.88), (0.04, 0.004, 0.9),
           (0.02, 0.005, 0.92)]
    jp, js = params, jax_init_opt(params)
    jl = jax_labels(params)
    tp = _flat(params)
    ts = init_opt_state(tp)
    tl = label_params(tp)
    assert tl == {f"{k}.{n}": v for k, d in jl.items() for n, v in d.items()}
    norms = []
    for g, (lb, lr, mu) in zip(grads, hyp):
        jp, js, japplied = jax_opt_update(
            jp, g, js, jl, lr_bias=jnp.float32(lb), lr=jnp.float32(lr),
            momentum=jnp.float32(mu), **kw)
        applied = opt_update(tp, _flat(g), ts, tl, lr_bias=lb, lr=lr,
                             momentum=mu, **kw)
        assert applied == bool(japplied)
        norms.append(np.sqrt(sum(float((a ** 2).sum()) for d in g.values()
                                 for a in d.values())))
        for name, want in _flat(jp).items():
            np.testing.assert_allclose(tp[name].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    for mine, theirs in ((ts.buf, js.buf), (ts.buf2, js.buf2)):
        for name, want in _flat(theirs).items():
            np.testing.assert_allclose(mine[name].numpy(), want.numpy(),
                                       rtol=1e-5,
                                       atol=1e-6 * float(want.abs().max()),
                                       err_msg=name)
    assert ts.step == int(js.step) == 2 and ts.micro == int(js.micro) == 0
    assert (min(norms) * 2 > 10) == (clip == "active")


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    ema = {"a": rng.normal(size=(4, 3)).astype(np.float32),
           "b": rng.normal(size=(5,)).astype(np.float32)}
    tema = {k: T(v.copy()) for k, v in ema.items()}
    jema, ju, tu = jax_ema_init(ema), jnp.int32(0), 0
    for i in range(3):
        cur = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
               for k, v in ema.items()}
        jema, ju = jax_ema_update(jema, cur, ju)
        tu = ema_update(tema, {k: T(v) for k, v in cur.items()}, tu)
        if i == 1:      # also at a large update count
            ju, tu = jnp.int32(3000), 3000
    assert tu == int(ju) == 3001
    for k in ema:
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]),
                                   rtol=0, atol=1e-6)
