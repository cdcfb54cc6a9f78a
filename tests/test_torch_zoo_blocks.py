"""Torch port vs the JAX package: the fork's block zoo (CPU, f32).

Each block at small widths on shared numpy-seeded weights (drawn into the
flax trees, carried to the port by its own name map, `_torch_base`) and
inputs: the eval output; then in train mode the output, the BN running
stats after the step, and the gradients of a seeded cotangent with respect
to every parameter and the input. Bar: RTOL = ATOL = 1e-5 throughout, as
tests/test_torch_layers.py holds the flagship's blocks (f32 convs that sum
in another order than XLA's differ by a few ulps of the partial sums). A
gradient tensor is held to that bar in units of its own scale, max(1, its
largest entry): a kernel's gradient sums the cotangent over every position
of the batch (entries up to ~15 here), through train-mode BN's backward,
which cancels, so its rounding is that of an O(1) value times that scale
(1.5e-5 absolute on a tensor of largest entry 11 in C2f's last conv).

SCConv gates each value by sigmoid(gn_x * w / sum(w)) >= 0.5; where gn_x
lies within rounding of 0 the two packages may route it to the other map.
The value is then itself about 0, so the outputs hold the bar, but its
gradient comes from the other output channel; none of these seeds puts a
value that close.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402

from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import _torch_base  # noqa: E402

from test_torch_layers import randomize  # noqa: E402

RTOL = ATOL = 1e-5
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs: the
    suite runs six workers on a few cores, and torch's default (one thread
    a core) spins them against each other. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def module_sd(variables, kind, args=(), dims=()):
    """The port's state_dict of ONE module of `kind` from its flax
    variables, through the port's name map (flax `kernel` HWIO -> OIHW)."""
    sd = {}
    for section in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables.get(section, {}))[0]:
            keys = [str(getattr(p, "key", p)) for p in path]
            base = _torch_base("/".join(keys[:-1]), kind, args, dims)
            arr = np.asarray(leaf)
            if keys[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))
            name = _LEAF.get(keys[-1], keys[-1])
            sd[".".join(p for p in (base, name) if p)] = \
                torch.from_numpy(arr.copy())
    return sd


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(got, want, what, scaled=False):
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max(initial=0.0))) if scaled else 1.0
    np.testing.assert_allclose(got / s, want / s, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def check_block(jmod, tmod, kind, xs, args=(), dims=(), seed=0, head=False):
    """Hold `tmod` to `jmod` on the inputs `xs` (an NHWC array or a list of
    them): eval output, then train output, BN stats and the gradients of
    sum(out * cotangent) with respect to the params and the inputs. A
    `head` returns NHWC maps as JAX does; other blocks NCHW."""
    rng = np.random.default_rng(seed)
    out_nhwc = (lambda t: t.detach().numpy()) if head else _nhwc
    many = isinstance(xs, list)
    jx = [jnp.asarray(x) for x in xs] if many else jnp.asarray(xs)
    v = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jx), rng)
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    tmod.load_state_dict(module_sd(v, kind, args, dims), strict=True)
    tx = [_nchw(x) for x in xs] if many else _nchw(xs)

    as_list = lambda o: list(o) if isinstance(o, (list, tuple)) else [o]
    shapes = as_list(jax.eval_shape(jmod.apply, v, jx))
    cots = [rng.normal(0, 1, w.shape).astype(np.float32) for w in shapes]

    @jax.jit
    def both(v, x, cot):
        """The eval output, then the train output, BN update and vjp."""
        def f(p, x):
            return jmod.apply({"params": p, "batch_stats": v["batch_stats"]},
                              x, train=True, mutable=["batch_stats"])
        out, vjp, upd = jax.vjp(f, v["params"], x, has_aux=True)
        return jmod.apply(v, x), out, upd, vjp(cot)
    want_eval, want, upd, (gparams, gx) = both(v, jx, cots if head else cots[0])

    tmod.eval()
    with torch.no_grad():
        got = as_list(tmod(tx))
    for g, w in zip(got, as_list(want_eval)):
        _close(out_nhwc(g), w, "eval")
    want = as_list(want)

    tmod.train()
    tx = [t.requires_grad_() for t in tx] if many else tx.requires_grad_()
    got = as_list(tmod(tx))
    loss = 0
    for g, w, c in zip(got, want, cots):
        _close(out_nhwc(g), w, "train")
        c = torch.from_numpy(c)
        loss = loss + (g * (c if head else c.permute(0, 3, 1, 2))).sum()
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(
        loss, [p for _, p in tmod.named_parameters()]
        + (list(tx) if many else [tx]))
    want_sd = module_sd({"params": gparams,
                         "batch_stats": upd.get("batch_stats", {})},
                        kind, args, dims)
    state = tmod.state_dict()
    for k in want_sd:
        if "running_" in k:
            _close(state[k].numpy(), want_sd[k].numpy(), k)
    assert set(names) == {k for k in want_sd if "running_" not in k}
    for n, g in zip(names, grads):
        _close(g.numpy(), want_sd[n].numpy(), f"grad {n}", scaled=True)
    for g, w in zip(grads[len(names):], gx if many else [gx]):
        _close(_nhwc(g), w, "grad input", scaled=True)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("k,d,g,bias", [(3, 2, 1, True), (3, 1, 2, False),
                                        (5, 1, 1, True), (3, 3, 1, True)])
def test_conv2d(k, d, g, bias):
    check_block(JL.Conv2d(c2=8, k=k, d=d, g=g, bias=bias),
                TL.Conv2d(6, 8, k, d=d, g=g, bias=bias), "Conv2d",
                _x((2, 9, 10, 6)))


def test_pconv():
    check_block(JL.PConv(), TL.PConv(16), "PConv", _x((2, 8, 7, 16)))


@pytest.mark.parametrize("kind,e,c1", [("pconv", 0.5, 16), ("pconv", 1.0, 16),
                                       ("pconv_n", 1.0, 16),
                                       ("pconv_n", 0.5, 12)])
def test_pconv_bottleneck(kind, e, c1):
    jcls = JL.PconvBottleneck if kind == "pconv" else JL.PconvBottleneckN
    name = "PconvBottleneck" if kind == "pconv" else "PconvBottleneckN"
    check_block(jcls(c2=16, e=e), TL.PconvBottleneck(c1, 16, True, e, kind),
                name, _x((2, 8, 8, c1)))


def test_group_batchnorm():
    check_block(JL.GroupBatchnorm2d(), TL.GroupBatchnorm2d(32),
                "GroupBatchnorm2d", _x((2, 5, 6, 32)))


def test_cru():
    check_block(JL.CRU(16), TL.CRU(16), "CRU", _x((2, 7, 8, 16)))


@pytest.mark.parametrize("c", [16, 32])
def test_scconv(c):
    check_block(JL.SCConv(c), TL.SCConv(c), "SCConv", _x((2, 7, 6, c), c))


SC_KINDS = {"scconv": "SCConvBottleneck", "sc_pw": "SCPWBottleneck",
            "sc_conv3": "SCConv3Bottleneck", "conv3_sc": "Conv3SCBottleneck",
            "sc_pw_pw": "SCPWPWBottleneck"}


@pytest.mark.parametrize("kind", list(SC_KINDS))
def test_sc_bottleneck(kind):
    jcls = getattr(JL, SC_KINDS[kind])
    check_block(jcls(c2=16), TL.SCBottleneck(16, 16, True, kind),
                SC_KINDS[kind], _x((2, 8, 6, 16)))


@pytest.mark.parametrize("shortcut", [True, False])
def test_c2(shortcut):
    check_block(JL.C2(c2=16, n=2, shortcut=shortcut),
                TL.C2(12, 16, 2, shortcut), "C2", _x((2, 7, 9, 12)))
