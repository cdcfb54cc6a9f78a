"""Torch port vs the JAX package: the rest of nn/layers.py (CPU, f32).

The blocks a user's graph may name beyond the flagship and the fork's zoo
(Conv's p/g/d/act, Bottleneck's g/k/e, Conv2, DWConv, LightConv, Focus,
GhostConv, CrossConv, ConvTranspose, the attention blocks, RepConv,
GhostBottleneck, C1, C3, C3x, C3TR with its TransformerBlock, RepC3,
C3Ghost, BottleneckCSP, SPP, HGStem, HGBlock), each held as
tests/test_torch_zoo_blocks.py holds the zoo (`check_block`: numpy-seeded
flax trees carried by the port's name map, `utils.weights.
module_state_from_jax`; the eval output, then the train output, the BN
stats after the step and the gradients of a seeded cotangent, at RTOL =
ATOL = 1e-5). C3 is held to JAX's C3 built with k=(1, 3), the reference's
C3: JAX's default k raises a TypeError (ROADMAP, known differences).
RepConv's deploy form is held to JAX's `_fuse_one_repconv` and to its
train form.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402
from dedark_yolo_tpu.nn import transformer as JT  # noqa: E402

from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402
from dedark_yolo_tpu_torch.nn import transformer as TT  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import module_state_from_jax  # noqa: E402

import test_torch_zoo_blocks as ZB  # noqa: E402
from test_torch_layers import randomize  # noqa: E402
from test_torch_zoo_blocks import _x, few_threads  # noqa: E402,F401


@pytest.fixture(autouse=True)
def port_name_map(monkeypatch):
    """check_block through the port's whole leaf map (transposed conv
    kernels, attention kernels, the position table), not the zoo test's
    conv-only copy of it."""
    monkeypatch.setattr(ZB, "module_sd", module_state_from_jax)


def check_block(jmod, tmod, kind, x, args=(), seed=0):
    ZB.check_block(jmod, tmod, kind, x, args=args, seed=seed)


@pytest.mark.parametrize("k,s,p,g,d,act", [
    (3, 2, 0, 2, 1, "identity"), (3, 1, None, 1, 2, "relu")])
def test_conv_options(k, s, p, g, d, act):
    check_block(JL.Conv(c2=8, k=k, s=s, p=p, g=g, d=d, act=act),
                TL.Conv(6, 8, k, s, p, g, d, act), "Conv", _x((2, 9, 10, 6)))


@pytest.mark.parametrize("c1,shortcut,g,k,e", [
    (16, True, 1, (3, 3), 0.5), (8, False, 2, (1, 3), 1.0)])
def test_bottleneck(c1, shortcut, g, k, e):
    check_block(JL.Bottleneck(c2=16, shortcut=shortcut, g=g, k=k, e=e),
                TL.Bottleneck(c1, 16, shortcut, g, k, e), "Bottleneck",
                _x((2, 7, 8, c1)))


@pytest.mark.parametrize("s,g", [(2, 2)])
def test_conv2(s, g):
    check_block(JL.Conv2(c2=8, k=3, s=s, g=g), TL.Conv2(6, 8, 3, s, g),
                "Conv2", _x((2, 9, 10, 6)))


@pytest.mark.parametrize("c1,s,act", [(12, 2, "relu")])
def test_dwconv(c1, s, act):
    check_block(JL.DWConv(c2=16, k=3, s=s, act=act),
                TL.DWConv(c1, 16, 3, s, act=act), "DWConv",
                _x((2, 9, 8, c1)))


def test_light_conv():
    check_block(JL.LightConv(c2=16, k=5), TL.LightConv(8, 16, 5),
                "LightConv", _x((2, 9, 8, 8)))


def test_focus():
    check_block(JL.Focus(c2=16, k=3), TL.Focus(3, 16, 3), "Focus",
                _x((2, 10, 12, 3)))


def test_ghost_conv():
    check_block(JL.GhostConv(c2=16, k=3, s=2), TL.GhostConv(8, 16, 3, 2),
                "GhostConv", _x((2, 9, 10, 8)))


@pytest.mark.parametrize("k", [(3, 1)])
def test_cross_conv(k):
    check_block(JL.CrossConv(c2=8, k=k), TL.CrossConv(6, 8, k), "CrossConv",
                _x((2, 7, 9, 6)))


@pytest.mark.parametrize("k,s,p,bn", [(2, 2, 0, True), (3, 2, 1, False)])
def test_conv_transpose(k, s, p, bn):
    """Its output size is flax's: (H - 1) * s + 2p - k + 2 (4 -> 6 at k = s
    = 2, p = 0; torch's own layer gives 8)."""
    x = _x((2, 4, 5, 8))
    j = JL.ConvTranspose(c2=6, k=k, s=s, p=p, bn=bn)
    t = TL.ConvTranspose(8, 6, k, s, p, bn)
    want = jax.eval_shape(j.init, jax.random.PRNGKey(0), jnp.asarray(x))
    out = jax.eval_shape(j.apply, want, jnp.asarray(x))
    assert out.shape == (2, 3 * s + 2 * p - k + 2, 4 * s + 2 * p - k + 2, 6)
    with torch.no_grad():
        got = t(torch.zeros(2, 8, 4, 5))
    assert tuple(got.shape) == (2, 6) + out.shape[1:3]
    check_block(j, t, "ConvTranspose", x)


def test_channel_attention():
    check_block(JL.ChannelAttention(), TL.ChannelAttention(16),
                "ChannelAttention", _x((2, 6, 7, 16)))


@pytest.mark.parametrize("k", [3])
def test_spatial_attention(k):
    check_block(JL.SpatialAttention(k=k), TL.SpatialAttention(k),
                "SpatialAttention", _x((2, 9, 8, 6)))


def test_cbam():
    check_block(JL.CBAM(), TL.CBAM(16), "CBAM", _x((2, 9, 10, 16)))


@pytest.mark.parametrize("c1,use_id_bn", [(8, True), (6, True)])
def test_repconv(c1, use_id_bn):
    check_block(JL.RepConv(c2=8, use_id_bn=use_id_bn),
                TL.RepConv(c1, 8, use_id_bn=use_id_bn), "RepConv",
                _x((2, 7, 9, c1)))


@pytest.mark.parametrize("use_id_bn", [False, True])
def test_repconv_deploy_form(use_id_bn):
    """fuse_convs against JAX's `_fuse_one_repconv` (its kernel and bias,
    through the port's name map of `fused`) and the deploy form's output
    against the train form's eval output and JAX's deploy module, at
    tests/test_repconv_fuse.py's id-BN bar (1e-5)."""
    x = _x((2, 7, 9, 8))
    rng = np.random.default_rng(4)
    j = JL.RepConv(c2=8, use_id_bn=use_id_bn)
    v = randomize(jax.eval_shape(j.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x)), rng)
    t = TL.RepConv(8, 8, use_id_bn=use_id_bn).eval()
    t.load_state_dict(module_state_from_jax(v, "RepConv"), strict=True)
    xt = ZB._nchw(x)
    with torch.no_grad():
        train_form = t(xt)
        assert TL.fuse_repconv(t) == 1 and TL.fuse_repconv(t) == 0
        deploy = t(xt)
    # fuse_repconv_variables rewrites the RepConv_* scopes of a tree
    fused = JL.fuse_repconv_variables({k: {"RepConv_0": v[k]} for k in v})
    fused = {k: fused[k].get("RepConv_0", {}) for k in fused}
    want = module_state_from_jax(fused, "RepConv")
    assert set(want) == set(t.state_dict()) == {"conv.weight", "conv.bias"}
    for key, w in want.items():
        np.testing.assert_allclose(t.state_dict()[key].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    jd = JL.RepConv(c2=8, use_id_bn=use_id_bn, deploy=True)
    np.testing.assert_allclose(ZB._nhwc(deploy),
                               np.asarray(jd.apply(fused, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(deploy.numpy(), train_form.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c1,s", [(16, 1), (8, 2)])
def test_ghost_bottleneck(c1, s):
    check_block(JL.GhostBottleneck(c2=16, k=3, s=s),
                TL.GhostBottleneck(c1, 16, 3, s), "GhostBottleneck",
                _x((2, 8, 9, c1)))


def test_c1():
    check_block(JL.C1(c2=16, n=2), TL.C1(8, 16, 2), "C1", _x((2, 7, 8, 8)))


@pytest.mark.parametrize("shortcut", [True])
def test_c3(shortcut):
    check_block(JL.C3(c2=16, n=2, shortcut=shortcut, k=(1, 3)),
                TL.C3(12, 16, 2, shortcut), "C3", _x((2, 7, 9, 12)))


@pytest.mark.parametrize("shortcut", [False])
def test_c3x(shortcut):
    check_block(JL.C3x(c2=16, n=2, shortcut=shortcut),
                TL.C3x(12, 16, 2, shortcut), "C3x", _x((2, 7, 9, 12)))


def test_c3tr():
    check_block(JL.C3TR(c2=32, n=2), TL.C3TR(24, 32, 2, hw=30), "C3TR",
                _x((2, 5, 6, 24)))


def test_transformer_block_conv():
    """TransformerBlock's 1x1 Conv where c1 != c2 (C3TR's never has one)."""
    check_block(JT.TransformerBlock(16, 4, 1),
                TT.TransformerBlock(8, 16, 4, 1, hw=20), "TransformerBlock",
                _x((2, 4, 5, 8)))


def test_transformer_block_size():
    """The position table is sized at init: another map size raises; a
    state dict of another size is taken with its size."""
    t = TL.C3TR(8, 16, 1, hw=16)
    with pytest.raises(ValueError, match="built for a map of 16"):
        t(torch.zeros(1, 8, 5, 5))
    sd = {k: torch.zeros_like(v) for k, v in t.state_dict().items()}
    sd["m.pos"] = torch.ones(1, 25, 8)
    t.load_state_dict(sd)
    assert tuple(t(torch.zeros(1, 8, 5, 5)).shape) == (1, 16, 5, 5)


def test_repc3():
    check_block(JL.RepC3(c2=16, n=2), TL.RepC3(12, 16, 2), "RepC3",
                _x((2, 7, 9, 12)))


def test_c3ghost():
    check_block(JL.C3Ghost(c2=16, n=2), TL.C3Ghost(12, 16, 2), "C3Ghost",
                _x((2, 7, 9, 12)))


@pytest.mark.parametrize("shortcut", [True])
def test_bottleneck_csp(shortcut):
    check_block(JL.BottleneckCSP(c2=16, n=2, shortcut=shortcut),
                TL.BottleneckCSP(16, 16, 2, shortcut), "BottleneckCSP",
                _x((2, 7, 9, 16)))


def test_spp():
    check_block(JL.SPP(c2=16, k=(3, 5, 7)), TL.SPP(12, 16, (3, 5, 7)), "SPP",
                _x((2, 9, 8, 12)))


def test_hgstem():
    check_block(JL.HGStem(cm=16, c2=24), TL.HGStem(3, 16, 24), "HGStem",
                _x((2, 16, 20, 3)))


@pytest.mark.parametrize("c1,lightconv,shortcut", [
    (8, False, False), (16, True, True)])
def test_hgblock(c1, lightconv, shortcut):
    kind = "HGBlockLight" if lightconv else "HGBlock"
    check_block(JL.HGBlock(cm=8, c2=16, k=3, n=3, lightconv=lightconv,
                           shortcut=shortcut),
                TL.HGBlock(c1, 8, 16, 3, 3, lightconv, shortcut), kind,
                _x((2, 7, 9, c1)), args=(8, 16, 3, 3))
