"""Torch port vs the JAX package: RT-DETR's modules (CPU, f32).

`inverse_sigmoid`, the 2D sin-cos position table (square and non-square
maps: its rows are w-major, the sequence h-major, the reference's quirk),
`MLP`, `LayerNorm2d`, `TransformerEncoderLayer` and `AIFI` (a non-square
map, JAX's cm 2048 and 8 heads), the bilinear sampler against JAX's
`_sample_level` with points across the border, `MSDeformAttn` (and its
ring-of-heads offset bias) and the decoder layer; each on numpy-seeded
flax weights carried by the port's name map, output and the gradients of a
seeded cotangent within 1e-5 relative (1e-5 absolute floor); the
attention's key bias, whose gradient is 0, has none in the port. Then the
weight maps' round trip on tests/tiny_rtdetr.yaml: flax tree -> state dict
-> flax tree, names and shapes equal to JAX's init.
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.nn import transformer as JT  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn import transformer as TT  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    init_weights, module_state_from_jax, state_dict_from_jax,
    state_dict_to_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

TINY = str(Path(__file__).resolve().parent / "tiny_rtdetr.yaml")
RTOL = ATOL = 1e-5


def _x(shape, seed=1, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(0, 1, shape).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("lo,hi", [(-0.5, 1.5), (0.0, 1e-4)])
def test_inverse_sigmoid(lo, hi):
    x = _x((3, 50), lo=lo, hi=hi)
    _close(TT.inverse_sigmoid(torch.from_numpy(x)),
           JT.inverse_sigmoid(jnp.asarray(x)), "inverse_sigmoid")


@pytest.mark.parametrize("h,w,dim", [(4, 4, 32), (3, 5, 32), (6, 2, 16)])
def test_sincos_pos_embed(h, w, dim):
    got = TT.sincos_pos_embed_2d(h, w, dim)
    want = JT.sincos_pos_embed_2d(h, w, dim)
    assert tuple(got.shape) == want.shape == (1, h * w, dim)
    _close(got, want, "sincos")


def _pair(jmod, tmod, kind, jargs, targs, cot_seed=7):
    """(port, JAX) of a module on the same randomized weights: its output
    and the gradients of a seeded cotangent to the params and the float
    inputs. `jargs` are JAX's call args, `targs` the port's (tensors that
    require grad get one)."""
    v = to_plain(randomize(jmod.init(jax.random.PRNGKey(0), *jargs),
                           np.random.default_rng(0)))
    tmod.load_state_dict(module_state_from_jax(v, kind), strict=True)
    out, vjp = jax.vjp(lambda p, *a: jmod.apply({"params": p}, *a),
                       v["params"], *jargs)
    cot = np.random.default_rng(cot_seed).normal(
        0, 1, out.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    tout = tmod(*targs)
    return v, (tout, cot, jgrads), out


def _check_grads(tmod, kind, tout, cot, jgrads, tin, jin_pos, to_port=None):
    """Param gradients by the name map, and the input gradient of the
    port's tensor `tin` against JAX's input gradient at `jin_pos`."""
    tout.backward(torch.from_numpy(cot) if to_port is None
                  else to_port(cot))
    want = module_state_from_jax(
        {"params": to_plain(jgrads[0])}, kind)
    for k, p in tmod.named_parameters():
        if k.endswith("key.bias"):
            # 0: the softmax is blind to it; JAX's is the sums' rounding,
            # the port's none (MultiHeadAttention._key)
            assert p.grad is None and float(want[k].abs().max()) < 1e-6, k
            continue
        _close(p.grad, want[k], f"grad {k}")
    if tin is not None:
        g = jgrads[1 + jin_pos]
        _close(tin.grad if to_port is None else _nhwc(tin.grad), g,
               "input grad")


def test_mlp():
    x = _x((2, 7, 12))
    t = TT.MLP(12, 24, 5, 3)
    xt = torch.from_numpy(x).requires_grad_(True)
    v, (tout, cot, jg), want = _pair(JT.MLP(24, 5, 3), t, "MLP",
                                     [jnp.asarray(x)], [xt])
    _close(tout.detach(), want, "MLP")
    _check_grads(t, "MLP", tout, cot, jg, xt, 0)


def test_layer_norm_2d():
    """flax's LayerNorm over channels: epsilon 1e-6 and its variance
    E[x^2] - E[x]^2."""
    x = _x((2, 5, 6, 16)) + 0.5
    t = TT.LayerNorm2d(16)
    xt = _nchw(x).requires_grad_(True)
    v, (tout, cot, jg), want = _pair(JT.LayerNorm2d(), t, "LayerNorm2d",
                                     [jnp.asarray(x)], [xt])
    _close(_nhwc(tout), want, "LayerNorm2d")
    _check_grads(t, "LayerNorm2d", tout, cot, jg, xt, 0, to_port=_nchw)


def test_transformer_encoder_layer():
    x, pos = _x((2, 12, 32)), _x((1, 12, 32), seed=2)
    t = TT.TransformerEncoderLayer(32, 64, 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    v, (tout, cot, jg), want = _pair(
        JT.TransformerEncoderLayer(32, 4, 64), t, "TransformerEncoderLayer",
        [jnp.asarray(x), jnp.asarray(pos)], [xt, torch.from_numpy(pos)])
    _close(tout.detach(), want, "encoder layer")
    _check_grads(t, "TransformerEncoderLayer", tout, cot, jg, xt, 0)


def test_aifi_non_square():
    """AIFI at JAX's defaults (cm 2048, 8 heads) on a 3x5 map: the position
    table's w-major rows against the h-major sequence."""
    x = _x((2, 3, 5, 32))
    t = TT.AIFI(32)
    xt = _nchw(x).requires_grad_(True)
    v, (tout, cot, jg), want = _pair(JT.AIFI(32), t, "AIFI",
                                     [jnp.asarray(x)], [xt])
    _close(_nhwc(tout), want, "AIFI")
    _check_grads(t, "AIFI", tout, cot, jg, xt, 0, to_port=_nchw)


def test_sampler_matches_jax_across_the_border():
    b, h, w, nh, hd, lq, npts = 2, 7, 5, 3, 4, 6, 4
    value = _x((b, h * w, nh, hd))
    loc = _x((b, lq, nh, npts, 2), seed=3, lo=-0.2, hi=1.2)
    got = TT.sample_level(torch.from_numpy(value), torch.from_numpy(loc), h, w)
    want = JT._sample_level(jnp.asarray(value), jnp.asarray(loc), h, w)
    assert tuple(got.shape) == want.shape == (b, lq, nh, npts, hd)
    _close(got, want, "sample_level")


def _levels(c, sizes=((8, 6), (4, 3), (2, 2)), seed=4):
    return [_x((2, h, w, c), seed=seed + i) for i, (h, w) in enumerate(sizes)]


def test_offset_bias_equals_jax():
    j = JT.MSDeformAttn(32, 3, 4, 2)
    t = TT.MSDeformAttn(32, 3, 4, 2)
    _close(t.offset_bias(), j._offset_bias(None, (48,)), "offset bias")


def test_msdeform_attn():
    q = _x((2, 5, 32))
    refer = _x((2, 5, 4), seed=2, lo=0.2, hi=0.8)
    feats = _levels(32)
    t = TT.MSDeformAttn(32, 3, 4, 2)
    qt = torch.from_numpy(q).requires_grad_(True)
    v, (tout, cot, jg), want = _pair(
        JT.MSDeformAttn(32, 3, 4, 2), t, "MSDeformAttn",
        [jnp.asarray(q), jnp.asarray(refer), [jnp.asarray(f) for f in feats]],
        [qt, torch.from_numpy(refer), [_nchw(f) for f in feats]])
    _close(tout.detach(), want, "MSDeformAttn")
    _check_grads(t, "MSDeformAttn", tout, cot, jg, qt, 0)


def test_decoder_layer():
    embed, qpos = _x((2, 6, 32)), _x((2, 6, 32), seed=5)
    refer = _x((2, 6, 4), seed=2, lo=0.1, hi=0.9)
    feats = _levels(32)
    j = JT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2)
    t = TT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2)
    et = torch.from_numpy(embed).requires_grad_(True)
    v = to_plain(randomize(
        j.init(jax.random.PRNGKey(0), jnp.asarray(embed), jnp.asarray(refer),
               [jnp.asarray(f) for f in feats], jnp.asarray(qpos)),
        np.random.default_rng(0)))
    t.load_state_dict(module_state_from_jax(
        v, "DeformableTransformerDecoderLayer"), strict=True)
    out, vjp = jax.vjp(
        lambda p, e: j.apply({"params": p}, e, jnp.asarray(refer),
                             [jnp.asarray(f) for f in feats],
                             query_pos=jnp.asarray(qpos)), v["params"],
        jnp.asarray(embed))
    tout = t(et, torch.from_numpy(refer), [_nchw(f) for f in feats],
             query_pos=torch.from_numpy(qpos))
    _close(tout.detach(), out, "decoder layer")
    cot = np.random.default_rng(7).normal(0, 1, out.shape).astype(np.float32)
    _check_grads(t, "DeformableTransformerDecoderLayer", tout, cot,
                 vjp(jnp.asarray(cot)), et, 0)


def test_weight_map_round_trip():
    """tiny_rtdetr.yaml: JAX's init tree -> the port's state dict -> back,
    the same names, shapes and values; the port's own init maps to a tree
    of JAX's names and shapes."""
    jm = JaxModel(model_yaml_load(TINY))
    tmpl = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    v = to_plain(randomize(tmpl, np.random.default_rng(0)))
    tm = DetectionModel(model_yaml_load(TINY))
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    back = state_dict_to_jax(tm.state_dict(), tm)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    fv, fb = flat(v), flat(back)
    assert set(fv) == set(fb)
    for k in fv:
        np.testing.assert_array_equal(fb[k], fv[k], err_msg=k)
    init_weights(tm, 0)
    mine = flat(state_dict_to_jax(tm.state_dict(), tm))
    assert {k: a.shape for k, a in mine.items()} == \
        {k: a.shape for k, a in fv.items()}
