"""Torch port vs the JAX package: RT-DETR in bf16 (`amp=True`), on the CPU.

tests/test_torch_zoo_amp.py's yardstick: the port's bf16 may be no farther
from JAX's bf16 than JAX's bf16 is from JAX's f32 on the same inputs
(factor 1.0), each pair of gaps printed. Held:
  - the modules of nn/transformer.py in train mode, JAX eager (`jax.vjp`),
    on numpy-seeded flax weights cast to bf16 and the dtypes the head gives
    them (maps and query contents bf16, boxes f32): `LayerNorm`,
    `MultiHeadAttention` (biased), `AIFI`, `sample_level`, `MSDeformAttn`
    and the decoder layer; the output, the inputs' gradients and the
    parameters' gradients of a seeded cotangent;
  - `RTDETRDecoder` in train mode (hd 32, ndl 2): its four outputs, the
    gradients and its BN's running-stat moves;
  - one amp micro-step (nbs = batch: the update applies) of
    tests/tiny_rtdetr.yaml and of tests/tiny_rtdetr_l0.yaml (layer 0 and an
    AIFI row, so the bf16 image goes through `fused_enhance`'s plain
    version and AIFI) at imgsz 64, b2, seed 0, against JAX's jitted step:
    loss items, gradients, the update and the BN stats.

The suspects of the bf16 path, each confirmed or cleared by a test here:
  - the bilinear sampler, confirmed: JAX gathers four bf16 corners, sums
    them in f32 with f32 weights, and each corner's gradient rounds to
    bf16 before the gathers' scatter-add; the port's `F.grid_sample` of
    the values in f32 rounded the value gradient once and sat 1.06 times
    JAX's bf16-f32 gap from JAX's bf16 (seed 0 of
    `test_sample_level_bf16_values_within_jax_bf16_gap`, which fails on
    the unrepaired sampler). Repaired: a bf16 `sample_level` is JAX's
    form (`nn/transformer.py::_sample_corners`), now bit-equal at seed 1;
  - flax's LayerNorm statistics, cleared: f32 of a bf16 input,
    E[x^2] - E[x]^2, one rounding; the port's output is bit-equal;
  - the promotion where an f32 box or position meets bf16 weights,
    cleared: flax's Dense promotes input and kernel, so from the query
    position head on the decoder runs in f32, as the port's `Linear` does
    (`attention_f32_query`, the decoder layer and the head's outputs
    within 5e-7 of JAX's bf16);
  - gelu's tanh form, cleared with AIFI's output.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.optim import init_opt_state as jax_init_opt  # noqa: E402
from dedark_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer  # noqa: E402
from dedark_yolo_tpu.nn import transformer as JT  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import RTDETRDecoder as JaxDecoder  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn import transformer as TT  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.nn.heads import RTDETRDecoder  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    module_state_from_jax, state_dict_from_jax)

from test_torch_amp import (NB, STEP, _batch, _gaps, _relnorm,  # noqa: E402
                            jax_opt_update_jit)
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
GRAPHS = {"tiny_rtdetr": str(HERE / "tiny_rtdetr.yaml"),
          "tiny_rtdetr_l0": str(HERE / "tiny_rtdetr_l0.yaml")}
BF16 = jnp.bfloat16
OVERRIDES = {"batch": 2, "nbs": 2, "epochs": 10, "imgsz": 64,
             "optimizer": "SGD", "prior_mode": "computed", "lr0": 0.02}


def _x(shape, seed=1, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(0, 1, shape).astype(np.float32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nchw(x):
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


# ------------------------------------------------------------ the modules
# name: (flax module, port module, name-map kind, inputs, which inputs are
# bf16 in the amp runs, which are NHWC maps (the port's NCHW), call kwargs)
def _mods():
    refer = _x((2, 6, 4), seed=2, lo=0.15, hi=0.85)
    feats = [_x((2, h, w, 32), seed=4 + i) for i, (h, w) in
             enumerate(((8, 6), (4, 3), (2, 2)))]
    return {
        "layer_norm": (JT.LayerNorm2d(), TT.LayerNorm2d(32), "LayerNorm2d",
                       [_x((2, 5, 6, 32)) + 0.5], [True], [True], {}),
        "attention": (JT.nn.MultiHeadDotProductAttention(num_heads=4,
                                                          qkv_features=32),
                      TT.MultiHeadAttention(32, 4, bias=True),
                      "MultiHeadDotProductAttention",
                      [_x((2, 12, 32)), _x((2, 12, 32), seed=2),
                       _x((2, 12, 32), seed=3)], [True] * 3, [False] * 3, {}),
        "attention_f32_query": (
            JT.nn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32),
            TT.MultiHeadAttention(32, 4, bias=True),
            "MultiHeadDotProductAttention",
            [_x((2, 12, 32)), _x((2, 12, 32), seed=2), _x((2, 12, 32), seed=3)],
            [False, False, True], [False] * 3, {}),
        "aifi": (JT.AIFI(32, cm=64), TT.AIFI(32, cm=64), "AIFI",
                 [_x((2, 3, 5, 32))], [True], [True], {}),
        "msdeform_attn": (JT.MSDeformAttn(32, 3, 4, 2),
                          TT.MSDeformAttn(32, 3, 4, 2), "MSDeformAttn",
                          [_x((2, 6, 32)), refer, feats], [True, False, True],
                          [False, False, True], {}),
        "decoder_layer": (JT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                          TT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                          "DeformableTransformerDecoderLayer",
                          [_x((2, 6, 32)), refer, feats,
                           _x((2, 6, 32), seed=5)],
                          [True, False, True, False],
                          [False, False, True, False], {}),
    }


def _jax_run(fn, dtype):
    """JAX's bf16 side runs eagerly, op by op as the port rounds (under
    jax.jit XLA keeps fused bf16 chains in f32: on the head another query
    selection follows); its f32 side, the yardstick's far end, jitted, as
    its one compile costs a fraction of the eager dispatch."""
    return fn if dtype == BF16 else jax.jit(fn)


def _cast(x, dtype):
    if isinstance(x, list):
        return [_cast(a, dtype) for a in x]
    return jnp.asarray(x).astype(dtype)


def _port_in(x, bf16, nhwc):
    """A JAX input as the port's tensor (NCHW for a map), requiring grad."""
    if isinstance(x, list):
        return [_port_in(a, bf16, nhwc) for a in x]
    a = _nchw(x) if nhwc else x
    t = torch.from_numpy(np.ascontiguousarray(_f32(a)).astype(np.float32))
    return (t.to(torch.bfloat16) if bf16 else t).requires_grad_(True)


def _port_grad(t, nhwc):
    if isinstance(t, list):
        return [_port_grad(a, nhwc) for a in t]
    g = t.grad.double().numpy()
    return np.transpose(g, (0, 2, 3, 1)) if nhwc else g


def _flat(xs):
    if isinstance(xs, (list, tuple)):
        return np.concatenate([_flat(a) for a in xs])
    return np.asarray(xs, np.float64).ravel()


def module_triple(name):
    """(the port's bf16, JAX's bf16, JAX's f32) of one module in train
    mode: (output, the inputs' gradients, {param: gradient})."""
    jmod, tmod, kind, xs, bf16, nhwc, kw = _mods()[name]
    jx = [_cast(x, jnp.float32) for x in xs]
    v = to_plain(randomize(jax.eval_shape(lambda *a: jmod.init(
        jax.random.PRNGKey(0), *a, **kw), *jx), np.random.default_rng(0)))
    params = v["params"]
    shape = jax.eval_shape(lambda p, *a: jmod.apply({"params": p}, *a, **kw),
                           params, *jx).shape
    cot = np.random.default_rng(7).normal(0, 1, shape).astype(np.float32)

    def full(p, *args):
        out, vjp = jax.vjp(lambda p, *a: jmod.apply({"params": p}, *a, **kw),
                           p, *args)
        return (out, *vjp(jnp.asarray(cot).astype(out.dtype)))

    def jrun(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        args = [_cast(x, dtype if b else jnp.float32)
                for x, b in zip(xs, bf16)]
        out, gp, *gx = _jax_run(full, dtype)(p, *args)
        gp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), gp)
        return (_f32(out), [jax.tree_util.tree_map(_f32, g) for g in gx],
                module_state_from_jax({"params": to_plain(gp)}, kind))

    tmod.load_state_dict(module_state_from_jax(v, kind), strict=True)
    for prm in tmod.parameters():
        prm.data = prm.data.to(torch.bfloat16)
    tmod.train()
    targs = [_port_in(x, b, m) for x, b, m in zip(xs, bf16, nhwc)]
    out = tmod(*targs)
    tcot = torch.from_numpy(_nchw(cot) if nhwc[0] and out.dim() == 4 else cot)
    out.backward(tcot.to(out.dtype))
    got = out.detach().double().numpy()
    if nhwc[0] and got.ndim == 4:
        got = np.transpose(got, (0, 2, 3, 1))
    grads = {k: p.grad.float() for k, p in tmod.named_parameters()
             if p.grad is not None}
    return ((got, [_port_grad(t, m) for t, m in zip(targs, nhwc)], grads),
            jrun(BF16), jrun(jnp.float32))


def _param_keys(mine, j16, j32):
    """The parameters with a gradient in both packages (the key bias has
    none in the port: `MultiHeadAttention._key`)."""
    keys = [k for k in j32[2] if k in mine[2]
            and float(j32[2][k].abs().max()) > 0]
    assert all(k.endswith("key.bias") for k in set(j32[2]) - set(mine[2]))
    return keys


@pytest.mark.parametrize("name", list(_mods()))
def test_module_bf16_within_jax_bf16_gap(name):
    """One module in bf16 train mode: the output, the float inputs'
    gradients and the parameters' gradients, by the yardstick."""
    mine, j16, j32 = module_triple(name)
    _gaps(f"{name} output", _rel(mine[0], j16[0]), _rel(j16[0], j32[0]))
    for i, (a, b, c) in enumerate(zip(mine[1], j16[1], j32[1])):
        _gaps(f"{name} input {i} gradient", _rel(_flat(a), _flat(b)),
              _rel(_flat(b), _flat(c)))
    keys = _param_keys(mine, j16, j32)
    assert keys
    _gaps(f"{name} param gradients", _relnorm(mine[2], j16[2], keys),
          _relnorm(j16[2], j32[2], keys))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_level_bf16_values_within_jax_bf16_gap(seed):
    """The sampler on bf16 values at f32 points (as MSDeformAttn calls it),
    points across the border: JAX's four masked corner reads in f32
    against `F.grid_sample` of the values in f32."""
    b, h, w, nh, hd, lq, npts = 2, 7, 5, 3, 4, 6, 4
    value = _x((b, h * w, nh, hd), seed=seed)
    loc = _x((b, lq, nh, npts, 2), seed=seed + 3, lo=-0.2, hi=1.2)
    cot = _x((b, lq, nh, npts, hd), seed=seed + 9)

    def jrun(dtype):
        out, vjp = jax.vjp(lambda v, l: JT._sample_level(v, l, h, w),
                           jnp.asarray(value).astype(dtype), jnp.asarray(loc))
        gv, gl = vjp(jnp.asarray(cot).astype(out.dtype))
        return _f32(out), _f32(gv), _f32(gl)
    vt = torch.from_numpy(_f32(jnp.asarray(value).astype(BF16)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    lt = torch.from_numpy(loc).requires_grad_(True)
    out = TT.sample_level(vt, lt, h, w)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    mine = (out.detach().double().numpy(), vt.grad.double().numpy(),
            lt.grad.double().numpy())
    j16, j32 = jrun(BF16), jrun(jnp.float32)
    for i, what in enumerate(("output", "value gradient", "point gradient")):
        _gaps(f"sample_level {what}", _rel(mine[i], j16[i]),
              _rel(j16[i], j32[i]))


# --------------------------------------------------------------- the head
CH, NC = (16, 32, 64), 5


@pytest.fixture(scope="module")
def head_triple():
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
             for (h, w), c in zip(((8, 8), (4, 4), (2, 2)), CH)]
    j = JaxDecoder(nc=NC, hd=32, nq=16, ndl=2, strides=(8, 16, 32))
    v = to_plain(randomize(jax.eval_shape(j.init, jax.random.PRNGKey(0),
                                          [jnp.asarray(f) for f in feats]),
                           np.random.default_rng(1)))
    kind, args = "RTDETRDecoder", (NC, 32, 16, 2)
    shapes = jax.eval_shape(
        lambda p: j.apply({"params": p, "batch_stats": v["batch_stats"]},
                          [jnp.asarray(f) for f in feats], train=True,
                          mutable=["batch_stats"])[0], v["params"])
    cots = {k: np.random.default_rng(11 + i).normal(0, 1, s.shape).astype(
        np.float32) for i, (k, s) in enumerate(sorted(shapes.items()))}

    def jrun(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   v["params"])

        def f(p, xs):
            out, upd = j.apply({"params": p, "batch_stats": v["batch_stats"]},
                               xs, train=True, mutable=["batch_stats"])
            return out, upd
        def full(p, xs):
            out, vjp, upd = jax.vjp(f, p, xs, has_aux=True)
            gp, gx = vjp({k: jnp.asarray(c).astype(out[k].dtype)
                          for k, c in cots.items()})
            return out, upd, gp, gx
        out, upd, gp, gx = _jax_run(full, dtype)(
            p, [jnp.asarray(x).astype(dtype) for x in feats])
        gp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), gp)
        stats = module_state_from_jax(
            {"batch_stats": to_plain(upd["batch_stats"])}, kind, args, CH)
        return ({k: _f32(o) for k, o in out.items()}, [_f32(g) for g in gx],
                module_state_from_jax({"params": to_plain(gp)}, kind, args,
                                      CH), stats)

    t = RTDETRDecoder(NC, CH, (8, 16, 32), hd=32, nq=16, ndl=2)
    start = module_state_from_jax(v, kind, args, CH)
    t.load_state_dict(start, strict=True)
    for prm in t.parameters():
        prm.data = prm.data.to(torch.bfloat16)
    t.train()
    xs = [_port_in(f, True, True) for f in feats]
    out = t(xs)
    torch.autograd.backward([out[k] for k in sorted(cots)],
                            [torch.from_numpy(cots[k]).to(out[k].dtype)
                             for k in sorted(cots)])
    stats = {k: v_.clone() for k, v_ in t.state_dict().items()
             if "running_" in k}
    mine = ({k: o.detach().double().numpy() for k, o in out.items()},
            [_port_grad(x, True) for x in xs],
            {k: p.grad.float() for k, p in t.named_parameters()
             if p.grad is not None}, stats)
    return {"mine": mine, "j16": jrun(BF16), "j32": jrun(jnp.float32),
            "start": start}


@pytest.mark.parametrize("what", ["outputs", "input gradients",
                                  "param gradients", "BN stats moves"])
def test_head_bf16_within_jax_bf16_gap(head_triple, what):
    r = head_triple
    mine, j16, j32, start = r["mine"], r["j16"], r["j32"], r["start"]
    if what == "outputs":
        for k in sorted(j16[0]):
            _gaps(f"head {k}", _rel(mine[0][k], j16[0][k]),
                  _rel(j16[0][k], j32[0][k]))
    elif what == "input gradients":
        _gaps("head input gradients", _rel(_flat(mine[1]), _flat(j16[1])),
              _rel(_flat(j16[1]), _flat(j32[1])))
    elif what == "param gradients":
        keys = _param_keys(mine, j16, j32)
        _gaps("head param gradients", _relnorm(mine[2], j16[2], keys),
              _relnorm(j16[2], j32[2], keys))
    else:
        moved = lambda sd: {k: sd[k] - start[k] for k in sd}
        keys = sorted(j16[3])
        assert keys
        _gaps("head BN stats moves", _relnorm(moved(mine[3]), moved(j16[3]),
                                              keys),
              _relnorm(moved(j16[3]), moved(j32[3]), keys))


# ------------------------------------------------------- the amp step
def _jax_step(graph, v, batch, amp, port):
    """JAX's trainer loss (`make_loss_fn`) of `graph` at `amp`, jitted and
    differentiated, then its `opt_update` at the port trainer's lr and
    momentum. Layer 0 runs as `enhance_impl='pallas'` (interpret mode on
    the CPU), the kernel the port's `fused_enhance` op runs
    (tests/test_torch_amp.py)."""
    jm = JaxModel(copy.deepcopy(graph), enhance_impl="pallas")
    t = JaxTrainer.__new__(JaxTrainer)
    t.args = jax_get_cfg(DEFAULT_CFG_DICT, {**OVERRIDES, "amp": amp})
    t.lowlight_FLAG = bool(t.args.lowlight_FLAG)
    t.dedark_FLAG = bool(t.args.dedark_FLAG)
    t.dark_param = float(t.args.dark_param)
    t.data = {"nc": 3}
    t.build_optimizer(NB)
    fn = jax.jit(jax.value_and_grad(t.make_loss_fn(jm), has_aux=True))
    (_, (items, stats)), grads = fn(
        v["params"], v["batch_stats"],
        {k: jnp.asarray(a) for k, a in batch.items()})
    params, _, applied = jax_opt_update_jit(
        v["params"], grads, jax_init_opt(v["params"]),
        port.lr_at(STEP, "bias"), port.lr_at(STEP), port.momentum_at(STEP),
        kind=t.opt_name, weight_decay=t.weight_decay, accumulate=t.accumulate)
    assert bool(applied)
    tm = port.model
    return {"items": np.asarray(items, np.float64),
            "grads": state_dict_from_jax({"params": grads,
                                          "batch_stats": stats}, tm),
            "state": state_dict_from_jax({"params": params,
                                          "batch_stats": stats}, tm)}


def run_step(name):
    """The port's amp micro-step of `name` and JAX's jitted step at amp and
    f32, from seed 0's weights and batch (nbs = batch: the update
    applies): loss items, gradients, the new state."""
    graph = jax_yaml_load(GRAPHS[name])
    jm = JaxModel(copy.deepcopy(graph))
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    batch = _batch(0)
    tm = DetectionModel(model_yaml_load(GRAPHS[name]), imgsz=64)
    start = state_dict_from_jax(v, tm)
    tm.load_state_dict(start, strict=True)
    tt = DetectionTrainer({**OVERRIDES, "amp": True}, model=tm, nb=NB,
                          device="cpu")
    names = list(tt.params)
    tm.train()
    total, _ = tt.loss(tt.to_device(batch))
    g = torch.autograd.grad(total, [tt.params[n] for n in names],
                            allow_unused=True)
    tm.eval()
    grads = {n: torch.zeros_like(tt.params[n]) if x is None else x
             for n, x in zip(names, g)}
    tm.load_state_dict(start, strict=True)
    _, items = tt.step(batch, STEP)
    port = {"items": items.double().numpy(), "grads": grads,
            "state": tm.state_dict()}
    return {"start": start, "port": port,
            "j16": _jax_step(graph, v, batch, True, tt),
            "j32": _jax_step(graph, v, batch, False, tt)}


@pytest.fixture(scope="module", params=list(GRAPHS))
def amp_step(request):
    return request.param, run_step(request.param)


# Whole-step quantities not held at factor 1.0 (name, quantity), each with
# its ratio in ROADMAP C21.
NOT_HELD = set()


@pytest.mark.parametrize("what", ["loss items", "gradients", "update",
                                  "BN running stats"])
def test_amp_step_within_jax_bf16_gap(amp_step, what):
    name, r = amp_step
    p, j16, j32, start = r["port"], r["j16"], r["j32"], r["start"]
    assert np.isfinite(p["items"]).all()
    moved = lambda sd: {k: sd[k] - start[k] for k in start}
    params = [k for k in start if "running_" not in k]
    stats = [k for k in start if "running_" in k]
    keys = [k for k in p["grads"] if float(j32["grads"][k].abs().max()) > 0]
    assert len(keys) > 0.8 * len(p["grads"])
    mine, ref = {
        "loss items": lambda: (np.abs(p["items"] - j16["items"]).max(),
                               np.abs(j16["items"] - j32["items"]).max()),
        "gradients": lambda: (_relnorm(p["grads"], j16["grads"], keys),
                              _relnorm(j16["grads"], j32["grads"], keys)),
        "update": lambda: (
            _relnorm(moved(p["state"]), moved(j16["state"]), params),
            _relnorm(moved(j16["state"]), moved(j32["state"]), params)),
        "BN running stats": lambda: (
            _relnorm(moved(p["state"]), moved(j16["state"]), stats),
            _relnorm(moved(j16["state"]), moved(j32["state"]), stats)),
    }[what]()
    print(f"{name} {what}: port bf16 vs JAX bf16 {mine:.4g}, JAX bf16 vs "
          f"JAX f32 {ref:.4g}, ratio {mine / ref:.3f}")
    if (name, what) not in NOT_HELD:
        _gaps(f"{name} {what}", mine, ref)
