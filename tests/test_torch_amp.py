"""Torch port vs the JAX package: bf16 training (`amp=True`), on the CPU.

tests/tiny_model.yaml at imgsz 64, batch 2, shared numpy-drawn weights, one
seeded batch, the computed priors, SGD with nbs = batch (so the one step
applies its update and the EMA). The JAX side is the trainer's own loss
function (`make_loss_fn`, trainer.py:976-1030) at amp=True and amp=False,
differentiated with `jax.value_and_grad` and updated with its `opt_update`
and `ema_update`, as its tree-path `train_step` does; the port side is
`DetectionTrainer.loss` and `.step` at amp=True.

The JAX model runs layer 0 as `enhance_impl='pallas'` (interpret mode on
the CPU): the fused kernel forward and its custom VJP, which is what the
port's `fused_enhance` op runs on every device. The port's kernel does the
chain's arithmetic in f32 on the bf16 image (the JAX kernel regresses the
filter parameters and blurs with bf16 operands), so the two bf16 runs are
not bit-equal. The yardstick, for every quantity: the port's bf16 may be no
farther from JAX's bf16 than JAX's bf16 is from JAX's f32 on the same
inputs (factor 1.0, no slack). Each test prints both gaps. Seed 0 (the
seeds of tests/test_torch_train_slice.py) is held on every quantity; four
more seeded weight sets and batches on the loss items and BN stats summed
over the seeds (the gradients' and the update's ratios are printed: see
`test_amp_loss_and_bn_stats_over_seeds_within_jax_bf16_gap`). The bf16
blocks and ASFF levels are held alone too, where the port's bf16 rounds as
JAX's does (`nn/layers.py`).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels,
    opt_update as jax_opt_update)
from dedark_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.ops.dark_channel import dark_channel_priors as jax_priors  # noqa: E402
from dedark_yolo_tpu.ops.degrade import lowlight_degrade as jax_degrade  # noqa: E402
from dedark_yolo_tpu.ops.pallas.enhance_kernel import fused_enhance_diff  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_update as jax_ema_update  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.ops.dark_channel import dark_channel_priors  # noqa: E402
from dedark_yolo_tpu_torch.ops.degrade import lowlight_degrade  # noqa: E402
from dedark_yolo_tpu_torch.ops.enhance_kernel import fused_enhance  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402
from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from test_torch_layers import (  # noqa: E402
    module_state_dict, nchw, nhwc, randomize, to_plain)

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ, BATCH, M = 64, 2, 5
NB, STEP = 20, 37            # inside the warmup: lr and momentum ramp
OVERRIDES = {"batch": BATCH, "nbs": BATCH, "epochs": 10, "imgsz": IMGSZ,
             "optimizer": "SGD", "prior_mode": "computed", "lr0": 0.02}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (BATCH, M, 2))
    wh = rng.uniform(0.15, 0.5, (BATCH, M, 2))
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), np.uint8),
            "cls": rng.integers(0, 3, (BATCH, M)).astype(np.float32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask_gt": (rng.uniform(size=(BATCH, M)) > 0.2).astype(np.float32)}


SEEDS = (0, 1, 2, 3, 4)     # seed 0 is held on every quantity, all on two


@functools.partial(jax.jit,
                   static_argnames=("kind", "weight_decay", "accumulate"))
def jax_opt_update_jit(params, grads, state, lr_bias, lr, momentum, *, kind,
                       weight_decay, accumulate):
    """JAX's `opt_update` with its labels, jitted as the train step runs it
    inside its program (one compile a parameter tree; called eagerly it
    dispatches every op of the tree alone, 14.6 s against 8.4 for a zoo
    model's first call on the CPU)."""
    return jax_opt_update(params, grads, state, jax_labels(params), kind=kind,
                          lr_bias=lr_bias, lr=lr, momentum=momentum,
                          weight_decay=weight_decay, accumulate=accumulate)


class _Jax:
    """The JAX trainer's loss (`make_loss_fn`) at amp=True and amp=False,
    each differentiated and jitted once for every seed's run."""

    def __init__(self):
        self.model = JaxModel(jax_yaml_load(TINY), nc=3, enhance_impl="pallas")
        self.template = jax.eval_shape(
            self.model.module.init, jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
        self.trainers, self.fns = {}, {}
        for amp in (True, False):
            t = JaxTrainer.__new__(JaxTrainer)
            t.args = jax_get_cfg(DEFAULT_CFG_DICT, {**OVERRIDES, "amp": amp})
            t.lowlight_FLAG = bool(t.args.lowlight_FLAG)
            t.dedark_FLAG = bool(t.args.dedark_FLAG)
            t.dark_param = float(t.args.dark_param)
            t.data = {"nc": 3}
            t.build_optimizer(NB)
            self.trainers[amp] = t
            self.fns[amp] = jax.jit(jax.value_and_grad(
                t.make_loss_fn(self.model), has_aux=True))

    def step(self, v, batch, amp, port):
        """Loss items, gradients, new BN stats, updated params and EMA, as
        port state_dicts; lr and momentum from the port's trainer `port`
        (held equal to JAX's by the train-slice test)."""
        t = self.trainers[amp]
        (total, (items, stats)), grads = self.fns[amp](
            v["params"], v["batch_stats"],
            {k: jnp.asarray(a) for k, a in batch.items()})
        params, _, applied = jax_opt_update_jit(
            v["params"], grads, jax_init_opt(v["params"]),
            port.lr_at(STEP, "bias"), port.lr_at(STEP), port.momentum_at(STEP),
            kind=t.opt_name, weight_decay=t.weight_decay,
            accumulate=t.accumulate)
        assert bool(applied)
        ema = {"params": jax_ema_init(v["params"]),
               "batch_stats": jax_ema_init(v["batch_stats"])}
        ema, _ = jax_ema_update(ema, {"params": params, "batch_stats": stats}, 0)
        tm = port.model
        return {"items": np.asarray(items, np.float64), "total": float(total),
                "grads": state_dict_from_jax({"params": grads,
                                              "batch_stats": stats}, tm),
                "state": state_dict_from_jax({"params": params,
                                              "batch_stats": stats}, tm),
                "ema": state_dict_from_jax(ema, tm)}


def _port_step(v, batch):
    """The port's amp loss and gradients, then its step from the same
    state (update, BN stats, EMA)."""
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    start = state_dict_from_jax(v, tm)
    tm.load_state_dict(start, strict=True)
    tt = DetectionTrainer({**OVERRIDES, "amp": True}, model=tm, nb=NB,
                          device="cpu")
    tm.train()
    total, items = tt.loss(tt.to_device(batch))
    names = list(tt.params)
    g = torch.autograd.grad(total, [tt.params[n] for n in names],
                            allow_unused=True)
    tm.eval()
    grads = {n: torch.zeros_like(tt.params[n]) if x is None else x
             for n, x in zip(names, g)}
    tm.load_state_dict(start, strict=True)
    step_total, step_items = tt.step(batch, STEP)
    return start, tt, {
        "items": step_items.double().numpy(), "total": float(step_total),
        "grads": grads, "state": tm.state_dict(), "ema": tt.ema,
        "grad_dtypes": {x.dtype for x in g if x is not None},
        "loss_items": torch.stack(list(items)).detach().double().numpy()}


@pytest.fixture(scope="module")
def seeds():
    """Per seed: the port's amp step and JAX's at amp and f32. Seed 0 is
    the module's seeded weights and batch; seed s > 0 draws both anew."""
    side = _Jax()
    out = []
    for s in SEEDS:
        v = to_plain(randomize(side.template, np.random.default_rng(
            100 + s if s else 0)))
        batch = _batch(10 * s)
        start, tt, port = _port_step(v, batch)
        out.append({"start": start, "port": port, "trainer": tt,
                    "j16": side.step(v, batch, True, tt),
                    "j32": side.step(v, batch, False, tt)})
    return out


@pytest.fixture(scope="module")
def runs(seeds):
    return seeds[0]


def _relnorm(a, b, keys):
    """||a - b|| / ||b|| over the entries `keys` of two state_dicts."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys)
    den = sum(float((b[k].double() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _gaps(name, mine, ref):
    print(f"{name}: port bf16 vs JAX bf16 {mine:.4g}, JAX bf16 vs JAX f32 "
          f"{ref:.4g}")
    assert mine <= ref, name


def _quantities(r):
    """(port-vs-JAX-bf16, JAX-bf16-vs-f32) gaps of one seed's run."""
    p, j16, j32, start = r["port"], r["j16"], r["j32"], r["start"]
    moved = lambda sd: {k: sd[k] - start[k] for k in start}
    params = [k for k in start if "running_" not in k]
    stats = [k for k in start if "running_" in k]
    keys = [k for k in p["grads"] if float(j32["grads"][k].abs().max()) > 0]
    return {
        "loss items (max abs)": (np.abs(p["items"] - j16["items"]).max(),
                                 np.abs(j16["items"] - j32["items"]).max()),
        "gradients (relative norm)": (
            _relnorm(p["grads"], j16["grads"], keys),
            _relnorm(j16["grads"], j32["grads"], keys)),
        "update (relative norm of the move)": (
            _relnorm(moved(p["state"]), moved(j16["state"]), params),
            _relnorm(moved(j16["state"]), moved(j32["state"]), params)),
        "BN running stats (relative norm of the move)": (
            _relnorm(moved(p["state"]), moved(j16["state"]), stats),
            _relnorm(moved(j16["state"]), moved(j32["state"]), stats))}


def test_amp_loss_items_within_jax_bf16_gap(runs):
    p, j16, j32 = runs["port"], runs["j16"], runs["j32"]
    # the step's forward is the loss's forward again, bit for bit
    np.testing.assert_array_equal(p["items"], p["loss_items"])
    assert np.isfinite(p["items"]).all()
    _gaps("loss items (max abs)", np.abs(p["items"] - j16["items"]).max(),
          np.abs(j16["items"] - j32["items"]).max())
    # the total is batch * (box + cls + dfl): its gap is held to what the
    # items' own yardstick allows it (JAX's three item gaps happen to cancel
    # in its total)
    _gaps("total", abs(p["total"] - j16["total"]),
          BATCH * np.abs(j16["items"] - j32["items"]).sum())


def test_amp_gradients_within_jax_bf16_gap(runs):
    p, j16, j32 = runs["port"], runs["j16"], runs["j32"]
    keys = [k for k in p["grads"] if float(j32["grads"][k].abs().max()) > 0]
    assert len(keys) > 0.9 * len(p["grads"])
    _gaps("gradients, global relative norm",
          _relnorm(p["grads"], j16["grads"], keys),
          _relnorm(j16["grads"], j32["grads"], keys))
    mine = [_cos(p["grads"][k], j16["grads"][k]) for k in keys]
    ref = [_cos(j16["grads"][k], j32["grads"][k]) for k in keys]
    _gaps("gradients, 1 - worst per-leaf cosine", 1 - min(mine), 1 - min(ref))
    _gaps("gradients, 1 - median per-leaf cosine", 1 - float(np.median(mine)),
          1 - float(np.median(ref)))


def test_amp_update_ema_and_bn_stats_within_jax_bf16_gap(runs):
    p, j16, j32, start = runs["port"], runs["j16"], runs["j32"], runs["start"]
    moved = lambda sd: {k: sd[k] - start[k] for k in start}
    params = [k for k in start if "running_" not in k]
    stats = [k for k in start if "running_" in k]
    for what, keys in (("update", params), ("BN running stats", stats)):
        for sec in ("state", "ema"):
            _gaps(f"{what} ({sec}), relative norm of the move",
                  _relnorm(moved(p[sec]), moved(j16[sec]), keys),
                  _relnorm(moved(j16[sec]), moved(j32[sec]), keys))


def test_amp_loss_and_bn_stats_over_seeds_within_jax_bf16_gap(seeds):
    """All seeds: each side's gaps summed over the seeds, the loss items
    and the BN stats held, the gradients and the update printed beside
    them with their ratio per seed. Those two are held at seed 0 only (the
    tests above): the two packages' bf16 forwards differ where an f32 sum
    of another order rounds to another bf16 value (fc1's 2048-term dot
    first), train-mode BN spreads that through every layer, and at these
    random weights the task-aligned assigner then picks other positives at
    some seeds, which moves the gradients more than bf16 does."""
    per = [_quantities(r) for r in seeds]
    for name in per[0]:
        mine = sum(q[name][0] for q in per)
        ref = sum(q[name][1] for q in per)
        ratios = ", ".join(f"{q[name][0] / q[name][1]:.2f}" for q in per)
        if name.startswith(("loss", "BN")):
            _gaps(f"{name}, summed over seeds {SEEDS}", mine, ref)
        else:
            print(f"{name}, not held over seeds: port/JAX gap ratio per "
                  f"seed {ratios}")


def test_amp_state_stays_f32(runs):
    tt = runs["trainer"]
    assert runs["port"]["grad_dtypes"] == {torch.float32}
    assert all(v.dtype == torch.float32 for v in tt.model.state_dict().values())
    assert all(v.dtype == torch.float32 for v in tt.ema.values())
    for buf in (tt.opt_state.buf, tt.opt_state.buf2, tt.opt_state.acc):
        assert all(v.dtype == torch.float32 for v in buf.values())
    assert tt.opt_state.step == 1 and tt.ema_updates == 1


def test_amp_degrade_and_priors_bit_equal_jax():
    """u8 / 255 in bf16, the degrade's rounding at every multiply, the
    stable sort of the dark channel among bf16's many ties (ROADMAP C2) and
    the f32-accumulated mean over the top 0.1%: bit-equal to JAX."""
    u8 = _batch(1)["img"]
    jc = jnp.asarray(u8).astype(jnp.bfloat16) / 255.0
    tc = torch.from_numpy(u8).to(torch.bfloat16) / 255.0
    f = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t, np.float32))
    np.testing.assert_array_equal(f(tc), f(jc))
    jd, td = jax_degrade(jc, 5.0), lowlight_degrade(tc, 5.0)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(f(td), f(jd))
    (jA, jI), (tA, tI) = jax_priors(jd), dark_channel_priors(td)
    assert tA.dtype == tI.dtype == torch.bfloat16
    np.testing.assert_array_equal(f(tA), f(jA))
    np.testing.assert_array_equal(f(tI), f(jI))


def test_fused_enhance_bf16_backward_matches_jax_vjp():
    """The fused_enhance op's backward recomputes the plain chain at the inputs'
    dtype, as JAX's `_diff_bwd` does (enhance_kernel.py:342-345): at bf16,
    against `fused_enhance_diff(interpret=True)`'s VJP at bf16; the gap to
    the f32 VJP of the same bf16 values is the yardstick.

    For the full-resolution gradients (img, IcA) the port's bf16 must be no
    farther from JAX's bf16 than JAX's bf16 is from f32: it reproduces JAX's
    bf16 outliers (1.0 and 0.70 of the largest f32 entry) to 0.009. The
    per-image gradients (features, dedark_A) are sums over every pixel;
    the port's sums accumulate in f32 and land closer to the f32 VJP than
    JAX's bf16 ones (0.019 against 0.029 and 0.033 against 0.088 here), so
    those are held to the f32 VJP: no farther from it than JAX's bf16."""
    rng = np.random.default_rng(3)
    b, h, w = 2, 40, 48
    arrs = [(rng.uniform(0, 1, (b, h, w, 3)) ** 3).astype(np.float32),
            rng.normal(0, 0.5, (b, 15)).astype(np.float32),
            rng.uniform(0.6, 0.9, (b, 3)).astype(np.float32),
            rng.uniform(0, 0.6, (b, h, w, 1)).astype(np.float32)]
    cot = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    as16 = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
            for a in arrs + [cot]]

    def jax_vjp(dtype):
        xs = [jnp.asarray(a).astype(dtype) for a in as16]
        _, vjp = jax.vjp(lambda *a: fused_enhance_diff(*a, True), *xs[:4])
        return [np.asarray(g, np.float64) for g in vjp(xs[4])]

    xs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in as16[:4]]
    out = fused_enhance(*xs)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(as16[4]).to(torch.bfloat16))
    mine = [x.grad.double().numpy() for x in xs]
    assert all(x.grad.dtype == torch.bfloat16 for x in xs)
    j16, j32 = jax_vjp(jnp.bfloat16), jax_vjp(jnp.float32)
    for name, m, a, r in zip(("img", "features", "dedark_A", "IcA"),
                             mine, j16, j32):
        gap = lambda x, y: np.abs(x - y).max() / np.abs(r).max()
        print(f"d{name}: port bf16 vs JAX bf16 {gap(m, a):.4g}, port bf16 vs "
              f"f32 {gap(m, r):.4g}, JAX bf16 vs f32 {gap(a, r):.4g}")
        if name in ("img", "IcA"):
            assert gap(m, a) <= gap(a, r), name
        else:
            assert gap(m, r) <= gap(a, r), name


def test_amp_train_loop_resumes_in_amp(tmp_path, monkeypatch):
    """`YOLO(...).train(amp=True)` runs the loop in bf16; its checkpoints
    carry amp in train_args, and `resume=True` continues the run in amp in
    both packages (each takes the resumed run's config from the call)."""
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from synth import make_synth_dataset
    data = str(make_synth_dataset(tmp_path / "ds", n_train=4, n_val=2,
                                  imgsz=IMGSZ))
    args = {"data": data, "imgsz": IMGSZ, "batch": BATCH, "nbs": 4,
            "workers": 0, "mosaic": 0.0, "max_boxes": 8, "max_det": 20,
            "max_nms": 256, "device": "cpu", "project": str(tmp_path / "runs"),
            "name": "amp", "amp": True, "plots": False}
    m = YOLO(TINY, device="cpu")
    seen = []
    m.add_callback("on_train_batch_end", lambda t: seen.append(t.args.amp))
    m.train(epochs=2, **args)
    last = tmp_path / "runs" / "amp" / "weights" / "last.npz"
    meta, _ = load_checkpoint(last)
    assert meta["train_args"]["amp"] is True and meta["epoch"] == 1
    m2 = YOLO(TINY, device="cpu")
    m2.train(epochs=3, resume=True, **args)
    assert m2.trainer.args.amp and seen == [True] * 4
    rows = (tmp_path / "runs" / "amp" / "results.csv").read_text().splitlines()
    assert len(rows) == 4       # the header and epochs 0, 1, 2
    meta, flat = load_checkpoint(last)
    assert meta["epoch"] == 2 and meta["train_args"]["amp"] is True
    assert all(a.dtype == np.float32 for k, a in flat.items()
               if not k.startswith("opt/."))
    assert all(np.isfinite(float(x)) for x in rows[-1].split(",")[1:4])

    # the JAX trainer resumes the port's amp run for the same third epoch
    from dedark_yolo_tpu import YOLO as JaxYOLO
    monkeypatch.setenv("DEDARK_FUSED_OPT", "0")
    jdir = tmp_path / "runs" / "jax_amp"
    (jdir / "weights").mkdir(parents=True)
    before, _ = load_checkpoint(last)
    (jdir / "weights" / "last.npz").write_bytes(
        (tmp_path / "runs" / "amp" / "weights" / "last.npz").read_bytes())
    seen.clear()
    m3 = JaxYOLO(TINY)
    m3.add_callback("on_train_batch_end", lambda t: seen.append(t.args.amp))
    m3.train(epochs=4, resume=True, mesh_shape=[1],
             **{**args, "name": "jax_amp", "device": None})
    jmeta, jflat = load_checkpoint(jdir / "weights" / "last.npz")
    assert jmeta["epoch"] == 3 and jmeta["train_args"]["amp"] is True
    assert seen == [True] * 2
    assert all(np.isfinite(a).all() for a in jflat.values()
               if a.dtype.kind == "f")



def _bf16_train_pair(jmod, tmod, name, xs, args=()):
    """One train-mode call of `jmod` (flax) and `tmod` (the port) on the
    same weights and inputs (an NHWC array or a list of them): JAX with
    bf16 params at bf16 inputs, JAX in f32, and the port with bf16 params
    and f32 BN buffers (as the amp step runs it). Returns (output, BN
    running-stat moves) of each, float64 NHWC numpy and dicts."""
    many = isinstance(xs, list)
    jx = [jnp.asarray(x) for x in (xs if many else [xs])]
    pick = (lambda a: a) if many else (lambda a: a[0])
    v = randomize(jmod.init(jax.random.PRNGKey(0), pick(jx)),
                  np.random.default_rng(0))
    start = module_state_dict(v, name, args)

    def jrun(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v["params"])
        out, upd = jmod.apply({"params": p, "batch_stats": v["batch_stats"]},
                              pick([x.astype(dtype) for x in jx]), train=True,
                              mutable=["batch_stats"])
        sd = module_state_dict({"batch_stats": upd["batch_stats"]}, name, args)
        return (np.asarray(out, np.float64),
                {k: sd[k] - start[k] for k in sd})

    tmod.load_state_dict(start, strict=True)
    for prm in tmod.parameters():
        prm.data = prm.data.to(torch.bfloat16)
    tmod.train()
    with torch.no_grad():
        out = tmod(pick([nchw(np.asarray(x.astype(jnp.bfloat16), np.float32))
                         .to(torch.bfloat16) for x in jx]))
    assert out.dtype == torch.bfloat16
    sd = tmod.state_dict()
    assert all(sd[k].dtype == torch.float32 for k in sd if "running_" in k)
    mine = (nhwc(out.double()), {k: sd[k] - start[k] for k in sd
                                  if "running_" in k})
    return mine, jrun(jnp.bfloat16), jrun(jnp.float32)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_amp_asff_level_within_jax_bf16_gap(level):
    """AsffTribeLevel in bf16 training, its weight branches commuted past
    the upsample in both packages (JAX layers.py:1162; ROADMAP C1): the
    output and every BN's running-stat move, by the module's yardstick (the
    flagship's whole train forward on random weights amplifies any rounding
    difference, tests/test_torch_train_flagship.py, so its bf16 is held
    module by module here and end to end on the card against f32)."""
    rng = np.random.default_rng(level)
    xs = [rng.normal(0.3, 1.0, s).astype(np.float32)
          for s in ((2, 2, 2, 16), (2, 4, 4, 16), (2, 8, 8, 8))]
    mine, j16, j32 = _bf16_train_pair(
        JL.AsffTribeLevel(level=level), TL.AsffTribeLevel(level, (16, 16, 8)),
        "AsffTribeLevel", xs, (level,))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    _gaps(f"ASFF level {level} output", rel(mine[0], j16[0]),
          rel(j16[0], j32[0]))
    keys = list(j16[1])
    _gaps(f"ASFF level {level} BN stats moves",
          _relnorm(mine[1], j16[1], keys), _relnorm(j16[1], j32[1], keys))


@pytest.mark.parametrize("name", ["Conv", "C2f", "SPPF"])
def test_amp_blocks_within_jax_bf16_gap(name):
    """Conv + BN + SiLU, C2f (its concat-conv) and SPPF in bf16 training:
    BN reduces in f32, moves the f32 running stats and returns bf16, as
    flax 0.12 does."""
    jmod, tmod, c = {
        "Conv": (JL.Conv(c2=16, k=3, s=1), TL.Conv(8, 16, 3, 1), 8),
        "C2f": (JL.C2f(c2=16, n=2, shortcut=True), TL.C2f(8, 16, 2, True), 8),
        "SPPF": (JL.SPPF(c2=16), TL.SPPF(8, 16), 8)}[name]
    x = np.random.default_rng(4).normal(0.3, 1.0, (2, 9, 11, c)).astype(np.float32)
    mine, j16, j32 = _bf16_train_pair(jmod, tmod, name, x)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    _gaps(f"{name} output", rel(mine[0], j16[0]), rel(j16[0], j32[0]))
    keys = list(j16[1])
    _gaps(f"{name} BN stats moves", _relnorm(mine[1], j16[1], keys),
          _relnorm(j16[1], j32[1], keys))
