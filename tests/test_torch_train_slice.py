"""Torch port vs the JAX package: train-mode BN, the optimizer, the EMA, and
one accumulation window of the whole train step (CPU, f32).

The slice gate: tests/tiny_model.yaml at imgsz 64, batch 2, nbs 4 (so two
micro-steps make one window), shared weights drawn into the flax trees and
loaded through `state_dict_from_jax`; the port's DetectionTrainer.step
against the JAX tree-path train_step (trainer.py:356-372) on the same
batches, lr and momentum inside the warmup ramp. Tolerances, each with its
reason (the measured worst case in brackets):
  - loss items and total 3e-5 relative (5e-6): the loss sums in another
    order, after a forward through train-mode BN everywhere;
  - BN running stats and their EMA 2e-6 absolute (4e-7): flax takes
    E[x^2] - E[x]^2, torch the two-pass variance;
  - momentum buffers, Adam's second moments: 2e-3 of each tensor's largest
    entry (2.2e-4), 2e-2 for layer 0's parameter CNN (5e-3): the gradients
    sum in another order through the whole graph, and those of the CNN pass
    on through the enhance chain and the 256x256 resize;
  - SGD's updated parameters and EMA: 1e-6 plus half of that share of the
    tensor's largest move;
  - AdamW's first update is lr * sign(g) wherever |g| >> eps, so an element
    whose gradient lies within that sum-order error of 0 may flip: the
    updated parameters and EMA are held to 2e-6 (7e-7) where |m| exceeds 2%
    of the tensor's largest.
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    opt_state_from_jax, state_dict_from_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")

IMGSZ, BATCH, M = 64, 2, 5
NB, STEPS = 20, (37, 38)     # inside the 100-step warmup: lr, bias lr and
                             # momentum all ramp


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in STEPS:
        xy = rng.uniform(0.25, 0.75, (BATCH, M, 2))
        wh = rng.uniform(0.15, 0.5, (BATCH, M, 2))
        out.append({
            "img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), np.uint8),
            "cls": rng.integers(0, 3, (BATCH, M)).astype(np.float32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask_gt": (rng.uniform(size=(BATCH, M)) > 0.2).astype(np.float32)})
    return out


def _jax_trainer(overrides):
    t = JaxTrainer.__new__(JaxTrainer)          # no dataset, no run dir
    t.args = jax_get_cfg(DEFAULT_CFG_DICT, overrides)
    t.lowlight_FLAG = bool(t.args.lowlight_FLAG)
    t.dedark_FLAG = bool(t.args.dedark_FLAG)
    t.dark_param = float(t.args.dark_param)
    t.data = {"nc": 3}
    t.build_optimizer(NB)
    t._opt_spec = None                          # the tree path
    return t


@pytest.mark.parametrize("optimizer,prior_mode", [("SGD", "computed"),
                                                  ("auto", "default")])
def test_train_step_window_matches_jax(optimizer, prior_mode):
    """One accumulation window (two micro-steps, the second applies the
    update and the EMA) of the tiny model: SGD with the computed priors, and
    'auto' (AdamW here) with the default ones."""
    overrides = {"batch": BATCH, "nbs": 4, "epochs": 10, "imgsz": IMGSZ,
                 "optimizer": optimizer, "prior_mode": prior_mode,
                 "lr0": 0.02}
    jm = JaxModel(jax_yaml_load(TINY), nc=3)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    jt = _jax_trainer(overrides)
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = v["params"], v["batch_stats"]
    jopt = jax_init_opt(jp)
    jema = {"params": jax_ema_init(jp), "batch_stats": jax_ema_init(jbs)}
    jeu = jnp.int32(0)

    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    tt = DetectionTrainer(overrides, model=tm, nb=NB, device="cpu")
    assert (tt.opt_name, tt.accumulate, tt.lr0) == (jt.opt_name, jt.accumulate,
                                                    jt.lr0)
    assert tt.weight_decay == jt.weight_decay

    for i, batch in zip(STEPS, _batches()):
        assert (tt.lr_at(i, "bias"), tt.lr_at(i), tt.momentum_at(i)) == (
            jt._lr_at(i, "bias"), jt._lr_at(i, "weight"), jt._momentum_at(i))
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu, {k: jnp.asarray(a) for k, a in batch.items()},
            jnp.float32(jt._lr_at(i, "bias")), jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        total, items = tt.step(batch, i)
        np.testing.assert_allclose(items.numpy(), np.stack(jitems), rtol=3e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=3e-5)
        assert not tm.training
    assert tt.opt_state.step == int(jopt.step) == 1 and tt.ema_updates == 1

    want = state_dict_from_jax({"params": jp, "batch_stats": jbs}, tm)
    want_ema = state_dict_from_jax(jema, tm)
    start = state_dict_from_jax(v, tm)
    jbuf = opt_state_from_jax(jopt, tm)
    assert (jbuf.step, jbuf.micro) == (tt.opt_state.step, tt.opt_state.micro)
    got = tm.state_dict()
    # tensors the window moved (a box branch whose level has no positive
    # anchor gets no gradient)
    assert sum(not torch.equal(w, start[k]) for k, w in want.items()) \
        > 0.9 * len(want)
    for k, w in want.items():
        if "running_" in k:
            close(got[k], w, 2e-6, k)
            close(tt.ema[k], want_ema[k], 2e-6, k)
            continue
        rel = 2e-2 if k.startswith("model.0.") else 2e-3
        for mine, theirs in ((tt.opt_state.buf, jbuf.buf),
                             (tt.opt_state.buf2, jbuf.buf2)):
            if theirs[k].abs().max() > 0:
                close(mine[k], theirs[k], rel * float(theirs[k].abs().max()), k)
        if tt.opt_name == "sgd":
            tol = 1e-6 + rel / 2 * float((w - start[k]).abs().max())
            close(got[k], w, tol, k)
            close(tt.ema[k], want_ema[k], tol, k)
        else:   # lr * sign(g) wherever |g| >> eps: hold where g is clear of 0
            m = jbuf.buf[k].abs()
            sure = m > 2e-2 * m.max()
            close(got[k][sure], w[sure], 2e-6, k)
            close(tt.ema[k][sure], want_ema[k][sure], 2e-6, k)


def close(got, want, atol, name):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol,
                               err_msg=name)
