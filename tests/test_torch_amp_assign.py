"""Torch port vs the JAX package: bf16 training over seeds 0-4 with the
port's assignment fixed to JAX's (ROADMAP C11).

tests/test_torch_amp.py holds the port's bf16 loss items and BN stats to
its yardstick over seeds 0-4 (the port's bf16 no farther from JAX's bf16
than JAX's bf16 from its f32) but the gradients and the update at seed 0
only. Here the same runs (its `_Jax`, `_batch`, `_port_step`,
`_quantities`) repeat with the task-aligned assigner's positives fixed: a
test-side wrapper of JAX's assigner records, under jit, which anchors
JAX's bf16 run gave to which GT, and a test-side patch of the port's
`losses/tal.py` (`_select_topk` returns that mask) makes the port take
exactly those positives, all else computed from its own bf16 forward.
One more test-side wrapper records JAX's bf16 raw head maps (the loss's
input).

What this holds, at every seed: the port took JAX's positives; the port's
loss backward at JAX's raw maps is JAX's (1e-6 relative; it was not where
a bf16 logit is exactly 0, the op `losses/detection.py::_bce_logits`
repaired); the BN stats' moves meet the yardstick. The gradients' and the
update's ratios are printed, not held: with JAX's positives the port's
assigner made the same choices as its own, the ratios are those of
tests/test_torch_amp.py's seeds, and some stay above 1. The assigner is
not the cause of C11, which stays open in ROADMAP: the forward gap starts
in layer 0 (the parameter CNN's sum order, and the enhance chain's bf16
rounding points where JAX's kernel stages in bf16) and grows in the
C2f/SPPF blocks under train-mode BN.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.engine import trainer as jax_trainer  # noqa: E402
from dedark_yolo_tpu.losses import detection as jax_detection  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.losses import detection as port_detection  # noqa: E402
from dedark_yolo_tpu_torch.losses import tal  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.tools import assign_probe  # noqa: E402

from test_torch_amp import (NB, OVERRIDES, SEEDS, TINY, _batch,  # noqa: E402
                            _Jax, _port_step, _quantities)
from test_torch_layers import randomize, to_plain  # noqa: E402

HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "lrl": 2.0}   # the defaults


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs: the
    suite runs six workers on a few cores, and torch's default (one thread
    a core) spins them against each other. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recording(fn, store, pick):
    """`fn`, with pick(args, result) handed to `store` on the host at run
    time (a jax.debug.callback, so it records inside jit and grad)."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda *xs: store.append([np.asarray(x) for x in xs]),
                           *pick(args, out))
        return out
    return wrapped


def _positives(fg, gt, m):
    """(B, N) fg mask and GT index -> the (B, M, N) 0/1 mask of positives."""
    fg, gt = torch.tensor(fg), torch.tensor(gt).long()
    return (torch.nn.functional.one_hot(gt, m).transpose(1, 2).float()
            * fg[:, None, :].float())


@pytest.fixture(scope="module")
def seeds():
    """Per seed: JAX's bf16 step (its positives and raw maps recorded) and
    f32 step, then the port's amp step on JAX's bf16 positives."""
    jax_mp, port_mp = pytest.MonkeyPatch(), pytest.MonkeyPatch()
    rec = {"assign": [], "raw": []}
    jax_mp.setattr(jax_detection, "task_aligned_assign", _recording(
        jax_detection.task_aligned_assign, rec["assign"],
        lambda a, r: (r.fg_mask, r.target_gt_idx)))
    jax_mp.setattr(jax_trainer, "detection_loss", _recording(
        jax_trainer.detection_loss, rec["raw"], lambda a, r: a[0]))
    side = _Jax()
    # lr, momentum and the state_dict names for `_Jax.step`: the port
    # trainer's, the same at every seed
    sched = DetectionTrainer({**OVERRIDES, "amp": True},
                             model=DetectionModel(model_yaml_load(TINY), nc=3),
                             nb=NB, device="cpu")
    out = []
    try:
        for s in SEEDS:
            v = to_plain(randomize(side.template, np.random.default_rng(
                100 + s if s else 0)))
            batch = _batch(10 * s)
            for r in rec.values():
                r.clear()
            j16 = side.step(v, batch, True, sched)
            (fg, gt), raw16 = rec["assign"][-1], rec["raw"][-1]
            j32 = side.step(v, batch, False, sched)
            pos = _positives(fg, gt, batch["cls"].shape[1])
            port_mp.setattr(tal, "_select_topk", lambda metrics, k, valid: pos)
            with assign_probe.record() as calls:
                start, tt, port = _port_step(v, batch)
            port_mp.undo()
            out.append({"batch": batch, "start": start, "port": port,
                        "j16": j16, "j32": j32, "jax_fg": fg, "jax_gt": gt,
                        "port_calls": calls, "raw16": raw16, "trainer": tt})
    finally:
        port_mp.undo()
        jax_mp.undo()
    return out


def _rel(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_port_took_jaxs_positives(seeds):
    """Every assigner call of the port's loss and step chose JAX's bf16
    positives, anchor for anchor."""
    for r in seeds:
        fg = r["jax_fg"]
        assert fg.sum() > 0 and len(r["port_calls"]) == 2
        for c in r["port_calls"]:
            np.testing.assert_array_equal(c["fg"].numpy(), fg)
            np.testing.assert_array_equal(c["gt"].numpy()[fg], r["jax_gt"][fg])


def test_loss_backward_at_jax_raw_maps_is_jaxs(seeds):
    """The port's v8 loss and its gradient in the raw maps, at JAX's bf16
    raw maps, against JAX's (f32 loss math in both)."""
    for r in seeds:
        batch = r["batch"]
        raw = [torch.tensor(x, requires_grad=True) for x in r["raw16"]]
        lb = {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask_gt")}
        total, _ = port_detection.detection_loss(raw, {**lb, "recovery_loss": torch.tensor(0.0)},
                                  nc=3, strides=r["trainer"].model.strides,
                                  hyp=HYP)
        got = torch.autograd.grad(total, raw)
        jlb = {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask_gt")}
        want = jax.grad(lambda m: jax_detection.detection_loss(
            m, {**jlb, "recovery_loss": jnp.float32(0)}, nc=3,
            strides=r["trainer"].model.strides, hyp=HYP)[0])(
                [jnp.asarray(x) for x in r["raw16"]])
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-6


def test_bce_derivatives_at_zero_logits_match_jax():
    """The repaired op: at logits of exactly 0 the port's BCE gradient is
    jnp's (maximum's tie split, abs's positive side), at any target."""
    x = np.array([0.0, 1.5, -1.5, 0.0, 0.0, 3e-8], np.float32)
    t = np.array([0.0, 0.3, 1.0, 0.5, 1.0, 0.0], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    port_detection._bce_logits(xt, torch.from_numpy(t)).sum().backward()
    want = jax.grad(lambda v: jax_detection._bce_logits(v, jnp.asarray(t)).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_bn_stats_every_seed_within_jax_bf16_gap(seeds):
    """The BN running stats' moves by the yardstick at each seed (factor
    1.0); the other quantities' ratios printed beside them."""
    per = [_quantities(r) for r in seeds]
    for name in per[0]:
        ratios = ", ".join(f"{q[name][0] / q[name][1]:.2f}" for q in per)
        print(f"{name}, JAX's positives: port/JAX gap ratio per seed "
              f"{SEEDS}: {ratios}")
    for s, q in zip(SEEDS, per):
        mine, ref = q["BN running stats (relative norm of the move)"]
        assert mine <= ref, (s, mine, ref)
