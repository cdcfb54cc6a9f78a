"""Torch port vs the JAX package: `remat` (A12j), the backward's recompute
of the early layers (CPU).

The counterparts of JAX tests/test_remat_autoboxes.py's
`test_remat_matches_plain` and `test_remat_eval_unaffected` on
tests/tiny_model.yaml at imgsz 64, b2, the loss the sum of the squared raw
maps, from the weights of JAX's init:
  - the port at remat_upto=4 (layer 0, the three stride-2 Convs and the
    C2f) against the port at -1 within JAX's own test's bars (loss 1e-6
    relative, gradients 1e-5 relative plus 1e-6, BN stats 1e-6 relative),
    the BN running stats moved once (equal to the plain run's, which moved
    once, and away from the start);
  - the port at 4 against JAX at remat_upto=4: loss 3e-5 relative,
    gradients 2e-3 of each tensor's largest entry (2e-2 for layer 0's
    parameter CNN) and BN stats 2e-6 absolute, tests/test_torch_train_slice.py's
    bars for a train-mode forward and backward through the whole graph;
  - amp: `DetectionTrainer.loss` with amp=True (bf16 casts through
    `functional_call`) at remat=4 against remat=-1, the same bars as f32's
    remat-against-plain, and the stats moved once;
  - eval at remat_upto=99 equals eval at -1 bit for bit;
  - the `remat` key: accepted by `check_cfg_alignment`, typed by get_cfg,
    set on the trainer's model.
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch.cfg import (DEFAULT_CFG, check_cfg_alignment,  # noqa: E402
                                       get_cfg, model_yaml_load)
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ, UPTO = 64, 4


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)
                                         ).astype(np.float32)
    plain = JaxModel(jax_yaml_load(TINY), nc=3)
    v = jax.device_get(plain.init(jax.random.PRNGKey(0), imgsz=IMGSZ))
    return x, v


def jax_loss(v, x, upto):
    m = JaxModel(jax_yaml_load(TINY), nc=3, remat_upto=upto)

    def f(p):
        raw, ns = m.apply_train({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x))
        return sum(jnp.sum(r.astype(jnp.float32) ** 2) for r in raw), ns
    (loss, ns), g = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    return loss, g, ns


def port_model(v, upto):
    tm = DetectionModel(model_yaml_load(TINY), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    tm.remat_upto = upto
    return tm


def port_loss(v, x, upto):
    tm = port_model(v, upto)
    tm.train()
    raw = tm(torch.from_numpy(x))
    loss = sum((r.float() ** 2).sum() for r in raw)
    names = [n for n, _ in tm.named_parameters()]
    g = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return (loss.detach(), dict(zip(names, g)),
            {k: b.clone() for k, b in tm.named_buffers()})


def assert_remat_equals_plain(a, b):
    (l1, g1, s1), (l2, g2, s2) = a, b
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in s1:
        np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(), rtol=1e-6,
                                   err_msg=k)


def test_remat_matches_plain_and_jax(setup):
    x, v = setup
    plain, remat = port_loss(v, x, -1), port_loss(v, x, UPTO)
    assert_remat_equals_plain(plain, remat)
    start = port_model(v, -1).state_dict()
    moved = [k for k in remat[2] if "running_" in k
             and not torch.equal(remat[2][k], start[k])]
    assert len(moved) == sum("running_" in k for k in start)

    jl, jg, jns = jax_loss(v, x, UPTO)
    tm = port_model(v, UPTO)
    want_g = state_dict_from_jax({"params": jax.device_get(jg),
                                  "batch_stats": jax.device_get(jns)}, tm)
    loss, grads, stats = remat
    np.testing.assert_allclose(float(loss), float(jl), rtol=3e-5)
    for k, g in grads.items():
        w = want_g[k]
        rel = 2e-2 if k.startswith("model.0.") else 2e-3
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=rel * float(w.abs().max()) + 1e-12,
                                   err_msg=k)
    for k, s in stats.items():
        np.testing.assert_allclose(s.numpy(), want_g[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)


def test_remat_amp_step_matches_plain(setup):
    x, v = setup
    rng = np.random.default_rng(1)
    batch = {"img": (x * 255).astype(np.uint8),
             "cls": rng.integers(0, 3, (2, 4)).astype(np.float32),
             "bboxes": rng.uniform(0.2, 0.6, (2, 4, 4)).astype(np.float32),
             "mask_gt": np.ones((2, 4), np.float32)}
    out = []
    for upto in (-1, UPTO):
        tm = port_model(v, -1)
        tr = DetectionTrainer({"amp": True, "remat": upto, "batch": 2},
                              model=tm, device="cpu")
        assert tm.remat_upto == upto
        tm.train()
        total, items = tr.loss(tr.to_device(batch))
        names = list(tr.params)
        g = torch.autograd.grad(total, [tr.params[n] for n in names],
                                allow_unused=True)
        tm.eval()
        assert torch.isfinite(total)
        out.append((total.detach(), {n: gi for n, gi in zip(names, g)
                                     if gi is not None},
                    {k: b.clone() for k, b in tm.named_buffers()}))
    assert_remat_equals_plain(*out)


def test_remat_eval_unaffected(setup):
    _, v = setup
    x = torch.full((1, IMGSZ, IMGSZ, 3), 0.4)
    plain, remat = port_model(v, -1).eval(), port_model(v, 99).eval()
    with torch.no_grad():
        for a, b in zip(plain(x), remat(x)):
            assert torch.equal(a, b)
        for a, b in zip(plain.decode(plain(x)), remat.decode(remat(x))):
            assert torch.equal(a, b)


def test_remat_key_is_ported():
    check_cfg_alignment(DEFAULT_CFG.keys(), {"remat": 5})
    assert get_cfg(overrides={"remat": 5}).remat == 5 and get_cfg().remat == -1
    with pytest.raises(TypeError, match="remat"):
        get_cfg(overrides={"remat": "5"})
