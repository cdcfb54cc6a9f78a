"""Torch port vs the JAX package: RT-DETR's task end to end (CPU, f32).

tests/tiny_rtdetr.yaml (hd 32, nq 16, ndl 2) at imgsz 64, numpy-seeded flax
weights carried by `state_dict_from_jax`. The set-matching loss:
`greedy_assign` on shared cost matrices (equal assignments and `matched`,
with more ground truths than queries too) and `rtdetr_loss`'s total and
items within 2e-5. One f32 train step against JAX's `make_loss_fn` and
`opt_update` at tests/test_torch_zoo_train.py's bars (loss items 3e-5
relative; gradients 2e-3 of each tensor's largest entry; BN stats 2e-6;
parameters 1e-6 plus 1e-3 of the tensor's largest move), no gradient NaN.
Val, NMS-free, against JAX's validator: per image the detections paired
(tests/pairing.py) with their TP rows, the metrics within 1e-6 and the val
loss items within 2e-5. Predict through NMS against JAX's predictor,
paired; augment=True warns and predicts at one scale, as JAX does. The
benchmark's rows, a CPU `pt2` equal to the live model, one served request
equal to predict, and the CLI's predict and val.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine import validator as jax_validator  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels,
    opt_update as jax_opt_update)
from dedark_yolo_tpu.engine.predictor import (  # noqa: E402
    DetectionPredictor as JaxPredictor)
from dedark_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer  # noqa: E402
from dedark_yolo_tpu.losses import rtdetr as JR  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: E402
from dedark_yolo_tpu_torch.engine.server import InferenceServer  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.losses import rtdetr as TR  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_results_paired  # noqa: E402
from synth import make_synth_dataset  # noqa: E402
from test_torch_amp import NB, STEP, _batch  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_val import (RESULT_KEYS, METRIC_TOL, assert_same_images,  # noqa: E402
                            record_matches)
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

TINY = str(Path(__file__).resolve().parent / "tiny_rtdetr.yaml")
IMGSZ, NC = 64, 3
LOSS_RTOL = 2e-5
BOX_TOL, SCORE_TOL = 4e-4, 1e-6
OVERRIDES = {"batch": 2, "nbs": 2, "epochs": 10, "imgsz": IMGSZ,
             "optimizer": "SGD", "lr0": 0.02}


@pytest.fixture(scope="module")
def weights():
    """(JAX model, numpy flax trees) of tests/tiny_rtdetr.yaml, seed 0."""
    jm = JaxModel(jax_yaml_load(TINY), nc=NC)
    tmpl = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                               jnp.float32))
    return jm, to_plain(randomize(tmpl, np.random.default_rng(0)))


def port_model(v):
    tm = DetectionModel(model_yaml_load(TINY), nc=NC)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return tm.eval()


@pytest.fixture(scope="module")
def npz(weights, tmp_path_factory):
    jm, v = weights
    return str(save_checkpoint(
        tmp_path_factory.mktemp("rtdetr") / "tiny_rtdetr.npz",
        params=v["params"], batch_stats=v["batch_stats"],
        train_args={"imgsz": IMGSZ}, model_yaml=jm.yaml))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((48, 64), (64, 64), (70, 50))]


# ---------------------------------------------------------------- loss
@pytest.mark.parametrize("b,nq,m,pad", [(3, 24, 6, True), (1, 3, 6, False),
                                        (2, 16, 16, True)])
def test_greedy_assign_equals_jax(b, nq, m, pad):
    rng = np.random.default_rng(nq + m)
    cost = rng.uniform(0, 1, (b, nq, m)).astype(np.float32)
    mask = np.ones((b, m), np.float32)
    if pad:
        mask[b - 1, m // 2:] = 0.0
    jq, jm_ = JR.greedy_assign(jnp.asarray(cost), jnp.asarray(mask))
    tq, tm_ = TR.greedy_assign(torch.from_numpy(cost), torch.from_numpy(mask))
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if nq < m:
        assert tm_.sum() == nq and len(set(tq[0][tm_[0] > 0].tolist())) == nq


def _outputs(rng, ndl=2, b=2, nq=16, nc=NC):
    box = lambda *s: rng.uniform(0.1, 0.6, (*s, 4)).astype(np.float32)
    logit = lambda *s: rng.normal(0, 2, (*s, nc)).astype(np.float32)
    return {"dec_bboxes": box(ndl, b, nq), "dec_logits": logit(ndl, b, nq),
            "enc_bboxes": box(b, nq), "enc_logits": logit(b, nq)}


@pytest.mark.parametrize("seed", [0, 1])
def test_rtdetr_loss_equals_jax(seed):
    rng = np.random.default_rng(seed)
    out = _outputs(rng)
    batch = _batch(seed)
    batch = {"cls": batch["cls"], "bboxes": batch["bboxes"],
             "mask_gt": batch["mask_gt"], "recovery_loss": np.float32(0.25)}
    hyp = {"lrl": 0.5}
    jt, ji = JR.rtdetr_loss({k: jnp.asarray(a) for k, a in out.items()},
                            {k: jnp.asarray(a) for k, a in batch.items()},
                            nc=NC, hyp=hyp)
    tt, ti = TR.rtdetr_loss({k: torch.from_numpy(a) for k, a in out.items()},
                            {k: torch.as_tensor(a) for k, a in batch.items()},
                            nc=NC, hyp=hyp)
    np.testing.assert_allclose(float(tt), float(jt), rtol=LOSS_RTOL)
    np.testing.assert_allclose(torch.stack(list(ti)).numpy(),
                               np.stack([np.asarray(x) for x in ji]),
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------- train step
def test_train_step_matches_jax(weights):
    """One f32 step of the tiny RT-DETR: JAX's `make_loss_fn`,
    differentiated, and its `opt_update` at the port's lr and momentum,
    against `DetectionTrainer`'s loss, gradients and `step`."""
    jm, v = weights
    batch = _batch(0)
    tm = port_model(v)
    start = {k: t.clone() for k, t in tm.state_dict().items()}
    tt = DetectionTrainer(OVERRIDES, model=tm, nb=NB, device="cpu")
    names = list(tt.params)
    tm.train()
    total, _ = tt.loss(tt.to_device(batch))
    g = torch.autograd.grad(total, [tt.params[n] for n in names],
                            allow_unused=True)
    grads = {n: torch.zeros_like(tt.params[n]) if x is None else x
             for n, x in zip(names, g)}
    assert all(torch.isfinite(x).all() for x in grads.values())
    tm.load_state_dict(start, strict=True)
    _, items = tt.step(batch, STEP)

    t = JaxTrainer.__new__(JaxTrainer)
    t.args = jax_get_cfg(DEFAULT_CFG_DICT, OVERRIDES)
    t.lowlight_FLAG = bool(t.args.lowlight_FLAG)
    t.dedark_FLAG = bool(t.args.dedark_FLAG)
    t.dark_param = float(t.args.dark_param)
    t.data = {"nc": NC}
    t.build_optimizer(NB)
    fn = jax.jit(jax.value_and_grad(t.make_loss_fn(jm), has_aux=True))
    (_, (jitems, stats)), jgrads = fn(
        v["params"], v["batch_stats"],
        {k: jnp.asarray(a) for k, a in batch.items()})
    params, _, applied = jax_opt_update(
        v["params"], jgrads, jax_init_opt(v["params"]),
        jax_labels(v["params"]), kind=t.opt_name,
        lr_bias=tt.lr_at(STEP, "bias"), lr=tt.lr_at(STEP),
        momentum=tt.momentum_at(STEP), weight_decay=t.weight_decay,
        accumulate=t.accumulate)
    assert bool(applied)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems),
                               rtol=3e-5)
    want_g = state_dict_from_jax({"params": jgrads, "batch_stats": {}}, tm)
    assert sum(float(w.abs().max()) > 0 for w in want_g.values()) \
        > 0.9 * len(want_g)
    for k, w in want_g.items():
        if k.endswith("key.bias"):
            # zero: the softmax over the keys is blind to a shift common to
            # every key; JAX's holds only the sums' rounding, the port's is
            # exactly 0 (MultiHeadAttention._key)
            assert float(w.abs().max()) < 1e-7 and not grads[k].any(), k
            continue
        np.testing.assert_allclose(
            grads[k].numpy(), w.numpy(), rtol=0,
            atol=2e-3 * float(w.abs().max()) + 1e-12, err_msg=k)
    want = state_dict_from_jax({"params": params, "batch_stats": stats}, tm)
    got = tm.state_dict()
    for k, w in want.items():
        tol = (2e-6 if "running_" in k
               else 1e-6 + 1e-3 * float((w - start[k]).abs().max()))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=k)


# ----------------------------------------------------------------- val
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("rtdetr_val")
    path = make_synth_dataset(root / "ds", n_train=4, n_val=6, imgsz=IMGSZ)
    import yaml
    data = yaml.safe_load(Path(path).read_text())
    (root / "ds" / "data.json").write_text(json.dumps(data))
    return str(root / "ds" / "data.json")


@pytest.mark.parametrize("with_loss", [False, True])
def test_val_matches_jax(tmp_path, monkeypatch, dataset, weights, with_loss):
    """NMS-free val: per image the same count, each detection paired with
    JAX's (box, score, class, TP row), metrics within 1e-6; with_loss the
    last layer's matching loss of the eval queries within 2e-5."""
    jm, v = weights
    kw = {"data": dataset, "imgsz": IMGSZ, "batch": 4, "workers": 2,
          "plots": False, "verbose": False}
    jrec = record_matches(monkeypatch, jax_validator)
    trec = record_matches(monkeypatch, validator)
    want = jax_validator.DetectionValidator(
        args=jax_get_cfg(DEFAULT_CFG_DICT, kw), save_dir=tmp_path / "j")(
        model=jm, params=v["params"], batch_stats=v["batch_stats"],
        with_loss=with_loss)
    got = validator.DetectionValidator(
        args=get_cfg(overrides={**kw, "device": "cpu"}), save_dir=tmp_path / "t")(
        model=port_model(v), with_loss=with_loss)
    assert_same_images(jrec, trec)
    assert sum(len(c) for _, c, _ in trec) == 6 * 16   # every query kept
    for k in RESULT_KEYS:
        assert abs(float(got[k]) - float(want[k])) <= METRIC_TOL, k
    if with_loss:
        for k in ("val/box_loss", "val/cls_loss", "val/dfl_loss"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=k)


# ------------------------------------------------------------- predict
def test_predict_matches_jax_and_tta_falls_back(weights, frames, tmp_path,
                                                caplog):
    jm, v = weights
    over = dict(imgsz=IMGSZ, batch=2, conf=0.25, iou=0.7, max_det=300)
    jp = JaxPredictor(args=jax_get_cfg(DEFAULT_CFG_DICT, dict(over,
                                                              save=False)),
                      model=jm, params=v["params"],
                      batch_stats=v["batch_stats"], names=jm.names,
                      save_dir=str(tmp_path))
    tm = port_model(v)
    want = jp(frames)
    got = DetectionPredictor(args=get_cfg(overrides=dict(over, device="cpu")),
                             model=tm)(frames)
    assert sum(len(r) for r in got) > 0
    assert_results_paired(want, got, BOX_TOL, SCORE_TOL)
    with caplog.at_level(logging.WARNING, logger="dedark_yolo_tpu_torch"):
        tta = DetectionPredictor(args=get_cfg(overrides=dict(over, device="cpu",
                                                   augment=True)),
                                 model=tm)(frames)
    assert "single-scale inference" in caplog.text
    for g, t in zip(got, tta):
        np.testing.assert_array_equal(t.boxes.data, g.boxes.data)


def test_benchmark_rows(npz):
    rows = YOLO(npz, device="cpu").benchmark(imgsz=IMGSZ, batch_sizes=(2,),
                                             warmup=1, iters=1)
    assert [(r["precision"], r["batch"]) for r in rows] == \
        [("fp32", 2), ("bf16", 2)]
    assert all("error" not in r and r["img_per_sec"] > 0 for r in rows)


def test_pt2_equals_live(npz, tmp_path):
    m = YOLO(npz, device="cpu")
    path = m.export(format="pt2", imgsz=IMGSZ, batch=2, device="cpu",
                    project=str(tmp_path))
    u8 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8))
    back = AutoBackend(str(path), device="cpu")
    got = back(u8)
    with torch.no_grad():
        want = m.model.eval().eval_outputs(u8.float() / 255.0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_served_request_equals_predict(npz, frames):
    kw = dict(imgsz=IMGSZ, conf=0.25, max_det=50)
    srv = InferenceServer(npz, max_batch=1, max_wait_ms=1.0, device="cpu",
                          **kw)
    try:
        got = srv.submit(frames[0]).result(timeout=120)
    finally:
        srv.close()
    want = YOLO(npz, device="cpu").predict(frames[:1], device="cpu", batch=1,
                                           **kw)
    np.testing.assert_array_equal(got["boxes"], want[0].boxes.data)


def test_cli_predict_and_val(npz, dataset, frames, tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    for i, f in enumerate(frames):
        np.save(src / f"f{i}.npy", f)
    rc = cli.entrypoint(["predict", f"model={TINY}", f"source={src}",
                         f"imgsz={IMGSZ}", "conf=0.001", "device=cpu",
                         f"project={tmp_path / 'p'}"])
    assert rc == 0
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1].split("results ", 1)[1])
    assert res["images"] == 3 and res["detections"] > 0
    rc = cli.entrypoint(["val", f"model={npz}", f"data={dataset}",
                         f"imgsz={IMGSZ}", "batch=4", "workers=0",
                         "plots=False", "device=cpu"])
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                     .split("results ", 1)[1])
    want = YOLO(npz, device="cpu").val(data=dataset, imgsz=IMGSZ, batch=4,
                                       workers=0, plots=False, device="cpu",
                                       verbose=False)
    assert got == {k: float(v) for k, v in want.items()}
