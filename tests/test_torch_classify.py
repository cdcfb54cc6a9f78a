"""Torch port vs the JAX package: the classify task (CPU, f32).

JAX's `CLS_TINY` (tests/test_classify.py) and `yolov8n-cls.yaml` at small
sizes, on shared numpy-seeded weights drawn into the flax trees and loaded
through `state_dict_from_jax`, and a seeded folder tree of `.jpg` images of
mixed sizes (3 classes; 12 train and 9 val images, so val's batch of 4
pads its last batch). Bars, each with its reason:
  - the dataset's items, Probs' top-1/top-5, the validator's top-1/top-5,
    the sidecar: exact (integer resize bit-equal to cv2's, the same argsort
    of the same probabilities);
  - eval probabilities 1e-6 absolute, train-mode logits 1e-5 of their
    largest (f32 convolutions summing in another order than XLA's);
  - one accumulation window of the trainer: tests/test_torch_train_slice.py's
    bars (loss 3e-5 relative; BN stats and EMA 2e-6; momentum buffers 2e-3
    of their largest; parameters and EMA 1e-6 plus 1e-3 of the largest
    move);
  - a `.pt2` artifact's probabilities 1e-5 of the live model's (the
    exported program against eager).
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine import classify as JC  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine import classify as TC  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    opt_state_from_jax, state_dict_from_jax, state_dict_to_jax)

from test_classify import CLS_TINY  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401
from test_torch_train_slice import close  # noqa: E402

IMGSZ = 64
NB, STEPS = 20, (37, 38)       # inside the warmup ramp
CLS_N = "yolov8n-cls.yaml"


@pytest.fixture(scope="module")
def cls_data(tmp_path_factory):
    """root/{train,val}/color{0,1,2}/k.jpg, each image of its own size."""
    root = tmp_path_factory.mktemp("clsds")
    rng = np.random.default_rng(0)
    colors = [(200, 40, 40), (40, 200, 40), (40, 40, 200)]
    for split, n in (("train", 4), ("val", 3)):
        for c, color in enumerate(colors):
            d = root / split / f"color{c}"
            d.mkdir(parents=True)
            for k in range(n):
                h, w = (int(v) for v in rng.integers(30, 90, 2))
                img = np.full((h, w, 3), color, np.uint8)
                img += rng.integers(0, 40, img.shape).astype(np.uint8)
                cv2.imwrite(str(d / f"{k}.jpg"), img)
    return root


def _variables(jm, imgsz=IMGSZ, seed=0):
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, imgsz, imgsz, 3),
                                                   jnp.float32))
    return to_plain(randomize(template, np.random.default_rng(seed)))


@pytest.fixture(scope="module")
def pair():
    """yolov8n-cls at nc 3: the JAX model and its variables, the port's
    model with the same weights (CPU, eval mode)."""
    jm = JaxModel(jax_yaml_load(CLS_N), nc=3)
    v = _variables(jm)
    tm = DetectionModel(model_yaml_load(CLS_N), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm.eval()


def test_dataset_scan_and_load_equal_jax(cls_data, tmp_path):
    """The scan (splits, names, nc, samples) and every item, eval and
    train (its flip drawn from the item's rng), from the .jpg files; then
    with cache='disk' from the .npy sidecars the first pass wrote."""
    jd, td = JC.check_cls_dataset(cls_data), TC.check_cls_dataset(cls_data)
    assert td == jd and td["nc"] == 3
    for split in ("train", "val"):
        jds = JC.ClassificationDataset(jd[split], IMGSZ, jd["names"])
        first = TC.ClassificationDataset(td[split], IMGSZ, td["names"],
                                         cache="disk")
        assert first.samples == jds.samples
        for i in range(len(jds)):
            for train in (False, True):
                rj, rt = random.Random(7 * i), random.Random(7 * i)
                ji, jc = jds.load(i, train=train, rng=rj)
                ti, tc = first.load(i, train=train, rng=rt)
                assert tc == jc and ti.shape == (IMGSZ, IMGSZ, 3)
                np.testing.assert_array_equal(ti, ji)
        sidecars = sorted(Path(td[split]).rglob("*.npy"))
        assert len(sidecars) == len(jds)
        again = TC.ClassificationDataset(td[split], IMGSZ, td["names"],
                                         cache="disk")
        for i in range(len(jds)):
            np.testing.assert_array_equal(again.load(i)[0], jds.load(i)[0])
        for f in sidecars:
            f.unlink()


@pytest.mark.parametrize("scale", list("nsmlx"))
def test_param_counts_equal_jax(scale):
    name = f"yolov8{scale}-cls.yaml"
    jm = JaxModel(jax_yaml_load(name))
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = DetectionModel(model_yaml_load(name))
    assert tm.task == jm.task == "classify" and tm.nc == 1000
    assert sum(p.numel() for p in tm.parameters()) == want


def test_weights_round_trip(pair):
    """flax trees -> the port's state_dict -> flax trees, equal; the head's
    Dense kernel transposed only (no fc1 permutation)."""
    jm, v, tm = pair
    back = state_dict_to_jax(tm.state_dict(), tm)
    for section in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(v[section])
        got = dict(jax.tree_util.tree_leaves_with_path(back[section]))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf)
    head = f"model.{len(tm.specs) - 1}"
    np.testing.assert_array_equal(
        tm.state_dict()[f"{head}.linear.weight"].numpy(),
        v["params"][f"mods_{len(tm.specs) - 1}"]["Dense_0"]["kernel"].T)


def test_logits_and_probs_match_jax(pair):
    jm, v, tm = pair
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(
        np.float32)
    probs = np.asarray(jax.jit(jm.apply_eval)(v, jnp.asarray(x)))
    (got,) = tm.eval_outputs(torch.from_numpy(x))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.detach().numpy(), probs, rtol=0, atol=1e-6)
    logits, stats = jax.jit(jm.apply_train)(v, jnp.asarray(x))
    tm.train()
    try:
        out = tm(torch.from_numpy(x)).detach().numpy()
    finally:
        tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
        tm.eval()
    scale = float(np.abs(np.asarray(logits)).max())
    np.testing.assert_allclose(out / scale, np.asarray(logits) / scale,
                               rtol=0, atol=1e-5)


def _batches(seed=0, b=2, nc=3):
    rng = np.random.default_rng(seed)
    return [{"img": rng.integers(0, 256, (b, 32, 32, 3), np.uint8),
             "cls": rng.integers(0, nc, (b,)).astype(np.int32)}
            for _ in STEPS]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_train_window_matches_jax(smoothing):
    """One accumulation window (two micro-steps of b2, nbs 4) of CLS_TINY
    at 32: ClassificationTrainer.step against JAX's tree-path train_step
    of its ClassificationTrainer, SGD inside the warmup ramp."""
    overrides = {"batch": 2, "nbs": 4, "epochs": 10, "imgsz": 32,
                 "optimizer": "SGD", "lr0": 0.02, "label_smoothing": smoothing}
    jm = JaxModel(dict(CLS_TINY))
    v = _variables(jm, 32)
    jt = JC.ClassificationTrainer.__new__(JC.ClassificationTrainer)
    jt.args = jax_get_cfg(DEFAULT_CFG_DICT, overrides)
    jt.data = {"nc": 3}
    jt.build_optimizer(NB)
    jt._opt_spec = None
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = v["params"], v["batch_stats"]
    jopt = jax_init_opt(jp)
    jema = {"params": jax_ema_init(jp), "batch_stats": jax_ema_init(jbs)}
    jeu = jnp.int32(0)

    tm = DetectionModel(dict(CLS_TINY))
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    tt = TC.ClassificationTrainer(overrides, model=tm, nb=NB, device="cpu")
    assert (tt.opt_name, tt.accumulate) == (jt.opt_name, jt.accumulate)
    for i, batch in zip(STEPS, _batches()):
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu,
            {k: jnp.asarray(a) for k, a in batch.items()},
            jnp.float32(jt._lr_at(i, "bias")),
            jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        total, items = tt.step(batch, i)
        np.testing.assert_allclose(items.numpy(), np.stack(jitems), rtol=3e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=3e-5)
    assert tt.opt_state.step == int(jopt.step) == 1 and tt.ema_updates == 1

    want = state_dict_from_jax({"params": jp, "batch_stats": jbs}, tm)
    want_ema = state_dict_from_jax(jema, tm)
    start = state_dict_from_jax(v, tm)
    jbuf = opt_state_from_jax(jopt, tm)
    got = tm.state_dict()
    for k, w in want.items():
        if "running_" in k:
            close(got[k], w, 2e-6, k)
            close(tt.ema[k], want_ema[k], 2e-6, k)
            continue
        if jbuf.buf[k].abs().max() > 0:
            close(tt.opt_state.buf[k], jbuf.buf[k],
                  2e-3 * float(jbuf.buf[k].abs().max()), k)
        tol = 1e-6 + 1e-3 * float((w - start[k]).abs().max())
        close(got[k], w, tol, k)
        close(tt.ema[k], want_ema[k], tol, k)


def _jax_args(**kw):
    return jax_get_cfg(DEFAULT_CFG_DICT, {"imgsz": IMGSZ, **kw})


def test_validator_matches_jax(pair, cls_data):
    """Top-1 and top-5 over the 9 val images at batch 4 (the last batch
    padded): equal, on the live model and on its AutoBackend."""
    jm, v, tm = pair
    jres = JC.ClassificationValidator(args=_jax_args(data=str(cls_data),
                                                     batch=4))(
        model=jm, params=v["params"], batch_stats=v["batch_stats"])
    args = get_cfg(overrides={"data": str(cls_data), "imgsz": IMGSZ, "batch": 4,
                    "device": "cpu"})
    tres = TC.ClassificationValidator(args=args)(model=tm)
    assert tres == jres
    assert round(tres["metrics/accuracy_top1"] * 9, 6) % 1 == 0


def test_predictor_probs_match_jax(pair):
    """Three frames of mixed sizes at batch 2 (the last padded): Probs'
    data, top1, top5 and confidences against JAX's predictor."""
    jm, v, tm = pair
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in ((40, 70), (64, 64), (90, 33))]
    jp = JC.ClassificationPredictor(args=_jax_args(batch=2), model=jm,
                                    params=v["params"],
                                    batch_stats=v["batch_stats"],
                                    names={0: "a", 1: "b", 2: "c"})
    want = jp(list(frames))
    got = TC.ClassificationPredictor(
        args=get_cfg(overrides={"imgsz": IMGSZ, "batch": 2, "device": "cpu"}),
        model=tm, names={0: "a", 1: "b", 2: "c"})(list(frames))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.probs.data, w.probs.data, atol=1e-6)
        assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
        assert g.verbose() == w.verbose() and len(g) == 0
        np.testing.assert_array_equal(g.orig_img, w.orig_img)


def test_export_pt2_and_autobackend_match_live(pair, cls_data, tmp_path):
    """A classify .pt2 at b2: its probs through AutoBackend within 1e-5 of
    the live eval_outputs, its sidecar equal to the one JAX's exporter
    writes for the same model, YOLO(pt2).predict and .val equal to live."""
    from dedark_yolo_tpu.engine.exporter import Exporter as JaxExporter
    jm, v, tm = pair
    y = YOLO(CLS_N, nc=3, device="cpu")
    y.load_state_dict(tm.state_dict())
    path = y.export(format="pt2", imgsz=IMGSZ, batch=2, device="cpu",
                    project=str(tmp_path / "pt2"))
    jpath = JaxExporter(_jax_args(format="bin", batch=2,
                                  project=str(tmp_path / "jax")))(
        jm, v["params"], v["batch_stats"])
    got = json.loads(Path(path + ".json").read_text())
    assert got == json.loads(Path(jpath + ".json").read_text())
    assert got["task"] == "classify" and got["outputs"] == [
        {"name": "probs", "shape": [2, 3]}]
    be = AutoBackend(path, device="cpu")
    assert be.task == "classify" and (be.imgsz, be.batch) == (IMGSZ, 2)
    u8 = np.random.default_rng(6).integers(0, 256, (2, IMGSZ, IMGSZ, 3),
                                           np.uint8)
    (probs,) = be.forward(u8)
    with torch.no_grad():
        (live,) = y.model.eval_outputs(torch.from_numpy(u8).float() / 255.0)
    np.testing.assert_allclose(probs.numpy(), live.numpy(), rtol=0, atol=1e-5)
    art = YOLO(path, device="cpu")
    assert art.task == "classify"
    frames = [u8[0][..., ::-1], u8[1][..., ::-1], u8[0]]
    pa = art.predict(list(frames), device="cpu")
    pl = y.predict(list(frames), imgsz=IMGSZ, batch=2, device="cpu")
    for a, b in zip(pa, pl):
        np.testing.assert_allclose(a.probs.data, b.probs.data, atol=1e-5)
        assert a.probs.top5 == b.probs.top5
    kw = {"data": str(cls_data), "device": "cpu"}
    assert art.val(**kw) == y.val(imgsz=IMGSZ, batch=2, **kw)


def test_facade_trains_then_cli_validates(cls_data, tmp_path, capsys,
                                          caplog):
    """YOLO("yolov8n-cls.yaml").train on the folder tree (nc from the
    data): results.csv with the classify columns, best.npz that rebuilds
    the classify model; then `python -m dedark_yolo_tpu_torch classify
    val model=best.npz` prints the metrics of YOLO(best.npz).val(); the
    `detect` token on it warns and keeps the model's task; `classify
    predict` without a model builds yolov8-cls.yaml."""
    y = YOLO(CLS_N, device="cpu")
    res = y.train(data=str(cls_data), epochs=2, imgsz=32, batch=4, nbs=4,
                  workers=2, device="cpu", project=str(tmp_path / "runs"),
                  name="cls", plots=False, cache="disk")
    assert set(res) == {"metrics/accuracy_top1", "metrics/accuracy_top5",
                        "fitness"}
    run = tmp_path / "runs" / "cls"
    rows = (run / "results.csv").read_text().splitlines()
    assert rows[0] == ("epoch,train/loss_loss,metrics/accuracy_top1,"
                       "metrics/accuracy_top5,lr") and len(rows) == 3
    best = run / "weights" / "best.npz"
    assert y.model.task == "classify" and y.model.nc == 3 and best.is_file()
    want = YOLO(str(best), device="cpu").val(device="cpu")
    rc = cli.entrypoint(["classify", "val", f"model={best}", "device=cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1][len("results "):]) == want
    with caplog.at_level("WARNING", logger="dedark_yolo_tpu_torch"):
        assert cli.entrypoint(["detect", "val", f"model={best}",
                               "device=cpu"]) == 0
    assert "using the model's task" in caplog.text
    assert json.loads(capsys.readouterr().out.splitlines()[-1][8:]) == want
    src = str(cls_data / "val" / "color0" / "0.jpg")
    assert cli.entrypoint(["classify", "predict", f"source={src}",
                           "imgsz=32", "device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1][8:])
    assert got["images"] == 1 and 0 <= got["top1"][0] < 1000
