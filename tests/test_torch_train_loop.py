"""Torch port vs the JAX package: the train loop (`YOLO(...).train()`) of
tests/tiny_model.yaml at imgsz 64, batch 2 (nbs 4: an update every two
micro-steps), SGD, on tests/synth.py data with the augmentation off, so
that both loaders give bit-equal batches; both packages warm-start from
one seeded .npz. The JAX trainer runs its tree path (DEDARK_FUSED_OPT=0)
on one device.

Bars: tests/test_torch_train_slice.py's, for the same reasons (the worst
case measured here on the CPU in brackets):
  - loss rows of results.csv 3e-5 relative (1.2e-6): each epoch's mean of
    the micro-steps' items, which sum in another order after a forward
    through train-mode BN;
  - the metrics 1e-6 absolute, lr equal;
  - the checkpoint sections: BN running stats and their EMA 2e-6 absolute
    (3.6e-7); every other tensor 1e-6 plus 2e-3 of its largest move from
    the start, 2e-2 in layer 0's parameter CNN (8.6e-6 of the move);
  - meta epoch, updates and best_fitness equal.
Across the packages, a last.npz of either resumes in either, and the next
epoch's loss row and checkpoint agree within the same bars; one epoch then
resume=True gives the same run as two epochs straight, bit for bit.
"""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from dedark_yolo_tpu import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine import trainer as T  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, section_tree)
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from synth import make_synth_dataset  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
OFF = {"mosaic": 0.0, "mixup": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0,
       "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0,
       "perspective": 0.0, "flipud": 0.0, "fliplr": 0.0, "photometric": False}
COMMON = {"imgsz": 64, "batch": 2, "nbs": 4, "optimizer": "SGD", "workers": 2,
          "seed": 0, "max_boxes": 8, "plots": False, **OFF}
LOSS_RTOL = 3e-5
SECTIONS = ("params", "batch_stats", "ema", "ema_bs")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs: the
    suite runs six workers on a few cores, and torch's default (one thread
    a core) spins them against each other. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    data = str(make_synth_dataset(root / "ds", n_train=6, n_val=2, imgsz=64))
    jm = JaxYOLO(TINY)
    jm._ensure_params(imgsz=64)
    npz = root / "seed.npz"
    jax_save(npz, params=jax.device_get(jm.params),
             batch_stats=jax.device_get(jm.batch_stats),
             model_yaml=jm.model_yaml)
    return root, data, str(npz)


def jax_train(data, npz, project, name, monkeypatch, **kw):
    monkeypatch.setenv("DEDARK_FUSED_OPT", "0")
    m = JaxYOLO(npz)
    m.train(data=data, project=str(project), name=name, mesh_shape=[1],
            **{**COMMON, **kw})
    return Path(project) / name


def torch_train(data, npz, project, name, callbacks=(), **kw):
    m = YOLO(npz, device="cpu")
    for event, fn in callbacks:
        m.add_callback(event, fn)
    m.train(data=data, project=str(project), name=name, device="cpu",
            **{**COMMON, **kw})
    return Path(project) / name, m


def rows(run):
    with open(run / "results.csv") as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def compare_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and g["lr"] == pytest.approx(w["lr"], rel=1e-12)
        for k in w:
            if k.endswith("_loss"):
                assert g[k] == pytest.approx(w[k], rel=LOSS_RTOL), k
            elif k.startswith("metrics/"):
                assert g[k] == pytest.approx(w[k], abs=1e-6), k


def state_of(flat, model, section):
    bs = {"params": "batch_stats", "ema": "ema_bs"}[section]
    return state_dict_from_jax({"params": section_tree(flat, section),
                                "batch_stats": section_tree(flat, bs)}, model)


def compare_ckpt(got_path, want_path, start_path):
    gm, gf = load_checkpoint(got_path)
    wm, wf = load_checkpoint(want_path)
    for k in ("epoch", "updates", "best_fitness"):
        assert gm[k] == wm[k], k
    for sec in SECTIONS:
        assert {k for k in gf if k.startswith(sec + "/")} == \
            {k for k in wf if k.startswith(sec + "/")}
    model = DetectionModel(gm["model_yaml"])
    _, sf = load_checkpoint(start_path)
    start = state_of(sf, model, "params")
    for sec in ("params", "ema"):
        got, want = state_of(gf, model, sec), state_of(wf, model, sec)
        for k, w in want.items():
            g = got[k]
            if "running_" in k:
                tol = 2e-6
            else:
                rel = 2e-2 if k.startswith("model.0.") else 2e-3
                tol = 1e-6 + rel * float((w - start[k]).abs().max())
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                       err_msg=f"{sec} {k}")


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Two epochs in each package from the same seeded weights."""
    root, data, npz = setup
    mp = pytest.MonkeyPatch()
    try:
        jrun = jax_train(data, npz, root / "runs", "jax", mp, epochs=2)
    finally:
        mp.undo()
    trun, tm = torch_train(data, npz, root / "runs", "torch", epochs=2)
    return jrun, trun, tm


def test_loop_matches_jax(runs, setup):
    jrun, trun, _ = runs
    compare_rows(rows(trun), rows(jrun))
    assert len(rows(trun)) == 2
    for ck in ("last.npz", "best.npz"):
        compare_ckpt(trun / "weights" / ck, jrun / "weights" / ck, setup[2])
    meta, flat = load_checkpoint(trun / "weights" / "last.npz")
    assert meta["has"] == ["params", "batch_stats", "ema", "ema_bs", "opt"]
    assert any(k.startswith("opt/.acc/") for k in flat)
    assert "opt" not in load_checkpoint(trun / "weights" / "best.npz")[0]["has"]
    assert (trun / "args.yaml").is_file() and (trun / "metrics.jsonl").is_file()
    import yaml
    args = yaml.safe_load((trun / "args.yaml").read_text())   # JAX's reader
    assert args["epochs"] == 2 and args["batch"] == 2


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_last_npz_resumes_across_packages(runs, setup, tmp_path, source,
                                          monkeypatch):
    """The last.npz of `source` resumes for a third epoch in both
    packages; their epoch rows and checkpoints agree."""
    _, data, npz = setup
    last = {"torch": runs[1], "jax": runs[0]}[source] / "weights" / "last.npz"
    for name in ("j", "t"):
        (tmp_path / name / "weights").mkdir(parents=True)
        shutil.copy(last, tmp_path / name / "weights" / "last.npz")
    jrun = jax_train(data, npz, tmp_path, "j", monkeypatch, epochs=3,
                     resume=True)
    trun, _ = torch_train(data, npz, tmp_path, "t", epochs=3, resume=True)
    (jrow,), (trow,) = rows(jrun), rows(trun)
    assert trow["epoch"] == jrow["epoch"] == 2
    compare_rows([trow], [jrow])
    compare_ckpt(trun / "weights" / "last.npz", jrun / "weights" / "last.npz",
                 npz)


def test_resume_equals_straight_run(runs, setup, tmp_path):
    """Two epochs stopped after the first (the SIGTERM path) and resumed:
    the same results rows and last.npz as two epochs straight."""
    _, data, npz = setup

    def stop(trainer):
        trainer._interrupted = True

    run, _ = torch_train(data, npz, tmp_path, "r", epochs=2,
                         callbacks=[("on_fit_epoch_end", stop)])
    assert [r["epoch"] for r in rows(run)] == [0]
    assert load_checkpoint(run / "weights" / "last.npz")[0]["epoch"] == 0
    run, _ = torch_train(data, npz, tmp_path, "r", epochs=2, resume=True)
    straight = runs[1]
    assert rows(run) == rows(straight)
    _, a = load_checkpoint(run / "weights" / "last.npz")
    _, b = load_checkpoint(straight / "weights" / "last.npz")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_periods_close_mosaic_and_best_reload(setup, tmp_path, monkeypatch):
    """Three epochs, mosaic on and close_mosaic=1, ckpt_period=2,
    save_period=1: last.npz at epochs 1 and 2 (the final), epoch{N}.npz
    every epoch, mosaic off only in the last epoch; YOLO.train leaves the
    facade holding best.npz's EMA weights."""
    _, data, npz = setup
    writes, mosaic = [], []
    orig = T.DetectionTrainer._ckpt_async

    def spy(self, path, common, opt=None):
        writes.append((Path(path).name, common["epoch"]))
        return orig(self, path, common, opt)

    monkeypatch.setattr(T.DetectionTrainer, "_ckpt_async", spy)
    run, m = torch_train(
        data, npz, tmp_path, "p", epochs=3, mosaic=1.0, close_mosaic=1,
        ckpt_period=2, save_period=1,
        callbacks=[("on_train_epoch_end",
                    lambda t: mosaic.append(t.train_tf.mosaic_enabled))])
    assert mosaic == [True, True, False]
    assert [e for n, e in writes if n == "last.npz"] == [1, 2]
    assert [n for n, _ in writes if n.startswith("epoch")] == \
        ["epoch0.npz", "epoch1.npz", "epoch2.npz"]
    meta, flat = load_checkpoint(run / "weights" / "best.npz")
    want = state_of(flat, m.model, "ema")
    got = m.model.state_dict()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=0)


def test_early_stopping_ends_the_loop(setup, tmp_path, monkeypatch):
    """Falling fitness with patience 1: the loop stops after the second
    epoch of five, writes last.npz there, and best.npz stays the first
    epoch's."""
    _, data, npz = setup
    fitness = iter([0.5, 0.4, 0.3, 0.2, 0.1])
    monkeypatch.setattr(T.DetectionTrainer, "_validate",
                        lambda self, state=None: {"fitness": next(fitness)})
    run, _ = torch_train(data, npz, tmp_path, "es", epochs=5, patience=1)
    assert [r["epoch"] for r in rows(run)] == [0, 1]
    assert load_checkpoint(run / "weights" / "last.npz")[0]["epoch"] == 1
    meta = load_checkpoint(run / "weights" / "best.npz")[0]
    assert meta["epoch"] == 0 and meta["best_fitness"] == 0.5


def test_pretrained_npz_warm_start(setup, tmp_path):
    """YOLO(yaml).train(pretrained=npz) starts from the npz's weights, as
    YOLO(npz).train() does: the same run."""
    _, data, npz = setup
    a, _ = torch_train(data, npz, tmp_path, "a", epochs=1)
    m = YOLO(TINY, device="cpu", seed=1)
    m.train(data=data, project=str(tmp_path), name="b", device="cpu",
            pretrained=npz, epochs=1, **COMMON)
    assert m.trainer.transferred[0] == m.trainer.transferred[1]
    assert rows(tmp_path / "b") == rows(a)


def test_npz_facade_wins_over_pretrained(setup, tmp_path):
    """YOLO(a.npz).train(pretrained=b.npz) starts from a, as in JAX
    (engine/model.py:148-150): the weights a facade loaded from an .npz
    win over `pretrained`."""
    _, data, npz = setup
    a, _ = torch_train(data, npz, tmp_path, "a", epochs=1)
    other = a / "weights" / "last.npz"
    torch_train(data, npz, tmp_path, "b", epochs=1, pretrained=str(other))
    assert rows(tmp_path / "b") == rows(a)


def test_early_stopping_matches_jax():
    from dedark_yolo_tpu.engine.trainer import EarlyStopping as JaxES
    seq = [0.1, 0.3, 0.2, 0.2, 0.25, 0.31, 0.1, 0.1, 0.1]
    for patience in (0, 1, 2, 3):
        a, b = T.EarlyStopping(patience), JaxES(patience)
        assert [a(e, f) for e, f in enumerate(seq)] == \
            [b(e, f) for e, f in enumerate(seq)]


def test_autobatch_and_amp_raise(setup, tmp_path):
    """Autobatch (batch < 0) raises; amp=True, which raised until bf16
    training was ported, now trains and records amp in its checkpoint
    (tests/test_torch_amp.py holds it to the JAX package)."""
    _, data, npz = setup
    with pytest.raises(NotImplementedError):
        torch_train(data, npz, tmp_path, "ab", epochs=1, batch=-1)
    run, m = torch_train(data, npz, tmp_path, "amp", epochs=1, amp=True)
    assert m.trainer.args.amp
    meta, _ = load_checkpoint(run / "weights" / "last.npz")
    assert meta["train_args"]["amp"] is True
