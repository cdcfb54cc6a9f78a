"""Torch port vs the JAX package: the train loop's options of ROADMAP A10b,
on the CPU with the tiny model at imgsz 64.

- `DataLoader(use_processes=True)`: forked workers give the thread path's
  batches and the JAX package's process batches, bit for bit, over two
  shuffled epochs at the default augmentation; a worker's error reaches
  the consumer; workers take the default SIGTERM, so that `close()` ends
  them under the trainer's handler.
- `loader_mp=True` trains one epoch equal to threads (results.csv and
  last.npz), here with `profile=True` (the Chrome trace of micro-step 2
  under save_dir/profile/) and `plots=True` (a TensorBoard event file
  under save_dir/tb/ holding each epoch's metrics).
- The TensorBoard callbacks write what JAX's write, on the same trainer.
- Autobatch's fit equals JAX's on the same two measurements, and on a CPU
  device it raises.
"""

import signal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.data.augment import TrainTransforms as JaxTF  # noqa: E402
from dedark_yolo_tpu.data.dataset import YOLODataset as JaxDS  # noqa: E402
from dedark_yolo_tpu.data.loader import DataLoader as JaxDL  # noqa: E402
from dedark_yolo_tpu.utils import autobatch as jax_autobatch  # noqa: E402
from dedark_yolo_tpu.utils import callbacks as jax_callbacks  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.cfg import AUGMENT_KEYS, DEFAULT_CFG  # noqa: E402
from dedark_yolo_tpu_torch.data.augment import TrainTransforms  # noqa: E402
from dedark_yolo_tpu_torch.data import loader  # noqa: E402
from dedark_yolo_tpu_torch.data.dataset import YOLODataset  # noqa: E402
from dedark_yolo_tpu_torch.data.loader import DataLoader  # noqa: E402
from dedark_yolo_tpu_torch.utils import autobatch, callbacks  # noqa: E402
from dedark_yolo_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_torch_train_loop import COMMON, TINY, rows  # noqa: E402

IMGSZ = 64
HYP = {k: DEFAULT_CFG[k] for k in AUGMENT_KEYS}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs: the
    suite runs six workers on a few cores, and torch's default (one thread
    a core) spins them against each other. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def short_worker_timeout(monkeypatch):
    """A stuck worker fails its test within a minute, not the whole run."""
    monkeypatch.setattr(loader, "MP_BATCH_TIMEOUT", 60.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    return str(make_synth_dataset(root / "ds", n_train=6, n_val=2, imgsz=IMGSZ))


def _batches(dl, epochs=(0, 1)):
    out = []
    for e in epochs:
        dl.set_epoch(e)
        out += list(dl)
    return out


def test_process_batches_equal_threads_and_jax(data):
    train = str(Path(data).parent / "images" / "train")
    kw = dict(max_boxes=16, seed=5, workers=2)
    ours = [DataLoader(YOLODataset(train, imgsz=IMGSZ, nc=3),
                       TrainTransforms(HYP, imgsz=IMGSZ), 2, shuffle=True,
                       use_processes=mp, **kw) for mp in (False, True)]
    theirs = JaxDL(JaxDS(train, imgsz=IMGSZ, nc=3), JaxTF(HYP, imgsz=IMGSZ),
                   2, use_processes=True, **kw)
    try:
        got = [_batches(dl) for dl in ours]
        want = _batches(theirs)
    finally:
        ours[1].close()
        theirs.close()
    assert ours[1]._mp_pool is None
    assert len(got[0]) == len(got[1]) == len(want) == 6
    for t, p, j in zip(*got, want):
        for k in ("img", "cls", "mask_gt", "bboxes"):
            np.testing.assert_array_equal(p[k], t[k], err_msg=k)
        for k in ("img", "cls", "mask_gt"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        np.testing.assert_allclose(p["bboxes"], j["bboxes"], rtol=0,
                                   atol=1e-4 / IMGSZ)


def test_process_worker_error_reaches_the_consumer(data):
    train = str(Path(data).parent / "images" / "train")

    def broken(dataset, index, rng):
        raise ValueError(f"item {index}")

    dl = DataLoader(YOLODataset(train, imgsz=IMGSZ, nc=3), broken, 2,
                    workers=2, use_processes=True)
    try:
        with pytest.raises(ValueError, match="item"):
            next(iter(dl))
    finally:
        dl.close()


def test_workers_do_not_inherit_the_trainers_sigterm_handler():
    """The trainer's SIGTERM handler only flags a stop; a worker that ran
    it would outlive `close()` (terminate, then a join that waits for
    ever). Workers take the default SIGTERM and leave SIGINT to the
    parent."""
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: None)
    dl = DataLoader(list(range(4)), None, 2, workers=2, use_processes=True)
    try:
        pool = dl._pool()
        assert pool.apply(signal.getsignal, (signal.SIGTERM,)) == signal.SIG_DFL
        assert pool.apply(signal.getsignal, (signal.SIGINT,)) == signal.SIG_IGN
    finally:
        dl.close()
        signal.signal(signal.SIGTERM, prev)
    assert dl._mp_pool is None


def _train(data, tmp, name, **kw):
    m = YOLO(TINY, device="cpu", seed=0)
    m.train(data=data, project=str(tmp), name=name, device="cpu", epochs=1,
            **{**COMMON, **kw})
    return Path(tmp) / name, m.trainer


def test_loader_mp_profile_and_tensorboard_train(data, tmp_path):
    """One epoch with threads and one with process workers, the traced
    step and the TensorBoard writer on: equal results and weights."""
    run_t, _ = _train(data, tmp_path, "threads", plots=False)
    run_p, tr = _train(data, tmp_path, "procs", loader_mp=True, profile=True,
                       plots=True)
    assert tr.args.loader_mp and tr.train_dl._mp_pool is None   # closed
    assert rows(run_p) == rows(run_t)
    _, a = load_checkpoint(run_t / "weights" / "last.npz")
    _, b = load_checkpoint(run_p / "weights" / "last.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the trace of micro-step 2 (the epoch's third batch)
    assert tr.profile_trace == run_p / "profile" / "step2.pt.trace.json"
    text = tr.profile_trace.read_text()
    assert "traceEvents" in text and "aten::" in text
    assert not (run_t / "profile").exists()
    # the TensorBoard scalars: the epoch's metrics
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(run_p / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(tr.metrics)
    for k, v in tr.metrics.items():
        (ev,) = acc.Scalars(k)
        assert ev.step == 0 and ev.value == pytest.approx(float(v), rel=1e-6)
    assert not (run_t / "tb").exists()


def test_tensorboard_callbacks_write_what_jax_writes(tmp_path):
    """Both packages' TensorBoard callbacks on one stand-in trainer, two
    epochs: the same tags, steps and values."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    out = {}
    for name, cbs in (("jax", jax_callbacks.get_default_callbacks()),
                      ("port", callbacks.get_default_callbacks())):
        tr = SimpleNamespace(args=SimpleNamespace(plots=True), epoch=0,
                             save_dir=tmp_path / name, metrics={},
                             callbacks=cbs)
        if name == "jax":
            jax_callbacks.add_integration_callbacks(tr)
        else:
            callbacks.add_integration_callbacks(tr)
        for cb in cbs["on_train_start"]:
            cb(tr)
        for epoch in range(2):
            tr.epoch = epoch
            tr.metrics = {"metrics/mAP50(B)": 0.25 * epoch + 0.1,
                          "fitness": np.float32(0.5 + epoch),
                          "note": "not a number"}
            for cb in cbs["on_fit_epoch_end"]:
                cb(tr)
        for cb in cbs["on_train_end"]:
            cb(tr)
        acc = EventAccumulator(str(tmp_path / name / "tb"))
        acc.Reload()
        out[name] = {t: [(e.step, e.value) for e in acc.Scalars(t)]
                     for t in acc.Tags()["scalars"]}
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == ["fitness", "metrics/mAP50(B)"]


@pytest.mark.parametrize("m1, m2, limit", [
    (6.1e9, 9.3e9, 80e9), (2.0e9, 2.0e9, 16e9), (1e9, 1.5e9, 16e9),
    (30e9, 60e9, 80e9), (100e6, 110e6, 80e9), (12345678, 23456789, 2e9)])
def test_autobatch_fit_equals_jax(monkeypatch, m1, m2, limit):
    meas = {8: m1, 16: m2}
    monkeypatch.setattr(jax_autobatch, "device_memory_limit", lambda: limit)
    monkeypatch.setattr(jax_autobatch, "_step_memory",
                        lambda fn, args_fn, b: meas[b])
    want = jax_autobatch.autobatch(None, None)
    got, fixed, per_img = autobatch.fit_batch(m1, m2, limit)
    assert got == want and got % 8 == 0 and 8 <= got <= 512
    assert fixed + per_img * 8 == pytest.approx(m1)


def test_autobatch_raises_on_cpu():
    with pytest.raises(NotImplementedError, match="CPU"):
        autobatch.autobatch(lambda b: None, torch.device("cpu"))
