"""Torch port vs the JAX package: the plots of val and train, on the CPU.

- The arrays `ap_per_class(plot=True)` hands to each curve plot, captured
  by wrapping both packages' plot functions, equal JAX's within 1e-6 on the
  same seeded TP matrix, scores and classes.
- Each `plot_*` function of the port, given the arrays JAX's is given,
  writes a file whose decoded pixels equal those of JAX's file.
- A one-epoch train with `plots=True` writes the files the JAX trainer
  names (JAX engine/trainer.py:463-476, 566-574, 726-731, with val's five
  of JAX validator.py:386-391 and metrics.py:75-86). Val's five files
  beside JAX's, and its confusion matrix equal to JAX's on paired
  detections, are held in tests/test_torch_val.py's plots case.
- With matplotlib hidden, val and train run, draw no matplotlib plot, log
  one line naming matplotlib, and give the numbers of `plots=False`.
"""

import csv
import logging
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from dedark_yolo_tpu.utils import metrics as jax_metrics  # noqa: E402
from dedark_yolo_tpu.utils import plotting as jax_plotting  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.utils import metrics, plotting  # noqa: E402

from synth import make_synth_dataset  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
CURVE_ATOL = 1e-6
VAL_PLOTS = ["F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
             "confusion_matrix.png"]
TRAIN_PLOTS = sorted(VAL_PLOTS + ["labels.jpg", "labels_correlogram.jpg",
                                  "results.png", "train_batch0.jpg",
                                  "train_batch1.jpg", "train_batch2.jpg"])
TRAIN = {"imgsz": 64, "batch": 2, "nbs": 4, "optimizer": "SGD", "workers": 2,
         "seed": 0, "max_boxes": 8, "epochs": 1, "mosaic": 0.0,
         "device": "cpu", "verbose": False}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs (the
    suite runs six workers on a few cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def curve_inputs(seed=0, n=400, nc=4):
    """A seeded TP matrix, scores and classes; class 3 has no labels."""
    rng = np.random.default_rng(seed)
    tp = rng.random((n, 10)) < np.linspace(0.7, 0.2, 10)
    conf = rng.random(n).astype(np.float32)
    pred_cls = rng.integers(0, nc, n).astype(np.float32)
    target_cls = rng.integers(0, nc - 1, 120).astype(np.float32)
    return tp, conf, pred_cls, target_cls


def record_curves(monkeypatch, module):
    """Wrap a plotting module's two curve functions: the calls' arguments,
    in call order, with nothing drawn."""
    calls = []

    def pr(px, py, ap, save_dir, names):
        calls.append(("pr", Path(save_dir).name, px, np.stack(py, 1), ap, names))

    def mc(px, py, save_dir, names, xlabel="Confidence", ylabel="Metric"):
        calls.append((ylabel, Path(save_dir).name, px, py, None, names))
    monkeypatch.setattr(module, "plot_pr_curve", pr)
    monkeypatch.setattr(module, "plot_mc_curve", mc)
    return calls


def test_curve_inputs_equal_jax(monkeypatch, tmp_path):
    args = curve_inputs()
    names = {0: "person", 1: "debrisflow", 2: "rockfall", 3: "unlabelled"}
    want_calls = record_curves(monkeypatch, jax_plotting)
    got_calls = record_curves(monkeypatch, plotting)
    want = jax_metrics.ap_per_class(*args, plot=True, save_dir=tmp_path,
                                    names=names, prefix="val_")
    got = metrics.ap_per_class(*args, plot=True, save_dir=tmp_path,
                               names=names, prefix="val_")
    plain = metrics.ap_per_class(*args)
    assert [c[:2] for c in got_calls] == [c[:2] for c in want_calls] == [
        ("pr", "val_PR_curve.png"), ("F1", "val_F1_curve.png"),
        ("Precision", "val_P_curve.png"), ("Recall", "val_R_curve.png")]
    for g, w in zip(got_calls, want_calls):
        assert g[5] == w[5] == {0: "person", 1: "debrisflow", 2: "rockfall"}
        for a, b in zip(g[2:5], w[2:5]):
            if b is not None:
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=CURVE_ATOL)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_allclose(a, b, rtol=0, atol=CURVE_ATOL)
        np.testing.assert_array_equal(a, c)        # plot changes no number
    assert not list(tmp_path.iterdir())


def results_csv(path):
    rng = np.random.default_rng(4)
    keys = ["epoch", "train/box_loss", "train/cls_loss", "metrics/mAP50(B)",
            "lr"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        for e in range(5):
            w.writerow([e] + rng.random(len(keys) - 1).tolist())
    return path


def plot_batch():
    rng = np.random.default_rng(5)
    mask = np.zeros((5, 6), np.float32)
    mask[:, :3] = 1
    return {"img": rng.integers(0, 256, (5, 64, 80, 3), dtype=np.uint8),
            "bboxes": rng.uniform(0.2, 0.6, (5, 6, 4)).astype(np.float32),
            "cls": rng.integers(0, 3, (5, 6)).astype(np.float32),
            "mask_gt": mask}


def draw(mod, which, out):
    """Draw plot `which` with module `mod` under directory `out`; the
    paths written."""
    rng = np.random.default_rng(6)
    names = {0: "person", 1: "debrisflow", 2: "rockfall"}
    px = np.linspace(0, 1, 1000)
    out.mkdir()
    if which == "pr":
        py = [np.sort(rng.random(1000))[::-1] for _ in range(3)]
        mod.plot_pr_curve(px, py, rng.random((3, 10)), out / "PR_curve.png",
                          names)
    elif which == "mc":
        mod.plot_mc_curve(px, rng.random((3, 1000)), out / "F1_curve.png",
                          names, ylabel="F1")
    elif which == "confusion":
        mod.plot_confusion_matrix(rng.integers(0, 9, (4, 4)).astype(float),
                                  names, out / "confusion_matrix.png")
    elif which == "results":
        mod.plot_results(results_csv(out / "results.csv"))
        (out / "results.csv").unlink()
    elif which == "images":
        mod.plot_images(plot_batch(), out / "train_batch0.jpg", names=names)
    elif which == "labels":
        mod.plot_labels(rng.uniform(0.05, 0.9, (60, 4)),
                        rng.integers(0, 3, 60), names=names, save_dir=out)
    return sorted(out.iterdir())


@pytest.mark.parametrize("which", ["pr", "mc", "confusion", "results",
                                   "images", "labels"])
def test_plot_pixels_equal_jax(tmp_path, which):
    want = draw(jax_plotting, which, tmp_path / "jax")
    got = draw(plotting, which, tmp_path / "port")
    assert [p.name for p in got] == [p.name for p in want] and got
    for g, w in zip(got, want):
        a, b = (cv2.imread(str(p), cv2.IMREAD_UNCHANGED) for p in (g, w))
        assert a is not None and a.shape == b.shape and a.size > 1000
        np.testing.assert_array_equal(a, b, err_msg=g.name)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    data = str(make_synth_dataset(root / "ds", n_train=6, n_val=2, imgsz=64))
    m = YOLO(TINY, device="cpu", seed=0)
    m.train(data=data, project=str(root), name="off", plots=False, **TRAIN)
    return data, root / "off"


def rows(run):
    with open(run / "results.csv") as f:
        return list(csv.reader(f))


def plot_files(run):
    return sorted(p.name for p in run.iterdir()
                  if p.suffix in (".png", ".jpg"))


def test_train_plots(train_data, tmp_path):
    data, off = train_data
    m = YOLO(TINY, device="cpu", seed=0)
    m.train(data=data, project=str(tmp_path), name="on", plots=True, **TRAIN)
    run = tmp_path / "on"
    assert plot_files(run) == TRAIN_PLOTS
    assert plot_files(off) == []
    assert rows(run) == rows(off)
    img = cv2.imread(str(run / "train_batch0.jpg"))
    assert img.shape == (64, 128, 3)           # the two images side by side


def matplotlib_lines(caplog, tmp_path):
    """The log lines that name matplotlib outside the run's path."""
    return [m for m in (r.getMessage() for r in caplog.records)
            if "matplotlib" in m.replace(str(tmp_path), "")]


def test_no_matplotlib(train_data, tmp_path, monkeypatch, caplog):
    data, off = train_data
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert not plotting.matplotlib_available()
    monkeypatch.chdir(tmp_path)                 # val writes under runs/
    val_kw = {"data": data, "imgsz": 64, "batch": 2, "workers": 2,
              "device": "cpu", "verbose": False}
    m = YOLO(TINY, device="cpu", seed=0)
    with caplog.at_level(logging.INFO, logger="dedark_yolo_tpu_torch"):
        on = m.val(plots=True, **val_kw)
    assert len(matplotlib_lines(caplog, tmp_path)) == 1
    off_val = m.val(plots=False, **val_kw)
    assert {k: float(v) for k, v in on.items()} == \
        {k: float(v) for k, v in off_val.items()}
    assert not list(tmp_path.rglob("*.png"))
    caplog.clear()
    m = YOLO(TINY, device="cpu", seed=0)
    with caplog.at_level(logging.INFO, logger="dedark_yolo_tpu_torch"):
        m.train(data=data, project=str(tmp_path), name="on", plots=True,
                **TRAIN)
    assert len(matplotlib_lines(caplog, tmp_path)) == 1
    run = tmp_path / "on"
    # only OpenCV's batch mosaics; the numbers of plots=False
    assert plot_files(run) == ["train_batch0.jpg", "train_batch1.jpg",
                               "train_batch2.jpg"]
    assert rows(run) == rows(off)
