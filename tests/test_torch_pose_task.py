"""Torch port vs the JAX package: the pose task's validator, predictor,
Keypoints, export and CLI (CPU, f32), on JAX's `POSE_TINY` with
numpy-seeded weights (the layer-0 variant for predict too) and the seeded
keypoint dataset of tests/test_torch_pose_data.py. Bars, each with its
reason:
  - the validator's box and pose mAP50 / mAP50-95 and fitness: 1e-9; per
    image, detections paired on native box (2e-3 px: 4e-4 px in the
    letterbox, scaled to the original image) and class, their box and pose
    TP rows equal; its save_json rows paired with JAX's, box within 2e-3
    px, score 1e-5, keypoints 2e-3 px;
  - the predictor: detections paired (tests/pairing.py, box 4e-4 px, score
    1e-5), each paired detection's keypoints within 4e-4 px in x and y
    (the box bar: both are f32 convolution outputs times the stride,
    through the same letterbox inverse) and 1e-5 in visibility (a
    sigmoid, the score bar); JAX's side letterboxes natively
    (tests/jax_native.py);
  - a `.pt2` artifact: its three outputs within 1e-5 of the live
    eval_outputs, its sidecar equal to the one JAX's exporter writes, and
    YOLO(pt2).val() and .predict() equal to the live model's;
  - the CLI: `pose val` prints YOLO(npz).val()'s results.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine import pose as JPose  # noqa: E402
from dedark_yolo_tpu.engine.results_extra import Keypoints as JaxKeypoints  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg  # noqa: E402
from dedark_yolo_tpu_torch.engine import pose as TPose  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.engine.results import Keypoints, Results  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired  # noqa: E402
from test_torch_pose_data import make_pose_dataset  # noqa: E402
from test_torch_pose_model import POSE_TINY, POSE_TINY_L0, pose_pair  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

IMGSZ = 96
VAL_KW = {"imgsz": IMGSZ, "batch": 4, "conf": 0.001, "max_nms": 256,
          "max_det": 30, "max_boxes": 8, "plots": False}
KPT_PX = 4e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_pose_dataset(tmp_path_factory.mktemp("posetask"), n_train=8,
                             n_val=6, seed=3)


@pytest.fixture(scope="module")
def pair():
    return pose_pair(POSE_TINY, seed=4)


def _jax_args(**kw):
    return jax_get_cfg(DEFAULT_CFG_DICT, {**VAL_KW, **kw})


def _port_args(**kw):
    return get_cfg(overrides={**VAL_KW, "device": "cpu", **kw})


def _recorder(monkeypatch, mod):
    """Wrap `mod`'s match_predictions and match_from_iou: each call's
    inputs and TP matrix, in call order (the box branch, then the pose
    branch where the image has detections and instances)."""
    calls = []
    mp, mi = mod.match_predictions, mod.match_from_iou

    def box(pb, pc, gb, gc, *a, **k):
        out = mp(pb, pc, gb, gc, *a, **k)
        calls.append(("box", np.asarray(pb, np.float64), np.asarray(pc), out))
        return out

    def pose(oks, *a, **k):
        out = mi(oks, *a, **k)
        calls.append(("pose", np.asarray(oks), out))
        return out

    monkeypatch.setattr(mod, "match_predictions", box)
    monkeypatch.setattr(mod, "match_from_iou", pose)
    return calls


def test_validator_matches_jax(pair, data, tmp_path, monkeypatch):
    """Box and pose mAP over 6 images at batch 4 (the last padded), the
    per-image box and pose TP rows of paired detections, and the
    save_json rows."""
    jm, v, tm = pair
    jcalls, tcalls = _recorder(monkeypatch, JPose), _recorder(monkeypatch, TPose)
    want = JPose.PoseValidator(
        args=_jax_args(save_json=True), save_dir=tmp_path / "jax",
        data=data, kpt_shape=(3, 3))(model=jm, params=v["params"],
                                     batch_stats=v["batch_stats"])
    val = TPose.PoseValidator(args=_port_args(save_json=True),
                              save_dir=tmp_path / "port", data=data,
                              kpt_shape=(3, 3))
    got = val(model=tm)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-9, k
    with pytest.raises(ValueError, match="kpt_shape"):   # JAX's (17, 3)
        TPose.PoseValidator(args=_port_args(), save_dir=tmp_path / "bad",
                            data=data)(model=tm)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert [c[0] for c in jcalls].count("pose") > 0
    pending = None
    for jc, tc in zip(jcalls, tcalls):
        if jc[0] == "box":
            (_, jb, jcl, jtp), (_, tb, tcl, ttp) = jc, tc
            scores = np.zeros(len(jcl))        # pair on box and class
            order, _, _ = assert_paired((jb, jcl, scores),
                                        (tb, tcl, scores[:len(tcl)]), 2e-3, 0.0)
            for i, j in enumerate(order):
                np.testing.assert_array_equal(ttp[i], jtp[j])
            pending = order
        else:
            (_, joks, jtp), (_, toks, ttp) = jc, tc
            for i, j in enumerate(pending):
                np.testing.assert_array_equal(ttp[i], jtp[j])
                np.testing.assert_allclose(toks[:, i], joks[:, j], rtol=0,
                                           atol=1e-5)
    jrows = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    trows = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert len(trows) == len(jrows) > 0
    for stem in {r["image_id"] for r in jrows}:
        jw = [r for r in jrows if r["image_id"] == stem]
        tg = [r for r in trows if r["image_id"] == stem]
        key = lambda rows: (np.asarray([r["bbox"] for r in rows]),
                            np.asarray([r["category_id"] for r in rows]),
                            np.asarray([r["score"] for r in rows]))
        order, _, _ = assert_paired(key(jw), key(tg), 2e-3, 1e-5, str(stem))
        for i, j in enumerate(order):
            np.testing.assert_allclose(tg[i]["keypoints"], jw[j]["keypoints"],
                                       rtol=0, atol=2e-3)


def _frames(seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((70, 120), (96, 96), (130, 77)):
        img = rng.integers(60, 140, (h, w, 3), np.uint8)
        for _ in range(3):
            c = rng.uniform(0.25, 0.75, 2) * (w, h)
            cv2.circle(img, (int(c[0]), int(c[1])), 5, (250, 50, 50), -1)
        out.append(img)
    return out


def assert_keypoints_paired(w, g, what=""):
    """g's detections paired with w's (box 4e-4 px, score 1e-5), each
    pair's keypoints within KPT_PX in x, y and 1e-5 in visibility; the
    number of detections compared."""
    order, _, _ = assert_paired(
        (w.boxes.xyxy, w.boxes.cls, w.boxes.conf),
        (g.boxes.xyxy, g.boxes.cls, g.boxes.conf), 4e-4, 1e-5, what)
    assert g.keypoints.data.shape == w.keypoints.data.shape
    for i, j in enumerate(order):
        gk, wk = g.keypoints.data[i], w.keypoints.data[j]
        np.testing.assert_allclose(gk[:, :2], wk[:, :2], rtol=0, atol=KPT_PX)
        np.testing.assert_allclose(gk[:, 2], wk[:, 2], rtol=0, atol=1e-5)
    return len(order)


@pytest.mark.parametrize("graph", ["tiny", "tiny_l0"])
def test_predictor_keypoints_match_jax(graph):
    jm, v, tm = pose_pair(POSE_TINY if graph == "tiny" else POSE_TINY_L0,
                          seed=4)
    kw = {"imgsz": IMGSZ, "batch": 2, "conf": 0.05, "max_det": 20,
          "max_nms": 256, "save": False}
    frames = _frames()
    want = JPose.PosePredictor(
        args=jax_get_cfg(DEFAULT_CFG_DICT, kw), model=jm, params=v["params"],
        batch_stats=v["batch_stats"], names={0: "p"})(list(frames))
    got = TPose.PosePredictor(args=get_cfg(overrides={**kw, "device": "cpu"}),
                              model=tm, names={0: "p"})(list(frames))
    assert len(got) == len(want) == 3
    n = sum(assert_keypoints_paired(w, g, str(k))
            for k, (w, g) in enumerate(zip(want, got)))
    assert n > 0
    for g in got:
        h, w_ = g.orig_shape
        xy = g.keypoints.xy
        assert (xy >= 0).all() and (xy[..., 0] <= w_).all() \
            and (xy[..., 1] <= h).all()


def test_keypoints_api_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 50, (2, 4, 3)).astype(np.float32)
    data[..., 2] = rng.uniform(0, 1, (2, 4))
    t, j = Keypoints(data, (60, 80)), JaxKeypoints(data, (60, 80))
    assert len(t) == len(j) == 2
    np.testing.assert_array_equal(t.xy, j.xy)
    np.testing.assert_array_equal(t.conf, j.conf)
    assert Keypoints(data[..., :2], (60, 80)).conf is None
    np.testing.assert_array_equal(t[1:].data, data[1:])
    r = Results(np.zeros((60, 80, 3), np.uint8), "a", {0: "p"},
                boxes=np.asarray([[1, 1, 20, 20, 0.9, 0],
                                  [30, 30, 50, 50, 0.8, 0]], np.float32),
                keypoints=data)
    assert r.keys == ["boxes", "keypoints"]
    one = r[1:]
    assert len(one) == 1 and one.keypoints.data.shape == (1, 4, 3)
    # tracks keep detection 1 then 0: the keypoints follow det_idx
    tracks = np.asarray([[30, 30, 50, 50, 7, 0.8, 0, 1],
                         [1, 1, 20, 20, 8, 0.9, 0, 0]], np.float32)
    r.update_tracks(tracks)
    np.testing.assert_array_equal(r.keypoints.data, data[[1, 0]])
    np.testing.assert_array_equal(r.boxes.id, [7, 8])


def test_plot_draws_keypoints_as_jax():
    from dedark_yolo_tpu.engine.results import Results as JaxResults
    img = np.full((60, 80, 3), 40, np.uint8)
    kp = np.asarray([[[10, 12, 0.9], [30, 20, 0.1], [50, 40, 0.6]]],
                    np.float32)
    box = np.asarray([[5, 5, 55, 45, 0.9, 0]], np.float32)
    got = Results(img, "a", {0: "p"}, boxes=box, keypoints=kp).plot()
    want = JaxResults(img, "a", {0: "p"}, boxes=box, keypoints=kp).plot()
    np.testing.assert_array_equal(got, want)


def _tiny_json(tmp_path):
    p = tmp_path / "pose_tiny.json"
    p.write_text(json.dumps(POSE_TINY))
    return p


def test_export_pt2_and_autobackend_match_live(pair, data, tmp_path):
    from dedark_yolo_tpu.engine.exporter import Exporter as JaxExporter
    jm, v, tm = pair
    y = YOLO(str(_tiny_json(tmp_path)), device="cpu")
    y.load_state_dict(tm.state_dict())
    path = y.export(format="pt2", imgsz=IMGSZ, batch=4, device="cpu",
                    project=str(tmp_path / "pt2"))
    jpath = JaxExporter(_jax_args(format="bin", batch=4,
                                  project=str(tmp_path / "jax")))(
        jm, v["params"], v["batch_stats"])
    side = json.loads(Path(path + ".json").read_text())
    assert side == json.loads(Path(jpath + ".json").read_text())
    assert side["task"] == "pose" and [o["name"] for o in side["outputs"]] \
        == ["boxes", "scores", "kpts"]
    be = AutoBackend(path, device="cpu")
    assert be.task == "pose" and be.kpt_shape == (3, 3)
    u8 = np.random.default_rng(6).integers(0, 256, (4, IMGSZ, IMGSZ, 3),
                                           np.uint8)
    outs = be.forward(u8)
    with torch.no_grad():
        live = y.model.eval_outputs(torch.from_numpy(u8).float() / 255.0)
    assert len(outs) == 3
    for o, l_ in zip(outs, live):
        np.testing.assert_allclose(o.numpy(), l_.numpy(), rtol=0, atol=1e-5)
    art = YOLO(path, device="cpu")
    assert art.task == "pose"
    kw = {"data": data, "device": "cpu", "plots": False, "max_nms": 256,
          "max_det": 30, "max_boxes": 8}
    assert art.val(**kw) == y.val(imgsz=IMGSZ, batch=4, **kw)
    frames = _frames(7)
    pa = art.predict(list(frames), device="cpu", conf=0.05)
    pl = y.predict(list(frames), imgsz=IMGSZ, batch=4, device="cpu", conf=0.05)
    for a, b in zip(pa, pl):
        assert_keypoints_paired(b, a)


def test_facade_trains_then_cli_validates(data, tmp_path, capsys):
    """YOLO(pose json).train one epoch (mosaic on): results.csv with the
    pose columns and best.npz; then `pose val model=best.npz` prints
    YOLO(best.npz).val()'s results and `pose predict` counts keypoint
    instances."""
    y = YOLO(str(_tiny_json(tmp_path)), device="cpu")
    res = y.train(data=data, epochs=1, imgsz=64, batch=4, nbs=4, workers=2,
                  device="cpu", project=str(tmp_path / "runs"), name="pose",
                  plots=False, cache="disk", max_nms=256, max_det=30)
    assert set(res) == {"metrics/mAP50(B)", "metrics/mAP50-95(B)",
                        "metrics/mAP50(P)", "metrics/mAP50-95(P)", "fitness"}
    run = tmp_path / "runs" / "pose"
    rows = (run / "results.csv").read_text().splitlines()
    assert rows[0] == ("epoch,train/box_loss,train/pose_loss,train/kobj_loss,"
                       "train/cls_loss,train/dfl_loss,metrics/mAP50(B),"
                       "metrics/mAP50-95(B),metrics/mAP50(P),"
                       "metrics/mAP50-95(P),lr")
    best = run / "weights" / "best.npz"
    assert best.is_file() and y.model.task == "pose"
    data_json = tmp_path / "data.json"
    data_json.write_text(json.dumps(data))
    kw = ["imgsz=64", "max_nms=256", "max_det=30", "plots=False"]
    want = YOLO(str(best), device="cpu").val(
        data=str(data_json), device="cpu", imgsz=64, max_nms=256, max_det=30,
        plots=False)
    assert cli.entrypoint(["pose", "val", f"model={best}",
                           f"data={data_json}", "device=cpu", *kw]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1][len("results "):]) == want
    src = str(Path(data["val"]) / "0.jpg")
    assert cli.entrypoint(["pose", "predict", f"model={best}",
                           f"source={src}", "imgsz=64", "conf=0.001",
                           "max_nms=256", "max_det=30", "device=cpu",
                           "save=False"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1][8:])
    assert got["images"] == 1 and got["keypoints"] == got["detections"]
