"""Torch port vs the JAX package: the segment task's validator, predictor,
Masks, export and CLI (CPU, f32), on JAX's `SEG_TINY` with numpy-seeded
weights (the layer-0 variant for predict too) and the seeded polygon
dataset of tests/test_torch_segment_data.py. Bars, each with its reason:
  - the validator's box and mask mAP50 / mAP50-95 and fitness: 1e-9; per
    image, detections paired on native box (2e-3 px: 4e-4 px in the
    letterbox, scaled to the original image) and class, their box and
    mask TP rows equal and their mask IoU with each instance within 0.02
    (a proto pixel whose logit sits within the f32 rounding of 0 flips;
    the IoU itself is float64 of integer pixel counts on both sides); its
    save_json rows paired with JAX's, box within 2e-3 px, score 1e-5, RLE
    counts equal;
  - the predictor: detections paired (tests/pairing.py, box 4e-4 px, score
    1e-5), each paired mask at the original size differing in at most
    MASK_PIXELS pixels (a proto pixel whose logit sits within the f32
    rounding of 0 flips, and the nearest upsample repeats it), plain and
    with retina_masks; `Masks.xy` equal to JAX's (cv2's) wherever the two
    masks are equal; JAX's side letterboxes through its native library,
    as the port does, also after a failed first load
    (tests/jax_native.py);
  - a `.pt2` artifact: its four outputs within 1e-5 of the live
    eval_outputs, its sidecar equal to the one JAX's exporter writes, and
    YOLO(pt2).val() and .predict() equal to the live model's;
  - the CLI: `segment val` prints YOLO(npz).val()'s results.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine import segment as JSeg  # noqa: E402
from dedark_yolo_tpu.engine.results_extra import Masks as JaxMasks  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg  # noqa: E402
from dedark_yolo_tpu_torch.engine import segment as TSeg  # noqa: E402
from dedark_yolo_tpu_torch.engine.autobackend import AutoBackend  # noqa: E402
from dedark_yolo_tpu_torch.engine.results import Masks  # noqa: E402

from jax_native import ensure_jax_native, jax_native  # noqa: E402
from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired  # noqa: E402
from test_segment_task import SEG_TINY  # noqa: E402
from test_torch_segment_data import make_seg_dataset  # noqa: E402
from test_torch_segment_model import SEG_TINY_L0, seg_pair  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

IMGSZ = 96
MASK_PIXELS = 64
VAL_KW = {"imgsz": IMGSZ, "batch": 4, "conf": 0.001, "max_nms": 256,
          "max_det": 30, "max_boxes": 8, "plots": False}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_seg_dataset(tmp_path_factory.mktemp("segtask"), n_train=8,
                            n_val=6, seed=3)


@pytest.fixture(scope="module")
def pair():
    return seg_pair(SEG_TINY, seed=4)


def _jax_args(**kw):
    return jax_get_cfg(DEFAULT_CFG_DICT, {**VAL_KW, **kw})


def _port_args(**kw):
    return get_cfg(overrides={**VAL_KW, "device": "cpu", **kw})


def _recorder(monkeypatch, mod):
    """Wrap `mod`'s match_predictions and match_from_iou: each call's
    inputs and TP matrix, in call order (the box branch, then the mask
    branch, image by image)."""
    calls = []
    mp, mi = mod.match_predictions, mod.match_from_iou

    def box(pb, pc, gb, gc, *a, **k):
        out = mp(pb, pc, gb, gc, *a, **k)
        calls.append(("box", np.asarray(pb, np.float64), np.asarray(pc), out))
        return out

    def mask(iou, *a, **k):
        out = mi(iou, *a, **k)
        calls.append(("mask", np.asarray(iou), out))
        return out

    monkeypatch.setattr(mod, "match_predictions", box)
    monkeypatch.setattr(mod, "match_from_iou", mask)
    return calls


def test_validator_matches_jax(pair, data, tmp_path, monkeypatch):
    """Box and mask mAP over 6 images at batch 4 (the last padded), the
    per-image box TP matrices and mask IoU matrices of paired detections,
    and the save_json rows."""
    jm, v, tm = pair
    jcalls, tcalls = _recorder(monkeypatch, JSeg), _recorder(monkeypatch, TSeg)
    want = JSeg.SegmentationValidator(
        args=_jax_args(save_json=True), save_dir=tmp_path / "jax",
        data=data)(model=jm, params=v["params"], batch_stats=v["batch_stats"])
    val = TSeg.SegmentationValidator(args=_port_args(save_json=True),
                                     save_dir=tmp_path / "port", data=data)
    got = val(model=tm)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-9, k
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == ["box", "mask"] * 6
    ious = []
    for (_, jb, jc, jtp), (_, tb, tc, ttp), (_, jiou, jmtp), (_, tiou, tmtp) \
            in zip(jcalls[0::2], tcalls[0::2], jcalls[1::2], tcalls[1::2]):
        scores = np.zeros(len(jc))        # pair on box and class
        order, _, _ = assert_paired((jb, jc, scores), (tb, tc, scores[:len(tc)]),
                                    2e-3, 0.0)
        for i, j in enumerate(order):
            np.testing.assert_array_equal(ttp[i], jtp[j])
            np.testing.assert_array_equal(tmtp[i], jmtp[j])
            if jiou.size:
                np.testing.assert_allclose(tiou[:, i], jiou[:, j], rtol=0,
                                           atol=0.02)
        ious.append(jiou.ravel())
    assert np.concatenate(ious).max() > 0.05      # masks do meet the GT
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
            assert tg[i]["segmentation"] == jw[j]["segmentation"]


def _frames(seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((70, 120), (96, 96), (130, 77)):
        img = rng.integers(60, 140, (h, w, 3), np.uint8)
        for _ in range(2):
            c = rng.uniform(0.25, 0.75, 2) * (w, h)
            cv2.circle(img, (int(c[0]), int(c[1])), int(min(h, w) * 0.2),
                       (220, 60, 60), -1)
        out.append(img)
    return out


@pytest.mark.parametrize("retina", [False, True])
@pytest.mark.parametrize("graph", ["tiny", "tiny_l0"])
def test_predictor_masks_match_jax(graph, retina):
    _check_predictor_masks(graph, retina)


@pytest.mark.parametrize("retina", [False, True])
def test_predictor_masks_match_jax_after_failed_native_load(retina,
                                                            monkeypatch):
    """JAX's native library as an xdist worker leaves it when its first
    load met another worker's half-written build: the failure cached, so
    JAX's predictor would letterbox through OpenCV (the layer-0 graph's
    scores then move by ~1e-5, past the bar). The comparison loads the
    library again first."""
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    _check_predictor_masks("tiny_l0", retina)


def _check_predictor_masks(graph, retina):
    ensure_jax_native()
    jm, v, tm = seg_pair(SEG_TINY if graph == "tiny" else SEG_TINY_L0,
                         seed=4)
    kw = {"imgsz": IMGSZ, "batch": 2, "conf": 0.05, "max_det": 20,
          "max_nms": 256, "retina_masks": retina, "save": False}
    frames = _frames()
    want = JSeg.SegmentationPredictor(
        args=jax_get_cfg(DEFAULT_CFG_DICT, kw), model=jm, params=v["params"],
        batch_stats=v["batch_stats"], names={0: "a", 1: "b"})(list(frames))
    got = TSeg.SegmentationPredictor(
        args=get_cfg(overrides={**kw, "device": "cpu"}), model=tm,
        names={0: "a", 1: "b"})(list(frames))
    assert len(got) == len(want) == 3
    n_masks = 0
    for k, (w, g) in enumerate(zip(want, got)):
        assert g.masks.data.shape == w.masks.data.shape
        assert g.masks.data.shape[1:] == g.orig_shape
        order, _, _ = assert_paired(
            (w.boxes.xyxy, w.boxes.cls, w.boxes.conf),
            (g.boxes.xyxy, g.boxes.cls, g.boxes.conf), 4e-4, 1e-5, str(k))
        for i, j in enumerate(order):
            gm, wm = g.masks.data[i], w.masks.data[j]
            assert (gm != wm).sum() <= MASK_PIXELS, (k, i)
            n_masks += int(gm.any())
            if np.array_equal(gm, wm):
                got_xy = Masks(gm[None], g.orig_shape).xy[0]
                want_xy = JaxMasks(wm[None], w.orig_shape).xy[0]
                np.testing.assert_array_equal(got_xy, want_xy)
    assert n_masks > 0


def test_results_masks_api():
    m = np.zeros((2, 40, 60), bool)
    m[0, 5:20, 10:30] = True
    from dedark_yolo_tpu_torch.engine.results import Results
    r = Results(np.zeros((40, 60, 3), np.uint8), "a", {0: "x"},
                boxes=np.asarray([[10, 5, 30, 20, 0.9, 0], [0, 0, 1, 1, 0.5, 0]],
                                 np.float32), masks=m)
    assert r.keys == ["boxes", "masks"] and len(r.masks) == 2
    xy, xyn = r.masks.xy, r.masks.xyn
    assert xy[0].shape[1] == 2 and xy[1].shape == (0, 2)
    np.testing.assert_allclose(xyn[0], xy[0] / np.asarray([60, 40]))
    one = r[:1]
    assert len(one) == 1 and one.masks.data.shape == (1, 40, 60)
    r.update(masks=m[:1])
    assert len(r.masks) == 1


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
    assert side["task"] == "segment" and [o["name"] for o in side["outputs"]] \
        == ["boxes", "scores", "coefs", "protos"]
    be = AutoBackend(path, device="cpu")
    u8 = np.random.default_rng(6).integers(0, 256, (4, IMGSZ, IMGSZ, 3),
                                           np.uint8)
    outs = be.forward(u8)
    with torch.no_grad():
        live = y.model.eval_outputs(torch.from_numpy(u8).float() / 255.0)
    assert len(outs) == 4
    for o, l_ in zip(outs, live):
        np.testing.assert_allclose(o.numpy(), l_.numpy(), rtol=0, atol=1e-5)
    art = YOLO(path, device="cpu")
    assert art.task == "segment"
    kw = {"data": data, "device": "cpu", "plots": False, "max_nms": 256,
          "max_det": 30, "max_boxes": 8}
    assert art.val(**kw) == y.val(imgsz=IMGSZ, batch=4, **kw)
    frames = _frames(7)
    pa = art.predict(list(frames), device="cpu", conf=0.05)
    pl = y.predict(list(frames), imgsz=IMGSZ, batch=4, device="cpu", conf=0.05)
    for a, b in zip(pa, pl):
        assert_paired((b.boxes.xyxy, b.boxes.cls, b.boxes.conf),
                      (a.boxes.xyxy, a.boxes.cls, a.boxes.conf), 1e-3, 1e-5)
        assert a.masks.data.shape == b.masks.data.shape


def _tiny_json(tmp_path):
    p = tmp_path / "seg_tiny.json"
    p.write_text(json.dumps(SEG_TINY))
    return p


def test_facade_trains_then_cli_validates(data, tmp_path, capsys):
    """YOLO(seg json).train one epoch (nc from the data; mosaic and
    copy-paste): results.csv with the segment columns and best.npz; then
    `segment val model=best.npz` prints YOLO(best.npz).val()'s results and
    `segment predict` counts masks."""
    y = YOLO(str(_tiny_json(tmp_path)), device="cpu")
    res = y.train(data=data, epochs=1, imgsz=64, batch=4, nbs=4, workers=2,
                  device="cpu", project=str(tmp_path / "runs"), name="seg",
                  plots=False, cache="disk", copy_paste=0.5, max_nms=256,
                  max_det=30)
    assert set(res) == {"metrics/mAP50(B)", "metrics/mAP50-95(B)",
                        "metrics/mAP50(M)", "metrics/mAP50-95(M)", "fitness"}
    run = tmp_path / "runs" / "seg"
    rows = (run / "results.csv").read_text().splitlines()
    assert rows[0] == ("epoch,train/box_loss,train/seg_loss,train/cls_loss,"
                       "train/dfl_loss,metrics/mAP50(B),metrics/mAP50-95(B),"
                       "metrics/mAP50(M),metrics/mAP50-95(M),lr")
    best = run / "weights" / "best.npz"
    assert best.is_file() and y.model.task == "segment" and y.model.nc == 2
    data_json = tmp_path / "data.json"
    data_json.write_text(json.dumps(data))
    kw = ["imgsz=64", "max_nms=256", "max_det=30", "plots=False"]
    want = YOLO(str(best), device="cpu").val(
        data=str(data_json), device="cpu", imgsz=64, max_nms=256, max_det=30,
        plots=False)
    assert cli.entrypoint(["segment", "val", f"model={best}",
                           f"data={data_json}", "device=cpu", *kw]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1][len("results "):]) == want
    src = str(Path(data["val"]) / "0.jpg")
    assert cli.entrypoint(["segment", "predict", f"model={best}",
                           f"source={src}", "imgsz=64", "conf=0.001",
                           "max_nms=256", "max_det=30", "device=cpu",
                           "save=False"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1][8:])
    assert got["images"] == 1 and got["masks"] == got["detections"]
