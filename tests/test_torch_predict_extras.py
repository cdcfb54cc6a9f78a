"""Torch port vs the JAX package: predict's paths beyond plain inference
(ROADMAP A6b), on the CPU, tests/tiny_model.yaml at imgsz 128 with numpy
weights shared through `state_dict_from_jax`.

- TTA (`augment=True`): `tta_eval`'s candidates and its unscaled pass
  against plain inference (as tests/test_tta.py holds JAX's), then both
  predictors' detections, paired (tests/pairing.py).
- A two-member ensemble, through the predictors and through
  `YOLO([a.npz, b.npz])` on both sides.
- `save_enhanced` (layer 0's output of the same forward) and `visualize`
  (every layer's first-image activations, NHWC, 32 channels), against what
  the JAX predictor captures.
- PIL and tensor sources, a video through `perform.test_video`, the CLI's
  predict saving by default, `test_img` and `test_folders` saving what the
  root script's save.

Tolerances. BOX_TOL_PX and SCORE_TOL are the val gate's (2e-4 px, 1e-6):
the forwards sum their convolutions in other orders, and under TTA the
port resizes with F.interpolate where JAX multiplies by the same bilinear
matrices; `tta_eval` measured 3.8e-5 px and 6.0e-8 here (its print).
ENH_TOL: layer 0's output, the plain chain against JAX's XLA chain, 1e-5
(measured 1.2e-6). CAP_TOL: the captured activations, 1e-5 absolute and
relative (measured 1.9e-6 absolute).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.engine.predictor import (  # noqa: E402
    DetectionPredictor as JaxPredictor)
from dedark_yolo_tpu.utils import plotting as jax_plotting  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_results_paired  # noqa: E402
from test_torch_val import TINY, tiny_variables  # noqa: E402

IMGSZ = 128
BOX_TOL_PX, SCORE_TOL = 2e-4, 1e-6
ENH_TOL, CAP_TOL = 1e-5, 1e-5
OVER = dict(imgsz=IMGSZ, batch=2, conf=0.02, iou=0.7, max_det=40)
NAMES = {0: "car", 1: "bus", 2: "train"}


def port_model(v):
    tm = DetectionModel(model_yaml_load(TINY), nc=3).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return tm


@pytest.fixture(scope="module")
def tiny():
    """Two members' weights: (JAX model, [flax trees], [port modules])."""
    jm, v0 = tiny_variables(seed=0)
    _, v1 = tiny_variables(seed=1)
    return jm, [v0, v1], [port_model(v0), port_model(v1)]


@pytest.fixture(scope="module")
def frames():
    """Three low-light BGR frames of other sizes than the letterbox's."""
    rng = np.random.default_rng(5)
    return [(rng.uniform(0, 1, s) ** 2 * 255).astype(np.uint8)
            for s in ((100, 120, 3), (128, 96, 3), (90, 128, 3))]


def predict_both(tmp_path, tiny, frames, members=1, **over):
    jm, vs, tms = tiny
    kw = {**OVER, **over}
    jp = JaxPredictor(
        args=jax_get_cfg(DEFAULT_CFG_DICT, {"save": False, **kw}), model=jm,
        params=vs[0]["params"], batch_stats=vs[0]["batch_stats"],
        names=NAMES, save_dir=str(tmp_path / "jax"),
        members=[(v["params"], v["batch_stats"]) for v in vs[:members]])
    tp = DetectionPredictor(
        args=get_cfg(overrides={**kw, "device": "cpu"}), model=tms[0], names=NAMES,
        save_dir=tmp_path / "torch",
        members=[tm.state_dict() for tm in tms[1:members]])
    return jp(frames), tp(frames)


def test_tta_eval_candidates_and_unscaled_pass(tiny):
    """tta_eval's candidate count is JAX's (701 at 128: tests/test_tta.py),
    its values JAX's within the bars, and its unscaled pass (anchors before
    the clipped P5 tail) is plain inference bit for bit."""
    jm, vs, tms = tiny
    img = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(
        np.float32)
    want_b, want_s = jax.jit(jm.tta_eval)(vs[0], jnp.asarray(img))
    with torch.no_grad():
        x = torch.from_numpy(img)
        got_b, got_s = tms[0].tta_eval(x)
        plain_b, plain_s = tms[0].decode(tms[0](x))
    assert tuple(got_b.shape) == want_b.shape == (2, 701, 4)
    assert tuple(got_s.shape) == want_s.shape == (2, 701, 3)
    db = np.abs(got_b.numpy() - np.asarray(want_b)).max()
    ds = np.abs(got_s.numpy() - np.asarray(want_s)).max()
    print(f"tta_eval: box {db:.3g} px, score {ds:.3g}")
    assert db <= BOX_TOL_PX and ds <= SCORE_TOL
    keep = 336 - 16
    np.testing.assert_array_equal(got_b[:, :keep].numpy(),
                                  plain_b[:, :keep].numpy())
    np.testing.assert_array_equal(got_s[:, :keep].numpy(),
                                  plain_s[:, :keep].numpy())


@pytest.mark.parametrize("members,augment", [(1, True), (2, False), (2, True)],
                         ids=["tta", "ensemble", "ensemble_tta"])
def test_predict_detections_match_jax(tmp_path, tiny, frames, members,
                                      augment):
    want, got = predict_both(tmp_path, tiny, frames, members=members,
                             augment=augment)
    assert sum(len(r) for r in got) > 0
    assert_results_paired(want, got, BOX_TOL_PX, SCORE_TOL)


def test_save_enhanced_and_visualize_match_jax(tmp_path, tiny, frames,
                                               monkeypatch):
    """Layer 0's output (clipped to [0, 1]) of every image, and every
    layer's capture of each batch's first image, against JAX's; the
    detections of the same forward paired."""
    seen = []
    monkeypatch.setattr(jax_plotting, "feature_visualization",
                        lambda caps, save_dir: seen.append(caps))
    want, got = predict_both(tmp_path, tiny, frames, save_enhanced=True,
                             visualize=True)
    assert_results_paired(want, got, BOX_TOL_PX, SCORE_TOL)
    err = 0.0
    for w, g in zip(want, got):
        assert g.enhanced_img.shape == w.enhanced_img.shape == (IMGSZ, IMGSZ, 3)
        assert g.enhanced_img.dtype == np.float32
        err = max(err, float(np.abs(g.enhanced_img - w.enhanced_img).max()))
    print(f"enhanced: {err:.3g}")
    assert err <= ENH_TOL
    firsts = [r.features for r in got[::2]]
    assert [r.features for r in got[1::2]] == [None]
    assert len(seen) == len(firsts) == 2
    err = 0.0
    for w, g in zip(seen, firsts):
        assert sorted(g) == sorted(w) == list(range(14))
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=CAP_TOL, atol=CAP_TOL,
                                       err_msg=str(k))
            err = max(err, float(np.abs(g[k] - w[k]).max()))
    print(f"captures: {err:.3g}")


def test_augment_skips_captures_with_jaxs_warning(tiny, frames, caplog):
    _, _, tms = tiny
    with caplog.at_level("WARNING", logger="dedark_yolo_tpu_torch"):
        got = DetectionPredictor(
            args=get_cfg(overrides={**OVER, "device": "cpu", "augment": True,
                          "save_enhanced": True, "visualize": True}),
            model=tms[0], names=NAMES)(frames[:1])
    assert "augment=True skips save_enhanced/visualize" in caplog.text
    assert got[0].enhanced_img is None and got[0].features is None


def test_pil_and_tensor_sources(tiny, frames):
    """A PIL image and CHW/BCHW tensors (uint8, float in [0, 1] and float
    in 0-255) load as JAX's loaders load them, bit for bit; a PIL image and
    a uint8 tensor give the detections of the same BGR array."""
    from PIL import Image
    from dedark_yolo_tpu.engine.predictor import load_source as jax_load
    from dedark_yolo_tpu_torch.engine.predictor import load_source
    _, _, tms = tiny
    tp = DetectionPredictor(args=get_cfg(overrides={**OVER, "device": "cpu"}),
                            model=tms[0], names=NAMES)
    bgr = frames[0]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    want = tp(bgr)[0].boxes.data
    assert len(want) > 0
    chw = torch.from_numpy(rgb).permute(2, 0, 1)
    pil = Image.fromarray(rgb).convert("RGBA")
    for source in (pil, chw, chw[None], (chw.float() / 255)[None],
                   chw.float()[None]):
        (path, img, meta), = list(load_source(source))
        (jpath, jimg, _), = list(jax_load(
            jnp.asarray(source.numpy()) if torch.is_tensor(source) else source))
        assert (path, meta) == (jpath, None)
        np.testing.assert_array_equal(img, jimg)
    for source, path in ((pil, "pil"), (chw, "tensor0")):
        r = tp(source)
        assert len(r) == 1 and r[0].path == path
        np.testing.assert_array_equal(r[0].boxes.data, want)


def write_video(path, frames, fps=10):
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    for f in frames:
        out.write(f)
    out.release()
    return path


def read_video(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, tiny):
    """The two members as JAX checkpoints. They carry no names: JAX keeps
    a checkpoint's names with the string keys JSON gave them, so its labels
    fall back to class ids, where the port maps the keys back to ints."""
    root = tmp_path_factory.mktemp("extras")
    jm, vs, _ = tiny
    return [save_checkpoint(
        root / f"m{i}.npz", params=v["params"], batch_stats=v["batch_stats"],
        train_args={"imgsz": IMGSZ}, model_yaml=jm.yaml)
        for i, v in enumerate(vs)]


def test_ensemble_facade_matches_jax(checkpoints, frames):
    want = JaxYOLO([str(p) for p in checkpoints]).predict(
        frames, save=False, **OVER)
    m = YOLO([str(p) for p in checkpoints], device="cpu")
    assert len(m.members) == 1
    got = m.predict(frames, device="cpu", **OVER)
    assert sum(len(r) for r in got) > 0
    assert_results_paired(want, got, BOX_TOL_PX, SCORE_TOL)


def test_video_source_and_vid_stride(tmp_path, tiny, frames):
    """A video's frames as sources (every second with vid_stride=2), their
    meta, and the annotated mp4 that `save` muxes, frame for frame JAX's."""
    video = write_video(tmp_path / "clip.mp4", [frames[0]] * 5)
    want, got = predict_both(tmp_path, tiny, str(video), save=True,
                             vid_stride=2)
    assert [r.source_meta[0] for r in got] == [0, 2, 4]
    assert [r.source_meta[0] for r in want] == [0, 2, 4]
    assert_results_paired(want, got, BOX_TOL_PX, SCORE_TOL)
    jf = read_video(tmp_path / "jax" / "clip_pred.mp4")
    tf = read_video(tmp_path / "torch" / "clip_pred.mp4")
    assert len(tf) == len(jf) == 3
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)


def test_perform_video_img_and_folders_save_like_root(checkpoints, frames,
                                                      tmp_path, monkeypatch):
    """test_video writes as many frames as the root script's, of the same
    size; test_img and test_folders the same file names, txt files of as
    many lines, and the same stats but for the seconds. (The root script's
    test_video also saves each frame under runs/detect/ of the working
    directory.)"""
    import perform as root_perform
    from dedark_yolo_tpu_torch import perform
    monkeypatch.chdir(tmp_path)
    ckpt = str(checkpoints[0])
    video = write_video(tmp_path / "v.mp4", frames[:1] * 4)
    outs = {}
    for side, mod, kw in (("jax", root_perform, {}),
                          ("torch", perform, {"device": "cpu"})):
        out = mod.test_video(ckpt, str(video), imgsz=IMGSZ, conf=0.02,
                             output=str(tmp_path / f"{side}.avi"), **kw)
        outs[side] = read_video(out)
    assert len(outs["torch"]) == len(outs["jax"]) == 4
    assert outs["torch"][0].shape == outs["jax"][0].shape

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(img_dir / f"{i}.png"), f)
    stats = {}
    for side, mod, kw in (("jax", root_perform, {}),
                          ("torch", perform, {"device": "cpu"})):
        r = mod.test_img(ckpt, str(img_dir / "0.png"), imgsz=IMGSZ,
                         conf=0.02, save_dir=str(tmp_path / side / "img"),
                         **kw)
        assert len(r) == 1
        stats[side] = mod.test_folders(
            ckpt, str(img_dir), imgsz=IMGSZ, conf=0.02, batch=2,
            save_dir=str(tmp_path / side / "folders"), **kw)
    for s in stats.values():
        s.pop("seconds"), s.pop("fps")
    assert stats["torch"] == stats["jax"] and stats["jax"]["images"] == 3
    for sub in ("img/predict", "folders/predict"):
        jdir, tdir = tmp_path / "jax" / sub, tmp_path / "torch" / sub
        names = sorted(p.relative_to(jdir).as_posix()
                       for p in jdir.rglob("*") if p.is_file())
        assert names == sorted(p.relative_to(tdir).as_posix()
                               for p in tdir.rglob("*") if p.is_file())
        assert "0.jpg" in names
    labels = tmp_path / "torch" / "folders" / "predict" / "labels"
    assert len(list(labels.glob("*.txt"))) == 3
    for f in labels.glob("*.txt"):
        want = tmp_path / "jax" / "folders" / "predict" / "labels" / f.name
        assert len(f.read_text().splitlines()) == \
            len(want.read_text().splitlines()) > 0


def test_cli_predict_saves_by_default(checkpoints, frames, tmp_path,
                                      monkeypatch, capsys):
    """`python -m dedark_yolo_tpu_torch predict` saves the annotated images
    under runs/detect/predict of the working directory, as the JAX CLI
    does; save=False saves nothing."""
    from dedark_yolo_tpu_torch import __main__ as cli
    from dedark_yolo_tpu import __main__ as jax_cli
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(img_dir / f"{i}.png"), f)
    args = [f"model={checkpoints[0]}", f"source={img_dir}", f"imgsz={IMGSZ}",
            "conf=0.02"]
    for side, entry, extra in (("jax", jax_cli, []),
                               ("torch", cli, ["device=cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert entry.entrypoint(["predict", *args, *extra]) == 0
    want = sorted(p.name for p in (tmp_path / "jax" / "runs" / "detect"
                                   / "predict").iterdir())
    got = sorted(p.name for p in (tmp_path / "torch" / "runs" / "detect"
                                  / "predict").iterdir())
    assert got == want == ["0.jpg", "1.jpg", "2.jpg"]
    monkeypatch.chdir(tmp_path / "torch")
    assert cli.entrypoint(["predict", *args, "device=cpu", "save=False"]) == 0
    assert not (tmp_path / "torch" / "runs" / "detect" / "predict2").exists()
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])[
        "images"] == 3


def test_saving_needs_its_packages_and_memory_does_not(tmp_path, tiny, frames,
                                                       monkeypatch):
    """With save, the enhanced image and the feature grids are written
    beside the annotated image; without OpenCV (or matplotlib) those
    saves raise an ImportError naming it, while the same predict without
    save still returns the enhanced images and the activations."""
    import sys
    _, _, tms = tiny
    kw = {**OVER, "device": "cpu", "save_enhanced": True, "visualize": True}

    def run(save, out):
        return DetectionPredictor(args=get_cfg(overrides={**kw, "save": save}),
                                  model=tms[0], names=NAMES,
                                  save_dir=tmp_path / out)(frames[:2])
    run(True, "s")
    files = sorted(p.relative_to(tmp_path / "s").as_posix()
                   for p in (tmp_path / "s").rglob("*") if p.is_file())
    assert files == sorted([f"features/array/stage{i}_features.png"
                            for i in range(14)]
                           + ["image.jpg", "image_enhanced.jpg"])
    for module, name in (("matplotlib", "matplotlib"), ("cv2", "OpenCV")):
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, module, None)
            with pytest.raises(ImportError, match=name):
                run(True, module)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    r = run(False, "memory")
    assert r[0].enhanced_img.shape == (IMGSZ, IMGSZ, 3)
    assert sorted(r[0].features) == list(range(14))
    assert not (tmp_path / "memory").exists()
