"""Torch port vs the JAX package: the native host library and predict's
letterbox (ROADMAP C12, A6c).

The port's `native` is its own copy of the JAX package's C++ library, built
apart from it. Its `letterbox_batch` and `decode_*` must give the JAX
library's bytes; JAX's own `tests/test_native.py` cases run again against
the port's copy. The gate of C12: the port's predict equals the JAX
predictor (which letterboxes natively whenever its library builds) on
frames that need a non-integer resize, among them 145x256 at 128, where
the native geometry (lround of 72.5 rows) and Python's round part ways.
Detections: equal counts and classes, boxes within 4e-4 px, scores within
1e-6 (tests/test_torch_model.py's bars). Last, predict runs in a process
where any import of cv2 fails.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu import native as jax_native  # noqa: E402
from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.data.augment import letterbox as cv2_letterbox  # noqa: E402
from dedark_yolo_tpu.engine.predictor import (  # noqa: E402
    DetectionPredictor as JaxPredictor)

from dedark_yolo_tpu_torch import native  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_results_paired  # noqa: E402
from test_torch_val import TINY, tiny_variables  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 128
BOX_TOL, SCORE_TOL = 4e-4, 1e-6
# (h, w): the lround case (72.5 rows at 128), two non-integer scales, an
# odd one, one that only pads, and the identity size
FRAMES = [(145, 256), (100, 150), (97, 131), (300, 500), (96, 128), (128, 128)]


def frames(seed=0, shapes=FRAMES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in shapes]


@pytest.mark.parametrize("swap_rb", [True, False])
def test_letterbox_batch_bit_equal_to_jax(swap_rb):
    imgs = frames()
    got = native.letterbox_batch(imgs, IMGSZ, fill=114, swap_rb=swap_rb)
    want = jax_native.letterbox_batch(imgs, IMGSZ, fill=114, swap_rb=swap_rb)
    np.testing.assert_array_equal(got, want)
    # the lround geometry: 72.5 rows round to 73, placed from row 27
    rows = np.flatnonzero((got[0] != 114).any(axis=(1, 2)))
    assert (rows[0], rows[-1] - rows[0] + 1) == (27, 73)


def test_letterbox_matches_cv2():
    """JAX test_native_letterbox_matches_cv2 on the port's copy."""
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
              for h, w in [(120, 200), (200, 120), (160, 160), (97, 131)]]
    size = 160
    out = native.letterbox_batch(images, size, fill=114, swap_rb=True)
    assert out.shape == (4, size, size, 3)
    for i, img in enumerate(images):
        want = cv2_letterbox(img, size)[0][..., ::-1]
        got = out[i]
        pad = (want == 114).all(-1)
        np.testing.assert_array_equal(got[pad], want[pad])
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.mean() < 1.0
        assert (diff <= 3).mean() > 0.995, f"image {i}: {(diff > 3).mean():.4f} off"


def test_letterbox_identity_size():
    img = np.arange(160 * 160 * 3, dtype=np.uint8).reshape(160, 160, 3)
    out = native.letterbox_batch([img], 160, swap_rb=False)
    np.testing.assert_array_equal(out[0], img)


def test_threads_deterministic():
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (100 + i, 150 - i, 3), dtype=np.uint8)
              for i in range(16)]
    a = native.letterbox_batch(images, 128, n_threads=1)
    b = native.letterbox_batch(images, 128, n_threads=8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, jax_native.letterbox_batch(images, 128, n_threads=3))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Three JPEGs: smooth content 300x220, a two-colour 200x100 (B
    distinct from R) and a 721x1280 frame; then a file that is no JPEG."""
    root = tmp_path_factory.mktemp("jpeg")
    rng = np.random.default_rng(2)
    smooth = cv2.GaussianBlur(
        rng.integers(0, 255, (300, 220, 3), dtype=np.uint8), (31, 31), 8)
    flat = np.full((200, 100, 3), 200, np.uint8)
    flat[:, :, 0] = 50
    big = cv2.GaussianBlur(
        rng.integers(0, 255, (721, 1280, 3), dtype=np.uint8), (9, 9), 3)
    paths = []
    for name, img, q in (("a", smooth, 95), ("b", flat, 98), ("c", big, 90)):
        p = root / f"{name}.jpg"
        cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, q])
        paths.append(str(p))
    bad = root / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    return paths, str(bad)


def test_decode_maxside_matches_cv2(jpegs):
    """JAX test_native_decode_maxside_matches_cv2 on the port's copy."""
    p = jpegs[0][0]
    imgs, shapes = native.decode_maxside_batch([p], 160)
    lh, lw, h0, w0 = shapes[0]
    assert (h0, w0) == (300, 220)
    assert (lh, lw) == (160, 117)
    ref = cv2.imread(p)
    r = 160 / max(ref.shape[:2])
    ref_r = cv2.resize(ref, (int(220 * r), int(300 * r)))
    diff = np.abs(imgs[0, :lh, :lw].astype(int) - ref_r.astype(int))
    assert diff.mean() < 3.0


def test_decode_letterbox_and_bad_file(jpegs):
    """JAX test_native_decode_letterbox on the port's copy."""
    paths, bad = jpegs
    out, osh = native.decode_letterbox_batch([paths[1]], 128, fill=114)
    assert out.shape == (1, 128, 128, 3)
    np.testing.assert_array_equal(osh[0], [200, 100])
    assert out[0, 64, 64, 0] > 150 and out[0, 64, 64, 2] < 100
    assert (out[0, 64, 2] == 114).all()
    out2, osh2 = native.decode_letterbox_batch([bad], 64)
    assert (osh2[0] == 0).all()


@pytest.mark.parametrize("size", [128, 160, 640])
def test_decode_bit_equal_to_jax(jpegs, size):
    paths, bad = jpegs
    every = paths + [bad]
    for bgr in (True, False):
        got = native.decode_maxside_batch(every, size, bgr=bgr)
        want = jax_native.decode_maxside_batch(every, size, bgr=bgr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = native.decode_letterbox_batch(every, size, fill=114)
    want = jax_native.decode_letterbox_batch(every, size, fill=114)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_decode_names_jpeglib_where_missing(tmp_path, monkeypatch):
    """A host without libjpeg's header: the decode library's build raises
    naming jpeglib.h; the letterbox still builds."""
    src = tmp_path / "src"
    src.mkdir()
    for f in ("letterbox.cc", "resize.h"):
        (src / f).write_bytes((native.SRC / f).read_bytes())
    text = (native.SRC / "decode.cc").read_text()
    (src / "decode.cc").write_text(
        text.replace("<jpeglib.h>", '"absent/jpeglib.h"'))
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.decode_maxside_batch([str(tmp_path / "x.jpg")], 64)
    assert native.letterbox_batch(frames(), 64).shape == (6, 64, 64, 3)


@pytest.fixture(scope="module")
def tiny():
    jm, v = tiny_variables(seed=0)
    tm = DetectionModel(model_yaml_load(TINY), nc=3).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("batch", [2, 4])
def test_predict_matches_jax_on_resized_frames(tiny, tmp_path, batch):
    """The gate of C12: both predictors on frames that need a resize; a
    batch of 2 leaves no partial batch, 4 leaves one of 2, which both fill
    with the first frame."""
    jm, v, tm = tiny
    imgs = frames(seed=3)
    over = dict(imgsz=IMGSZ, batch=batch, conf=0.05, iou=0.7, max_det=100)
    jp = JaxPredictor(args=jax_get_cfg(DEFAULT_CFG_DICT, dict(over, save=False)),
                      model=jm, params=v["params"],
                      batch_stats=v["batch_stats"], names=jm.names,
                      save_dir=str(tmp_path))
    tp = DetectionPredictor(args=get_cfg(overrides=dict(over, device="cpu")), model=tm)
    want, got = jp(imgs), tp(imgs)
    assert len(got) == len(want) == len(imgs)
    assert all(len(r) > 0 for r in got)
    assert_results_paired(want, got, BOX_TOL, SCORE_TOL)
    assert tp.speed["preprocess"] > 0


def test_predict_without_cv2(tmp_path):
    """Predict of arrays and .npy files that need a resize, in a process
    where `import cv2` fails."""
    imgs = frames(seed=4, shapes=[(145, 256), (300, 500)])
    for i, im in enumerate(imgs):
        np.save(tmp_path / f"f{i}.npy", im)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        from dedark_yolo_tpu_torch import YOLO
        m = YOLO({TINY!r}, device="cpu", seed=0)
        d = {str(tmp_path)!r}
        arrays = [np.load(d + f"/f{{i}}.npy") for i in range(2)]
        for src in (arrays, d, [d + "/f0.npy", d + "/f1.npy"]):
            r = m.predict(src, device="cpu", imgsz=64, batch=2, conf=0.001)
            assert [x.orig_shape for x in r] == [(145, 256), (300, 500)]
        print("OK")
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "OK" in p.stdout, p.stdout + p.stderr
