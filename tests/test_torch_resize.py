"""Torch port vs OpenCV and the JAX package: the resize without OpenCV
(ROADMAP C12).

`imgops.resize_linear` must be bit-equal to cv2.resize INTER_LINEAR on
uint8 (OpenCV 5.0 on the x86 build these tests run): non-integer
downscales, the exact 2x downscale (which OpenCV sends to INTER_AREA),
upscales, one-pixel and odd sizes, one to four channels. The port's
dataset max-side load and its letterbox must give the JAX package's bytes
(JAX resizes with cv2 there), the letterbox in a process where `import
cv2` fails.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data.augment import letterbox as jax_letterbox  # noqa: E402
from dedark_yolo_tpu.data.dataset import YOLODataset as JaxDataset  # noqa: E402

from dedark_yolo_tpu_torch.data.dataset import YOLODataset  # noqa: E402
from dedark_yolo_tpu_torch.data.imgops import resize_linear  # noqa: E402

from synth import make_synth_dataset  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# (source h, w) -> (dest h, w)
SHAPES = {
    "down": [((300, 500), (384, 640)), ((1000, 1500), (427, 640)),
             ((721, 1280), (360, 640)), ((145, 256), (72, 128)),
             ((97, 131), (95, 128))],
    "down_2x": [((720, 1280), (360, 640)), ((10, 14), (5, 7)),
                ((2, 2), (1, 1)), ((1080, 1920), (540, 960))],
    "up": [((480, 640), (640, 853)), ((37, 53), (101, 77)),
           ((64, 64), (128, 128)), ((3, 5), (17, 29))],
    "odd": [((1, 1), (5, 7)), ((5, 3), (1, 1)), ((1, 97), (33, 1)),
            ((99, 1), (1, 50)), ((7, 9), (7, 9)), ((13, 200), (200, 13))],
}


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_resize_linear_bit_equal_to_cv2(kind, channels):
    rng = np.random.default_rng(len(kind) * 10 + (channels or 0))
    for (sh, sw), (h, w) in SHAPES[kind]:
        shape = (sh, sw) if channels is None else (sh, sw, channels)
        img = rng.integers(0, 256, shape, np.uint8)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, (w, h))
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{shape}->{h}x{w}")


def test_resize_linear_random_shapes():
    rng = np.random.default_rng(7)
    for _ in range(60):
        sh, sw, h, w = (int(v) for v in rng.integers(1, 200, 4))
        img = rng.integers(0, 256, (sh, sw, 3), np.uint8)
        np.testing.assert_array_equal(
            resize_linear(img, (w, h)),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR),
            err_msg=f"{sh}x{sw}->{h}x{w}")


def test_exact_2x_is_opencvs_area_route():
    img = np.random.default_rng(8).integers(0, 256, (720, 1280, 3), np.uint8)
    area = cv2.resize(img, (640, 360), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_linear(img, (640, 360)), area)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Synthetic JPEGs of 120-199 px a side, loaded at 64 and 256 (down
    and up)."""
    return make_synth_dataset(tmp_path_factory.mktemp("rs") / "ds", n_train=6,
                              n_val=0, imgsz=160, seed=3)


@pytest.mark.parametrize("imgsz", [64, 256])
def test_max_side_load_matches_jax(dataset, imgsz):
    root = Path(dataset).parent / "images" / "train"
    ours = YOLODataset(str(root), imgsz=imgsz, nc=3)
    theirs = JaxDataset(str(root), imgsz=imgsz, nc=3)
    assert ours.im_files == theirs.im_files
    for i in range(len(ours)):
        a, b = ours(i), theirs(i)
        assert max(a.img.shape[:2]) == imgsz
        np.testing.assert_array_equal(a.img, b.img)
        np.testing.assert_array_equal(a.boxes, b.boxes)


def test_letterbox_and_load_without_cv2_match_jax(dataset, tmp_path):
    """The port's letterbox of frames that need a resize, and its
    max-side load of `.npy` sidecars, in a process with cv2 blocked, equal
    the JAX package's (cv2) letterbox and load."""
    rng = np.random.default_rng(9)
    shapes = [(721, 1280), (1000, 1500), (145, 256), (300, 500), (720, 1280)]
    for i, (h, w) in enumerate(shapes):
        np.save(tmp_path / f"f{i}.npy", rng.integers(0, 256, (h, w, 3), np.uint8))
    root = Path(dataset).parent / "images" / "train"
    jds = JaxDataset(str(root), imgsz=96, nc=3, cache="disk")
    want_load = [jds(i).img for i in range(len(jds))]   # writes the sidecars
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        from dedark_yolo_tpu_torch.data.augment import letterbox
        from dedark_yolo_tpu_torch.data.dataset import YOLODataset
        d = {str(tmp_path)!r}
        for i in range({len(shapes)}):
            img = np.load(f"{{d}}/f{{i}}.npy")
            np.save(f"{{d}}/lb{{i}}.npy", letterbox(img, 640)[0])
        ds = YOLODataset({str(root)!r}, imgsz=96, nc=3, cache="disk")
        for i in range(len(ds)):
            np.save(f"{{d}}/load{{i}}.npy", ds(i).img)
        print("OK")
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "OK" in p.stdout, p.stdout + p.stderr
    for i in range(len(shapes)):
        img = np.load(tmp_path / f"f{i}.npy")
        np.testing.assert_array_equal(np.load(tmp_path / f"lb{i}.npy"),
                                      jax_letterbox(img, 640)[0])
    for i, want in enumerate(want_load):
        np.testing.assert_array_equal(np.load(tmp_path / f"load{i}.npy"), want)
