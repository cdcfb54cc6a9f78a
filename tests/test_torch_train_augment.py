"""Torch port vs the JAX package: the cv2-free image operations of the
train transforms (data/imgops.py) against the cv2 calls the JAX package
makes, and TrainTransforms against the JAX one on one synthetic dataset.

Bars: every operation is bit-equal to OpenCV (5.0 on the x86 build these
tests run on; the colour conversions over every uint8 input). The warps
and HSV->BGR round a row's scalar tail otherwise than its vector body, so
their results depend on the vector width OpenCV dispatches on the host:
`host_widths` finds that width by probing cv2 and sets imgops' to it, and
those tests hold bit-equality at the host's width. Where no width
reproduces the host's cv2 (other arithmetic altogether), they hold the
bars of `FALLBACK` instead, each measured on OpenCV 5.0 by giving imgops a width
other than OpenCV's. Train transforms: equal classes and images, boxes
within 1e-4 px (the box arithmetic is the JAX package's; 1e-4 leaves room
for the float32 rows' last bit), and the per-item rng's state equal after
every item, which shows both draw the same numbers in the same order.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data import augment as JA  # noqa: E402
from dedark_yolo_tpu.data.augment import Sample as JSample  # noqa: E402

from dedark_yolo_tpu_torch.data import augment as TA  # noqa: E402
from dedark_yolo_tpu_torch.data import imgops as I  # noqa: E402

BORDER = (114, 114, 114)
# vector widths an OpenCV build may dispatch; 1 puts the whole row in the
# vector body and 1 << 30 the whole row in the scalar tail
WIDTHS = (4, 8, 16, 32, 64, 1, 1 << 30)
# (levels, share of values) where no width reproduces the host's cv2: the
# worst that a wrong width gave against OpenCV 5.0 (x86), with room (the
# whole row in the scalar tail: warp 1 level on 6.4e-5 of the values,
# HSV->BGR 1 on 0.32, the 64-px train transforms 9 on 0.39 of an item's)
FALLBACK = {"warp": (1, 1e-3), "hsv": (1, 0.5), "transforms": (16, 0.6)}


def _warp_probe():
    """A warp whose source coordinates lie near x = 4000 (ulp 2^-11), so
    that the tail's and the body's rounding of a coordinate move the
    interpolated value across a rounding boundary on many pixels; 127
    columns leave a tail of a different length for each width."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (48, 4200, 3), np.uint8)
    m = np.array([[0.731, 0.0123, 4000.37], [0.0071, 0.613, 3.21]])
    M = I.invert_affine(m)
    return np.array_equal(I.warp_affine(src, M, (127, 40)),
                          cv2.warpAffine(src, M, dsize=(127, 40),
                                         borderValue=BORDER))


def _hsv_probe():
    rng = np.random.default_rng(1)
    hsv = rng.integers(0, 256, (400, 127, 3), np.uint8)
    hsv[..., 0] %= 180
    return np.array_equal(I.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.fixture(scope="module", autouse=True)
def host_widths():
    """imgops' WARP_VECTOR and HSV_VECTOR set, for this module, to the
    first width (imgops' own first) that reproduces the host's cv2 on a
    probe; yields {name: width or None}."""
    mp = pytest.MonkeyPatch()
    found = {}
    for attr, probe in (("WARP_VECTOR", _warp_probe),
                        ("HSV_VECTOR", _hsv_probe)):
        default = getattr(I, attr)
        found[attr] = None
        for width in (default,) + WIDTHS:
            mp.setattr(I, attr, width)
            if probe():
                found[attr] = width
                break
        else:
            mp.setattr(I, attr, default)
    yield found
    mp.undo()


def assert_u8(got, want, exact, bar, err_msg=""):
    """Bit-equal when `exact`, else within FALLBACK[bar]'s levels on at
    most its share of the values."""
    assert got.shape == want.shape, err_msg
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    levels, share = FALLBACK[bar]
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= levels, (err_msg, int(d.max()))
    assert (d > 0).mean() <= share, (err_msg, float((d > 0).mean()))


def _img(seed, h=97, w=131, extremes=False):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if extremes:  # saturated and black blocks, grey ramps
        img[: h // 3] = 255
        img[h // 3: h // 2] = 0
        img[-8:] = np.arange(w, dtype=np.uint8)[None, :, None]
    return img


def _matrix(seed, shape, degrees, shear, perspective, border):
    M, h, w, _ = JA._affine_matrix(shape, degrees, 0.2, 0.5, shear,
                                   perspective, border, random.Random(seed))
    return M, h, w


@pytest.mark.parametrize("degrees,shear,border", [
    (0.0, 0.0, (0, 0)), (30.0, 0.0, (0, 0)), (10.0, 10.0, (0, 0)),
    (45.0, 5.0, (-40, -48)), (0.0, 0.0, (-32, -16))])
@pytest.mark.parametrize("width", [131, 128, 117])
def test_warp_affine_bit_equal(degrees, shear, border, width, host_widths):
    """Rotation, shear, scale and translation, output widths with and
    without a scalar tail, border pixels all round the edge."""
    exact = host_widths["WARP_VECTOR"] is not None
    img = _img(1, w=width, extremes=True)
    for seed in range(6):
        M, h, w = _matrix(seed, img.shape, degrees, shear, 0.0, border)
        want = cv2.warpAffine(img, M[:2], dsize=(w, h), borderValue=BORDER)
        assert_u8(I.warp_affine(img, M[:2], (w, h)), want, exact, "warp")


@pytest.mark.parametrize("perspective", [1e-4, 1e-3])
def test_warp_perspective_bit_equal(perspective, host_widths):
    exact = host_widths["WARP_VECTOR"] is not None
    img = _img(2, extremes=True)
    for seed in range(6):
        M, h, w = _matrix(seed, img.shape, 20.0, 5.0, perspective, (-16, -16))
        want = cv2.warpPerspective(img, M, dsize=(w, h), borderValue=BORDER)
        assert_u8(I.warp_perspective(img, M, (w, h)), want, exact, "warp")


def test_rotation_matrix_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        a, s = rng.uniform(-180, 180), rng.uniform(0.1, 2.0)
        c = tuple(rng.uniform(-50, 50, 2)) if _ % 2 else (0, 0)
        np.testing.assert_array_equal(
            I.rotation_matrix_2d(a, s, c),
            cv2.getRotationMatrix2D(angle=a, center=c, scale=s))


def _all_colours():
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8)


@pytest.mark.parametrize("width", [4096, 31, 100])
def test_hsv_round_trip_bit_equal(width, host_widths):
    """Every uint8 colour: BGR->HSV, and HSV->BGR for every H in 0-179,
    in rows whose width puts them in OpenCV's vector body, its scalar tail,
    or both."""
    flat = _all_colours()
    n = len(flat) // width * width
    img = flat[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(I.bgr2hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    hsv = img.copy()
    hsv[..., 0] %= 180
    assert_u8(I.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR),
              host_widths["HSV_VECTOR"] is not None, "hsv")


@pytest.mark.parametrize("ours,code", [
    (I.bgr2gray, cv2.COLOR_BGR2GRAY), (I.bgr2lab, cv2.COLOR_BGR2LAB),
    (I.lab2bgr, cv2.COLOR_LAB2BGR)], ids=["gray", "lab", "lab2bgr"])
def test_colour_conversion_bit_equal(ours, code):
    """Every uint8 triple (LAB->BGR: every uint8 L, a, b)."""
    img = _all_colours().reshape(4096, 4096, 3)
    np.testing.assert_array_equal(ours(img), cv2.cvtColor(img, code))


@pytest.mark.parametrize("hgain,sgain,vgain", [
    (0.0, 0.0, 0.0), (0.015, 0.7, 0.4), (0.5, 1.0, 1.0)])
def test_random_hsv_bit_equal(hgain, sgain, vgain, host_widths):
    """HSV gains at 0, at the defaults and at the limits, on u8 extremes;
    both draw the same three numbers."""
    img = _img(4, extremes=True)
    r1, r2 = random.Random(7), random.Random(7)
    got = TA.random_hsv(img, hgain, sgain, vgain, r1)
    want = JA.random_hsv(img, hgain, sgain, vgain, r2)
    assert_u8(got, want, host_widths["HSV_VECTOR"] is not None, "hsv")
    assert r1.getstate() == r2.getstate()


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7])
def test_box_blur_bit_equal(k):
    for seed, img in enumerate([_img(5, extremes=True), _img(6, 7, 9),
                                (_img(7) > 127).astype(np.uint8) * 255]):
        np.testing.assert_array_equal(I.box_blur(img, k), cv2.blur(img, (k, k)),
                                      err_msg=f"image {seed}")


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_blur_bit_equal(k):
    for img in (_img(8, extremes=True), _img(9, 8, 11)):
        np.testing.assert_array_equal(I.median_blur(img, k),
                                      cv2.medianBlur(img, k))


@pytest.mark.parametrize("clip", [1.0, 2.7, 4.0])
@pytest.mark.parametrize("shape", [(64, 64), (97, 131), (480, 640)])
def test_clahe_bit_equal(clip, shape):
    img = cv2.cvtColor(_img(10, *shape, extremes=True), cv2.COLOR_BGR2GRAY)
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(img)
    np.testing.assert_array_equal(I.clahe(img, clip), want)


def test_photometric_extras_bit_equal():
    """p = 1: every extra runs (blur, median, gray, CLAHE)."""
    img = _img(11, extremes=True)
    for seed in range(4):
        r1, r2 = random.Random(seed), random.Random(seed)
        got = TA.photometric_augment(img, r1, p=1.0)
        want = JA.photometric_augment(img, r2, p=1.0)
        assert r1.getstate() == r2.getstate()
        np.testing.assert_array_equal(got, want)


class _Data:
    """A get_sample over seeded images of mixed shapes (longest side
    imgsz) with 1-4 boxes each, in both packages' Sample type."""

    def __init__(self, sample_cls, n=6, imgsz=64, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for k in range(n):
            h, w = [(imgsz, imgsz), (48, imgsz), (imgsz, 40)][k % 3]
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            m = int(rng.integers(1, 5))
            xy = rng.uniform(0, 0.6, (m, 2)) * [w, h]
            wh = rng.uniform(0.1, 0.4, (m, 2)) * [w, h]
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            cls = rng.integers(0, 3, m).astype(np.float32)
            self.items.append((img, boxes, cls))
        self.sample_cls = sample_cls

    def __len__(self):
        return len(self.items)

    def random_index(self, rng):
        return rng.randrange(len(self.items))

    def __call__(self, index, imgsz=None):
        img, boxes, cls = self.items[index]
        return self.sample_cls(img.copy(), boxes.copy(), cls.copy())


HYP_DEFAULT = {"mosaic": 1.0, "mixup": 0.0, "hsv_h": 0.015, "hsv_s": 0.7,
               "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1, "scale": 0.5,
               "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
               "fliplr": 0.5, "photometric": True}


@pytest.mark.parametrize("name,hyp,n_mosaic", [
    ("default", {}, 4),
    ("mosaic9", {}, 9),
    ("mixup", {"mixup": 1.0}, 4),
    ("geometry", {"degrees": 20.0, "shear": 5.0, "perspective": 5e-4,
                  "flipud": 0.5, "mosaic": 0.5}, 4),
    ("close_mosaic", {"mosaic": 0.0}, 4)])
def test_train_transforms_match_jax(name, hyp, n_mosaic, host_widths):
    """Both TrainTransforms on one dataset and seed, 12 items: equal
    classes, boxes within 1e-4 px (xywh normalised, times imgsz), images
    equal, rng state equal after each item."""
    exact = None not in host_widths.values()
    imgsz = 64
    h = {**HYP_DEFAULT, **hyp}
    jt = JA.TrainTransforms(h, imgsz=imgsz, n_mosaic=n_mosaic)
    tt = TA.TrainTransforms(h, imgsz=imgsz, n_mosaic=n_mosaic)
    jd, td = _Data(JSample, imgsz=imgsz), _Data(TA.Sample, imgsz=imgsz)
    for item in range(12):
        r1, r2 = random.Random(100 + item), random.Random(100 + item)
        jimg, jbox, jcls = jt(jd, item % len(jd), r1)
        timg, tbox, tcls = tt(td, item % len(td), r2)
        assert r1.getstate() == r2.getstate(), item
        np.testing.assert_array_equal(tcls, jcls)
        np.testing.assert_allclose(tbox * imgsz, jbox * imgsz, rtol=0, atol=1e-4)
        assert timg.dtype == np.uint8
        assert_u8(timg, jimg, exact, "transforms", f"item {item}")


def test_train_transforms_photometric_seeds_match(host_widths):
    """400 items at the default hyp, so that the photometric extras (p =
    0.01 each) run on a few of them: all bit-equal."""
    exact = None not in host_widths.values()
    imgsz = 64
    jt = JA.TrainTransforms(HYP_DEFAULT, imgsz=imgsz)
    tt = TA.TrainTransforms(HYP_DEFAULT, imgsz=imgsz)
    jd, td = _Data(JSample, imgsz=imgsz), _Data(TA.Sample, imgsz=imgsz)
    for seed in range(400):
        r1, r2 = random.Random(seed), random.Random(seed)
        jimg, jbox, jcls = jt(jd, seed % len(jd), r1)
        timg, tbox, tcls = tt(td, seed % len(td), r2)
        assert r1.getstate() == r2.getstate()
        np.testing.assert_array_equal(tcls, jcls)
        np.testing.assert_allclose(tbox, jbox, rtol=0, atol=1e-4 / imgsz)
        assert_u8(timg, jimg, exact, "transforms", f"seed {seed}")
