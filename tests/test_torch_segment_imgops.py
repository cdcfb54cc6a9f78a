"""Torch port: the OpenCV calls of the segment task's mask path, without
OpenCV (`data/imgops.py`), held bit for bit to cv2 on this host's OpenCV.

  - `fill_poly` = cv2.fillPoly (LINE_8, shift 0): seeded convex and concave
    polygons, 1000-point resampled outlines (the GT rasteriser's input),
    self-intersecting ones, and polygons that leave the image by one pixel
    or far (the mosaic canvas's copy-paste), on odd sizes;
  - `resize_nearest` = cv2.resize(INTER_NEAREST) of uint8 masks;
  - `resize_linear_f32` = cv2.resize(INTER_LINEAR) of float32 images of at
    least 2 x 2 pixels, up and down, 2x down included;
  - `find_external_contours` = cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE), the contours, their order and cv2.contourArea,
    on masks with holes, islands in holes, several parts and noise.
Every comparison is exact.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data.segment import resample_segment  # noqa: E402
from dedark_yolo_tpu_torch.data import imgops  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401


def _star(rng, h, w, k, reach=0):
    """A star-shaped (often concave) polygon around a centre that may lie
    up to `reach` pixels outside the image."""
    cx = rng.uniform(-reach, w + reach)
    cy = rng.uniform(-reach, h + reach)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(2, max(h, w) * 0.6, k)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)


def _polygons(seed, n=150):
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = int(rng.integers(5, 160)), int(rng.integers(5, 160))
        kind = t % 5
        if kind == 0:      # convex: a hull-ordered circle sample
            ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
            r = rng.uniform(3, min(h, w) / 2)
            p = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
        elif kind == 1:    # concave, inside or around the image
            p = _star(rng, h, w, int(rng.integers(5, 14)))
        elif kind == 2:    # a 1000-point resampled outline
            p = resample_segment(_star(rng, h, w, int(rng.integers(3, 10))))
        elif kind == 3:    # vertices on or one past the border
            k = int(rng.integers(3, 9))
            p = np.stack([rng.integers(0, w + 1, k), rng.integers(0, h + 1, k)], 1)
        else:              # self-intersecting, far outside
            p = rng.uniform(-60, max(h, w) + 60, (int(rng.integers(3, 9)), 2))
        yield h, w, np.asarray(p, np.float32).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_poly_bit_equal_cv2(seed):
    for h, w, p in _polygons(seed):
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [p], 1)
        got = imgops.fill_poly(np.zeros((h, w), np.uint8), p, 1)
        np.testing.assert_array_equal(got, want)


def test_fill_poly_value_and_existing_mask():
    """The value is written over what the mask holds (copy-paste's mask
    gathers several instances)."""
    rng = np.random.default_rng(7)
    want = np.zeros((97, 131), np.uint8)
    got = want.copy()
    for v in (1, 3, 255):
        p = _star(rng, 97, 131, 7, reach=20).astype(np.int32)
        cv2.fillPoly(want, [p], v)
        imgops.fill_poly(got, p, v)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_resizes_bit_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    for t in range(120):
        sh, sw = int(rng.integers(2, 170)), int(rng.integers(2, 170))
        if t % 8 == 0:           # exactly 2x down
            dh, dw = sh // 2 or 1, sw // 2 or 1
            sh, sw = 2 * dh, 2 * dw
        else:
            dh, dw = int(rng.integers(1, 400)), int(rng.integers(1, 400))
        m = (rng.uniform(0, 1, (sh, sw)) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(
            imgops.resize_nearest(m, (dw, dh)),
            cv2.resize(m, (dw, dh), interpolation=cv2.INTER_NEAREST))
        f = rng.uniform(0, 1, (sh, sw)).astype(np.float32)
        f *= rng.uniform(0, 1, (sh, sw)) > 0.3     # box-cropped probabilities
        np.testing.assert_array_equal(
            imgops.resize_linear_f32(f, (dw, dh)),
            cv2.resize(f, (dw, dh), interpolation=cv2.INTER_LINEAR))


def _masks(seed, n=80):
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = int(rng.integers(3, 130)), int(rng.integers(3, 130))
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            cv2.fillPoly(m, [_star(rng, h, w, int(rng.integers(3, 9))
                                   ).astype(np.int32)], 1)
        if t % 2:
            m ^= (rng.uniform(0, 1, (h, w)) < 0.08).astype(np.uint8)
        if t % 3 == 0:      # a hole with an island in it
            m[h // 4:3 * h // 4, w // 4:3 * w // 4] = 0
            m[h // 3:h // 2, w // 3:w // 2] = 1
        yield m


@pytest.mark.parametrize("seed", [0, 1])
def test_find_external_contours_bit_equal_cv2(seed):
    for m in _masks(seed):
        want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = imgops.find_external_contours(m)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c.reshape(-1, 2))
            assert imgops.contour_area(g) == cv2.contourArea(c)


def test_contours_of_empty_and_single_pixel_masks():
    assert imgops.find_external_contours(np.zeros((5, 7), np.uint8)) == []
    m = np.zeros((5, 7), np.uint8)
    m[0, 6] = m[4, 0] = m[2, 3] = 1
    want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got = imgops.find_external_contours(m)
    assert [g.tolist() for g in got] == [c.reshape(-1, 2).tolist() for c in want]

