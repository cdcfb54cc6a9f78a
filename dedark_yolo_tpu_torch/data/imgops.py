"""The image operations of the transforms and the resizes, without OpenCV.

Each function computes what the OpenCV call named in its docstring computes
on uint8 BGR images (JAX data/augment.py calls them through cv2): the same
border rule, the same arithmetic and the same rounding, so the results are
bit-equal to OpenCV 5.0's on the x86 build the JAX package's tests run
(held there by tests/test_torch_train_augment.py). The machine that trains
on the card has no OpenCV.

numpy releases the GIL in its array loops, so the loader's threads
overlap these calls.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

BORDER_VALUE = 114
# OpenCV 5.0's warp kernels compute a row in vectors of 16 pixels (its AVX2
# dispatch) and the last width % 16 pixels in scalar code whose coordinate
# arithmetic rounds differently (see `_warp_coords`).
WARP_VECTOR = 16
HSV_VECTOR = 32   # the same for HSV2BGR, whose tail rounds instead


# -------------------------------------------------------------------- resize
def _resize_taps(dst, src):
    """Per destination index along one axis: the first source index (not
    yet clamped) and the two 11-bit weights, as OpenCV's linear resize
    computes them: the coordinate (d + 0.5) * scale - 0.5 in float32, its
    floor, and cvRound((1 - f) * 2048), cvRound(f * 2048) in float32."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    return s, w0, w1


def resize_linear(img, dsize):
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_LINEAR) of a
    uint8 HW or HWC image. Horizontal pass first: two taps with 11-bit
    weights summed exactly in int32, a source column left of the image
    clamped with weights (2048, 0) and one at or past the last column read
    alone at 2048. Then the vertical pass over rows clamped to the image,
    in OpenCV's vector arithmetic, which OpenCV 5.0 applies to the whole
    row: ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16), then (+ 2) >> 2
    and saturation. At exactly 2x down in both axes OpenCV takes INTER_AREA
    instead, whose (sum + 2) >> 2 of each 2x2 block this formula equals."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    src = img.reshape(sh, sw, -1)
    sx, a0, a1 = _resize_taps(w, sw)
    left = sx < 0
    a0[left], a1[left], sx[left] = 2048, 0, 0
    right = sx >= sw - 1
    a0[right], a1[right], sx[right] = 2048, 0, sw - 1
    sx1 = np.minimum(sx + 1, sw - 1)
    sy, b0, b1 = _resize_taps(h, sh)
    y0, y1 = np.clip(sy, 0, sh - 1), np.clip(sy + 1, 0, sh - 1)
    rows = np.unique(np.concatenate([y0, y1]))
    r = src[rows].astype(np.int32)
    hpass = r[:, sx] * a0[None, :, None] + r[:, sx1] * a1[None, :, None]
    hpass >>= 4
    at = np.searchsorted(rows, y0), np.searchsorted(rows, y1)
    out = ((hpass[at[0]] * b0[:, None, None]) >> 16) \
        + ((hpass[at[1]] * b1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    # cv2 returns a one-channel image as (h, w)
    return out.reshape((h, w) + (img.shape[2:] if src.shape[2] > 1 else ()))


# --------------------------------------------------------------------- warps
def _warp_coords(w, h, a, b, c):
    """The source coordinate a * x + b * y + c of every destination pixel,
    float32 (h, w), as OpenCV 5.0 computes it: fma(x, a, fl(y * b + c)) in
    the vector body of a row, fl(fma(x, a, fl(y * b)) + c) in its tail (a
    float64 product of two float32 values is exact, so the float64 sum
    rounded to float32 is the fma)."""
    a, b, c = np.float32(a), np.float32(b), np.float32(c)
    xa = np.arange(w, dtype=np.float64) * np.float64(a)
    yb = np.arange(h, dtype=np.float32) * b
    out = (xa[None, :] + (yb + c).astype(np.float64)[:, None]).astype(np.float32)
    t = w - w % WARP_VECTOR
    if t < w:
        out[:, t:] = (xa[None, t:] + yb.astype(np.float64)[:, None]).astype(np.float32) + c
    return out


def _bilinear(img, sx, sy, border):
    """Bilinear samples of HWC uint8 `img` at float32 (h, w) coordinates:
    each of the four neighbours outside the image reads `border`; the two
    horizontal lerps, then the vertical one, each one fma in float32;
    rounded half to even and saturated (OpenCV 5.0 INTER_LINEAR,
    BORDER_CONSTANT)."""
    H, W = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    # a ring of two border pixels: every neighbour of a clipped coordinate
    # is a plain read, and one outside the image reads the border; a pixel
    # is one uint32 (up to 4 channels), so each tap is one 1-D take
    src = np.full((H + 4, W + 4, 4), border, np.uint8)
    src[2:-2, 2:-2, :c] = img.reshape(H, W, c)
    flat = src.view(np.uint32).reshape(-1)
    lim = np.float32(1 << 24)   # non-finite or far coordinates: outside
    sx = np.clip(np.nan_to_num(sx, nan=-lim), -lim, lim)
    sy = np.clip(np.nan_to_num(sy, nan=-lim), -lim, lim)
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx).astype(np.float64)[..., None]
    ay = (sy - fy).astype(np.float64)[..., None]
    i00 = ((np.clip(fy, -2, H).astype(np.int64) + 2) * (W + 4)
           + np.clip(fx, -2, W).astype(np.int64) + 2)

    def tap(offset):
        px = np.take(flat, i00 + offset).view(np.uint8)
        return px.reshape(*i00.shape, 4)[..., :c].astype(np.float64)

    def fma(a, d, p):
        # a float32 a, d and p: a * d is exact in float64, so the sum
        # rounded once to float32 is the fma (for the integer taps the
        # whole sum is exact)
        d *= a
        d += p
        return d.astype(np.float32)

    p0, p1 = tap(0), tap(1)
    f0 = fma(ax, p1 - p0, p0)
    p0, p1 = tap(W + 4), tap(W + 5)
    f1 = fma(ax, p1 - p0, p0)
    out = fma(ay, (f1 - f0).astype(np.float64), f0)
    out = np.rint(out, out).clip(0, 255).astype(np.uint8)
    return out.reshape(sx.shape + img.shape[2:])


def invert_affine(M):
    """cv2.invertAffineTransform of a 2x3 matrix, in float64."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[1, 1] * d, M[0, 0] * d
    a12, a21 = -M[0, 1] * d, -M[1, 0] * d
    b1 = -a11 * M[0, 2] - a12 * M[1, 2]
    b2 = -a21 * M[0, 2] - a22 * M[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def invert3(M):
    """cv2.invert of a 3x3 matrix (DECOMP_LU: the closed form OpenCV uses
    for n = 3), in float64; all zeros when singular."""
    S = np.asarray(M, np.float64)
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d,
         (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
         (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d],
        [(S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d,
         (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d,
         (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d],
        [(S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d,
         (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
         (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d]])


def warp_affine(img, M, dsize, border_value=BORDER_VALUE):
    """cv2.warpAffine(img, M, dsize=(w, h), borderValue=(v, v, v)):
    INTER_LINEAR, BORDER_CONSTANT; M maps source to destination pixels."""
    w, h = dsize
    m = invert_affine(M).astype(np.float32)
    sx = _warp_coords(w, h, *m[0])
    sy = _warp_coords(w, h, *m[1])
    return _bilinear(img, sx, sy, border_value)


def warp_perspective(img, M, dsize, border_value=BORDER_VALUE):
    """cv2.warpPerspective(img, M, dsize=(w, h), borderValue=(v, v, v)):
    INTER_LINEAR, BORDER_CONSTANT; the source point is (X / W, Y / W),
    each of X, Y, W computed as `_warp_coords` does, divided in float32."""
    w, h = dsize
    m = invert3(M).astype(np.float32)
    X, Y, W = (_warp_coords(w, h, *row) for row in m)
    return _bilinear(img, X / W, Y / W, border_value)


def rotation_matrix_2d(angle, scale, center=(0.0, 0.0)):
    """cv2.getRotationMatrix2D(center, angle, scale): a 2x3 float64 matrix
    rotating by `angle` degrees (counter-clockwise) about `center` (a
    float32 point, as OpenCV's Point2f)."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# ------------------------------------------------------------------- colour
_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I[1:])]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6 * _I[1:]))]).astype(np.int32)
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                         [2, 1, 0]])


def bgr2hsv(img):
    """cv2.cvtColor(img, COLOR_BGR2HSV) of uint8 BGR: OpenCV's integer
    tables, H in 0-179."""
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv2bgr(img):
    """cv2.cvtColor(img, COLOR_HSV2BGR) of uint8 HSV (H in 0-179): OpenCV's
    float32 sector formula, s and v scaled by 1/255, 1 - s * h and
    1 - s * (1 - h) each one fma, the result * 255 truncated in the vector
    body of a row (HSV_VECTOR pixels at a time) and rounded half to even
    in its scalar tail."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1 / 255.0)
    v = img[..., 2].astype(f32) * f32(1 / 255.0)
    h = np.fmod(h, f32(6))
    sector = np.floor(h)
    h = h - sector
    one = np.float64(1)
    s64 = s.astype(np.float64)
    tab = np.stack([
        v, v * (f32(1) - s),
        v * (one - s64 * h).astype(f32),
        v * (one - s64 * (f32(1) - h)).astype(f32)], -1)
    idx = _HSV_SECTORS[sector.astype(np.int64).clip(0, 5)]
    out = np.take_along_axis(tab, idx, -1)
    out *= f32(255)
    t = img.shape[1] - img.shape[1] % HSV_VECTOR
    np.floor(out[:, :t], out[:, :t])
    np.rint(out[:, t:], out[:, t:])
    return out.clip(0, 255).astype(np.uint8)


def bgr2gray(img):
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of uint8 BGR (15-bit fixed point)."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


# LAB: OpenCV's 8-bit tables (gamma shift 3, lab shift 12)
_GAMMA_SHIFT, _LAB_SHIFT = 3, 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_SRGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _lab_tables():
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255 * (1 << _GAMMA_SHIFT) * gamma).astype(np.int64)
    # the cube-root table in float32, as OpenCV builds it
    t = (np.float32(1) / np.float32(255 << _GAMMA_SHIFT)) * np.arange(
        256 * 3 // 2 << _GAMMA_SHIFT).astype(np.float32)
    cbrt = np.where(t < np.float32(0.008856),
                    t * np.float32(7.787) + np.float32(16 / 116), np.cbrt(t))
    cbrt_tab = np.rint(cbrt.astype(np.float64) * (1 << _LAB_SHIFT2)).astype(np.int64)
    coeffs = np.rint((1 << _LAB_SHIFT) * _SRGB2XYZ / _D65[:, None]).astype(np.int64)
    return gamma_tab, cbrt_tab, coeffs


_LAB_GAMMA, _LAB_CBRT, _LAB_COEFFS = _lab_tables()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def bgr2lab(img):
    """cv2.cvtColor(img, COLOR_BGR2LAB) of uint8 BGR: OpenCV's integer path
    (sRGB gamma table, fixed-point XYZ, cube-root table)."""
    b, g, r = (_LAB_GAMMA[img[..., k]] for k in range(3))
    fx, fy, fz = (_LAB_CBRT[_descale(r * c[0] + g * c[1] + b * c[2], _LAB_SHIFT)]
                  for c in _LAB_COEFFS)
    L = _descale(((116 * 255 + 50) // 100) * fy
                 - (16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return np.stack([L, a, bb], -1).clip(0, 255).astype(np.uint8)


def _lab_inverse_tables():
    """OpenCV's 8-bit LAB->BGR tables (BASE = 2**14): per L the Y and f(Y)
    pair, f^-1 of f(X) and f(Z) over their integer range, the XYZ->sRGB
    matrix times the white point in 12-bit fixed point, and the inverse
    sRGB gamma over 4096 steps."""
    base = 1 << 14
    li = np.arange(256) * 100 / 255
    fy = (li + 16) / 116
    dark = np.arange(256) <= 20            # L* <= 8: the linear segment
    y = np.where(dark, np.rint(li / 903.3 * base), np.rint(fy ** 3 * base))
    ify = np.where(dark, np.rint((7.787 * li / 903.3 + 16 / 116) * base),
                   np.rint(fy * base))
    v = np.arange(_AB_MIN, base * 9 // 4 + _AB_MIN)
    xz = np.where(v <= 3390, np.trunc(v * 108 / 841).astype(np.int64) - 290,
                  v * v // base * v // base)
    coeffs = np.rint((1 << _LAB_SHIFT) * np.linalg.inv(_SRGB2XYZ)
                     * _D65[None, :]).astype(np.int64)
    x = np.arange(4096) / 4096
    inv_gamma = np.where(x <= 0.0031308, 12.92 * x,
                         1.055 * x ** (1 / 2.4) - 0.055)
    return (y.astype(np.int64), ify.astype(np.int64), xz, coeffs,
            np.rint(255 * inv_gamma).astype(np.int64))


_AB_MIN = -8145
_LAB_Y, _LAB_IFY, _LAB_XZ, _LAB_INV, _LAB_INV_GAMMA = _lab_inverse_tables()


def lab2bgr(lab):
    """cv2.cvtColor(lab, COLOR_LAB2BGR) of uint8 LAB: OpenCV's integer path
    (f(Y) from a table of L, a / 500 and b / 200 in fixed point, f^-1 and
    the XYZ->sRGB matrix in integers, the inverse gamma table)."""
    L, a, b = (lab[..., k].astype(np.int64) for k in range(3))
    base = 1 << 14
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * base // 200 + 1
    ify = _LAB_IFY[L]
    xyz = (_LAB_XZ[ify + adiv - _AB_MIN], _LAB_Y[L], _LAB_XZ[ify - bdiv - _AB_MIN])
    rgb = [_LAB_INV_GAMMA[np.clip(_descale(sum(c * t for c, t in zip(row, xyz)), 14),
                                  0, 4095)] for row in _LAB_INV]
    return np.stack(rgb[::-1], -1).astype(np.uint8)


# ------------------------------------------------------------------ filters
def box_blur(img, k):
    """cv2.blur(img, (k, k)) of uint8: BORDER_REFLECT_101, anchor at k // 2;
    the window sum divided as OpenCV divides it: for an area that is a
    power of two, (sum + area / 2 + 1) >> log2(area); else float32
    sum * (1 / area) rounded half up."""
    a = k // 2
    pad = ((a, k - 1 - a), (a, k - 1 - a)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img.astype(np.int64), pad, mode="reflect")
    # summed-area table: the window sums in O(1) a pixel
    c = np.pad(p.cumsum(0).cumsum(1), ((1, 0), (1, 0)) + ((0, 0),) * (img.ndim - 2))
    h, w = img.shape[:2]
    s = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    area = k * k
    if area & (area - 1) == 0:
        out = (s + area // 2 + 1) >> (area.bit_length() - 1)
    else:
        out = np.floor(s.astype(np.float32) * np.float32(1 / area) + np.float32(0.5))
    return out.clip(0, 255).astype(np.uint8)


def median_blur(img, k):
    """cv2.medianBlur(img, k) of uint8, k odd: BORDER_REPLICATE."""
    a = k // 2
    pad = ((a, a), (a, a)) + ((0, 0),) * (img.ndim - 2)
    win = sliding_window_view(np.pad(img, pad, mode="edge"), (k, k), axis=(0, 1))
    return np.median(win.reshape(*img.shape, k * k), -1).astype(np.uint8)


def clahe(gray, clip_limit, tiles=8):
    """cv2.createCLAHE(clipLimit, (tiles, tiles)).apply(gray) of uint8:
    BORDER_REFLECT_101 padding up to a multiple of the grid, per-tile
    histograms clipped at int(clip * area / 256) (at least 1) with the
    excess spread evenly and its remainder every 256 // remainder bins, the
    tile LUTs as float32 cumsum * (255 / area) rounded, then the bilinear
    blend of the four nearest tiles' LUTs in float32."""
    f32 = np.float32
    H, W = gray.shape
    ext = gray
    if H % tiles or W % tiles:
        ext = np.pad(gray, ((0, tiles - H % tiles), (0, tiles - W % tiles)),
                     mode="reflect")
    th, tw = ext.shape[0] // tiles, ext.shape[1] // tiles
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    tiles_px = ext[:th * tiles, :tw * tiles].reshape(tiles, th, tiles, tw)
    tiles_px = tiles_px.transpose(0, 2, 1, 3).reshape(tiles * tiles, area)
    hist = np.stack([np.bincount(t, minlength=256) for t in tiles_px])
    if limit > 0:
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        for t, resid in enumerate(clipped % 256):
            if resid:
                hist[t, np.arange(0, 256, max(256 // resid, 1))[:resid]] += 1
    luts = np.rint(hist.cumsum(1).astype(f32) * (f32(255) / f32(area)))
    luts = luts.clip(0, 255).astype(f32).reshape(tiles, tiles, 256)

    def axis(n, size):
        t = np.arange(n).astype(f32) * (f32(1) / f32(size)) - f32(0.5)
        lo = np.floor(t)
        frac = t - lo
        lo = lo.astype(np.int64)
        return np.maximum(lo, 0), np.minimum(lo + 1, tiles - 1), frac, f32(1) - frac

    x1, x2, xa, xa1 = axis(W, tw)
    y1, y2, ya, ya1 = axis(H, th)
    v = gray.astype(np.int64)
    top = (luts[y1[:, None], x1, v] * xa1 + luts[y1[:, None], x2, v] * xa)
    bottom = (luts[y2[:, None], x1, v] * xa1 + luts[y2[:, None], x2, v] * xa)
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.rint(res).clip(0, 255).astype(np.uint8)


# ------------------------------------------------------------- mask raster
XY_SHIFT = 16    # OpenCV's drawing fixed point


def _clip_line(w, h, x1, y1, x2, y2):
    """cv2.clipLine of the segment to the w x h image, OpenCV's arithmetic
    (each crossing a double quotient truncated toward 0, the second one
    from the first's moved end): (inside, x1, y1, x2, y2); the ends are
    moved even where the segment misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _clip_segments(x1, y1, x2, y2, w, h):
    """`_clip_line` of every segment (int64 arrays): (inside, x1, y1, x2,
    y2), the segments wholly in the image passed through as they are."""
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    ok = np.ones(len(x1), bool)
    for i in np.nonzero((np.minimum(x1, x2) < 0) | (np.maximum(x1, x2) >= w)
                        | (np.minimum(y1, y2) < 0)
                        | (np.maximum(y1, y2) >= h))[0]:
        ok[i], x1[i], y1[i], x2[i], y2[i] = _clip_line(
            w, h, int(x1[i]), int(y1[i]), int(x2[i]), int(y2[i]))
    return ok, x1, y1, x2, y2


def _line_pixels(x1, y1, x2, y2):
    """The pixels (ys, xs) of cv2.line(..., lineType=LINE_8) of each
    segment already clipped to the image, walked left to right,
    Bresenham's 8-connected steps. At step k of D = max(|dx|, |dy|) the
    minor coordinate has moved ceil((2 d k - D) / (2 D)), d = min(|dx|,
    |dy|), which is the iterator's error-term walk in closed form."""
    swap = x2 < x1
    x0 = np.where(swap, x2, x1)
    y0 = np.where(swap, y2, y1)
    dx = np.abs(x2 - x1)
    dy = np.where(swap, y1 - y2, y2 - y1)
    sy = np.where(dy < 0, -1, 1)
    ady = np.abs(dy)
    vert = ady > dx
    big = np.where(vert, ady, dx)
    small = np.where(vert, dx, ady)
    n = big + 1
    seg = np.repeat(np.arange(len(n)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    D, d = big[seg], small[seg]
    minor = np.where(D > 0, -((D - 2 * d * k) // np.maximum(2 * D, 1)), 0)
    v = vert[seg]
    xs = x0[seg] + np.where(v, minor, k)
    ys = y0[seg] + np.where(v, k, minor) * sy[seg]
    return ys, xs


def fill_poly(mask, polygon, value=1):
    """cv2.fillPoly(mask, [polygon], value) of one int polygon (k, 2) on a
    2-D mask, in place; returns the mask. OpenCV's LINE_8 fill, shift 0:
    the outline drawn as 8-connected lines (`_line_pixels`) of the edges
    clipped to the image, then the edge table: every non-horizontal edge as
    a 16.16 fixed-point x at each row y0 <= y < y1 of its own ends, with a
    per-row step truncated toward 0 (an edge that leaves the image takes
    its x from its clipped ends, and its y too where those differ), and on
    every row the sorted crossings filled pairwise from ceil(x_left) to
    floor(x_right), both inclusive. Only the edges that leave the image
    are clipped one by one, in Python; the rest is numpy."""
    h, w = mask.shape[:2]
    p = np.asarray(polygon, np.int64).reshape(-1, 2)
    if len(p) == 0:
        return mask
    ax, ay = np.roll(p[:, 0], 1), np.roll(p[:, 1], 1)   # edge i: p[i-1] -> p[i]
    bx, by = p[:, 0], p[:, 1]
    ok, t0x, t0y, t1x, t1y = _clip_segments(ax, ay, bx, by, w, h)
    ys, xs = _line_pixels(t0x[ok], t0y[ok], t1x[ok], t1y[ok])
    mask[ys, xs] = value
    e = ay != by
    if e.sum() < 2:
        return mask
    ax, ay, bx, by = ax[e], ay[e], bx[e], by[e]
    t0x, t0y, t1x, t1y = t0x[e], t0y[e], t1x[e], t1y[e]
    clipped_y = t0y != t1y
    c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
    c0y, c1y = np.where(clipped_y, t0y, ay), np.where(clipped_y, t1y, by)
    num, den = c1x - c0x, c1y - c0y
    step = np.abs(num) // np.abs(den) * np.where((num < 0) == (den < 0), 1, -1)
    down = ay < by
    y0, y1 = np.where(down, ay, by), np.where(down, by, ay)
    x0 = np.where(down, c0x + (ay - c0y) * step, c1x + (by - c1y) * step)
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    cnt = np.maximum(hi - lo, 0)
    k = np.repeat(np.arange(len(cnt)), cnt)
    rows = lo[k] + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    xr = x0[k] + (rows - y0[k]) * step[k]
    order = np.lexsort((xr, rows))
    rows, xr = rows[order], xr[order]
    a = (xr[0::2] + (1 << XY_SHIFT) - 1) >> XY_SHIFT
    b = xr[1::2] >> XY_SHIFT
    r = rows[0::2]
    keep = (a < w) & (b >= 0)
    r, a, b = r[keep], np.maximum(a[keep], 0), np.minimum(b[keep], w - 1)
    if not len(r):
        return mask
    # the spans as +1 / -1 steps over the rows they touch, summed along x
    r0, r1 = int(r.min()), int(r.max()) + 1
    rr = (r - r0) * (w + 1)
    size = (r1 - r0) * (w + 1)
    diff = (np.bincount(rr + a, minlength=size)
            - np.bincount(rr + b + 1, minlength=size)).reshape(r1 - r0, w + 1)
    mask[r0:r1][np.cumsum(diff[:, :w], 1) > 0] = value
    return mask


def resize_nearest(img, dsize):
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_NEAREST):
    destination pixel x reads source floor(x * (1 / (w / sw))), in double,
    clamped to the last column; the same for rows."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64),
                    sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64),
                    sh - 1)
    return img[ys[:, None], xs[None, :]]


def _linear_taps_f32(dst, src):
    """The taps of OpenCV's float linear resize along one axis: the source
    coordinate (d + 0.5) * (src / dst) - 0.5 in double, its floor, and the
    fraction rounded to float32 (a coordinate left of the image reads the
    first pixel alone, one at or past the last pixel the last alone)."""
    c = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(c)
    f = (c - s).astype(np.float32)
    s = s.astype(np.int64)
    edge = s < 0
    f[edge], s[edge] = 0, 0
    edge = s >= src - 1
    f[edge], s[edge] = 0, src - 1
    return s, np.minimum(s + 1, src - 1), f


def _lerp_f32(a, b, f):
    """fma(b - a, f, a) in float32: the difference rounded, then the fused
    multiply-add rounded once (the product is exact in float64)."""
    d = (b - a).astype(np.float64)
    return (d * f + a.astype(np.float64)).astype(np.float32)


def resize_linear_f32(img, dsize):
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_LINEAR) of a
    float32 2-D image of at least 2 x 2 pixels: the horizontal pass, then
    the vertical pass over its rows, each a fused a + (b - a) * f between
    the two taps (`_linear_taps_f32`), at every scale (no INTER_AREA
    shortcut at 2x down, unlike uint8)."""
    w, h = int(dsize[0]), int(dsize[1])
    src = np.asarray(img, np.float32)
    x0, x1, fx = _linear_taps_f32(w, src.shape[1])
    y0, y1, fy = _linear_taps_f32(h, src.shape[0])
    hp = _lerp_f32(src[:, x0], src[:, x1], fx)
    return _lerp_f32(hp[y0], hp[y1], fy[:, None])


# ---------------------------------------------------------------- contours
# OpenCV's chain codes: 0 right, 1 up-right, 2 up, ... (y down)
_CHAIN = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _trace_outer(m, y, x):
    """The outer border of the component whose first pixel in raster order
    is (y, x), as OpenCV's border following (Suzuki-Abe) walks it with
    CHAIN_APPROX_SIMPLE: the points where the chain code changes, starting
    at (x, y). `m` is the 0/1 mask padded with one zero pixel on each side,
    (y, x) in its coordinates."""
    def nz(px, py, s):
        dx, dy = _CHAIN[s & 7]
        return m[py + dy, px + dx] != 0

    s_end = 4
    s = 4
    while True:
        s = (s - 1) & 7
        if nz(x, y, s) or s == s_end:
            break
    if s == s_end:                      # a single pixel
        return [(x - 1, y - 1)]
    d = _CHAIN[s]
    first = (x + d[0], y + d[1])        # i1, where the border closes
    out = []
    prev_s = s ^ 4
    cx, cy = x, y
    while True:
        s_end = s
        while s < 15:
            s += 1
            if nz(cx, cy, s):
                break
        s &= 7
        if s != prev_s:
            out.append((cx - 1, cy - 1))
            prev_s = s
        nx, ny = cx + _CHAIN[s][0], cy + _CHAIN[s][1]
        if (nx, ny) == (x, y) and (cx, cy) == first:
            break
        cx, cy = nx, ny
        s = (s + 4) & 7
    return out


def contour_area(c):
    """cv2.contourArea(c) of an (n, 2) contour: |shoelace| / 2."""
    c = np.asarray(c, np.float64).reshape(-1, 2)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    return float(abs((xp * y - x * yp).sum()) * 0.5)


def find_external_contours(mask):
    """cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    of a 2-D mask (nonzero = 1): a list of (n, 2) int32 (x, y) contours, in
    the reverse raster order of their first pixels, as OpenCV lists them. Foreground is 8-connected,
    background 4-connected, the frame outside the image background; a
    component is external unless the background around it is a hole of
    another component."""
    from scipy import ndimage
    m = np.pad(np.asarray(mask) != 0, 1).astype(np.uint8)
    fg, n = ndimage.label(m, structure=np.ones((3, 3), bool))
    if n == 0:
        return []
    bg, _ = ndimage.label(m == 0)
    outside = bg[0, 0]
    # each component's first pixel in raster order
    flat = fg.ravel()
    idx = np.nonzero(flat)[0]
    labels, first = np.unique(flat[idx], return_index=True)
    starts = sorted((int(idx[f]) for f in first), reverse=True)
    W = m.shape[1]
    out = []
    for s in starts:
        y, x = divmod(s, W)
        if bg[y - 1, x] != outside:     # inside another component's hole
            continue
        out.append(np.asarray(_trace_outer(m, y, x), np.int32).reshape(-1, 2))
    return out
