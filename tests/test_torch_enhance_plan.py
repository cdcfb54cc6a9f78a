"""The launch plan of the enhance kernels' shared blur stage
(`ops/enhance_kernel.py::enhance_plan`, `csrc/usm_tile.cuh`) on the CPU,
before any card: its numbers fill the card and fit its shared memory, its
constants and taps are the ones the source compiles in, and a numpy walk of
it equals the plain versions.

The walk runs the kernel's decomposition block by block: strips of SW output
columns, segments of seg_rows rows, each thread's column of the reflect window
(numpy 'reflect' at every edge), the register window of the last RO + 2*PAD
rows shifted RO rows a chunk, the vertical pass into the shared row buffer,
the horizontal tasks of CO outputs, the sharpen and the row-segment stores.
It runs the f32 point chain (or, in usm mode, the plain load) per window
pixel and must equal `fused_enhance_reference` (`usm_reference`) within
1e-5 relative + 1e-5 absolute: both sides compute in f32, the blur's 625
products summed in another order on each side. Every output pixel is
written exactly once.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu_torch.nn import enhance as E  # noqa: E402
from dedark_yolo_tpu_torch.ops import enhance_kernel as TK  # noqa: E402
from chip_smoke import KERNEL_SHAPES, USM_SHAPES  # noqa: E402

SMEM_PER_BLOCK = 232_448     # H100: the most shared memory a block can use
SM_COUNT = 132
CSRC = Path(TK.__file__).resolve().parents[1] / "csrc"
STAGE_SOURCE = CSRC / "usm_tile.cuh"
FUSED_SOURCE = CSRC / "fused_enhance.cu"
# small enough to walk: the smallest side, ragged sides, two strips and two
# segments, W < SW, H < seg_rows, three strips by three segments
WALK_SHAPES = [(1, 13, 13), (2, 37, 45), (1, 64, 96), (1, 40, 50),
               (1, 20, 200), (1, 100, 150)]
PLAN_SHAPES = sorted(set(KERNEL_SHAPES) | set(USM_SHAPES) | {(1, 640, 640)}
                     | set(WALK_SHAPES))
RTOL = ATOL = 1e-5
F = np.float32


def _ids(s):
    return "x".join(map(str, s))


def reflect(i, n):
    """csrc/usm_tile.cuh `reflect`: numpy 'reflect' once, then clamped."""
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def source_constants(path):
    """{name: value} of the `constexpr int|float NAME = value;` lines."""
    return {name: (int(v) if kind == "int" else F(v))
            for kind, name, v in re.findall(
                r"^constexpr (int|float) (\w+) = ([-0-9.e]+)f?;",
                path.read_text(), re.M)}


REGRESSION = source_constants(FUSED_SOURCE)


def kernel_params(f, A, c=REGRESSION):
    """The (B, 16) parameters as csrc/fused_enhance.cu regresses them from
    the (B, 15) features f and A, with the slots and ranges `c` read from
    that source, in f32, every operation rounded on its own."""
    def tanh_range(x, name):
        return np.tanh(x) * c[f"{name}_SPAN"] / F(2) + c[f"{name}_MID"]

    wb = c["WB_SLOT"]
    s = np.exp(np.stack([tanh_range(f[:, wb] * F(0), "WB"),
                         tanh_range(f[:, wb + 1], "WB"),
                         tanh_range(f[:, wb + 2], "WB")], 1))
    lum = F(1e-5) + F(0.27) * s[:, 0] + F(0.67) * s[:, 1] + F(0.06) * s[:, 2]
    p = np.zeros((f.shape[0], 16), F)
    p[:, 0] = tanh_range(f[:, c["DEDARK_SLOT"]], "DEDARK")
    p[:, 1:4] = A
    p[:, 4:7] = s / lum[:, None]
    p[:, 7] = np.exp(tanh_range(f[:, c["GAMMA_SLOT"]], "GAMMA"))
    p[:, 8] = np.tanh(f[:, c["CONTRAST_SLOT"]])
    p[:, 9] = tanh_range(f[:, c["USM_SLOT"]], "USM")
    return p


def point_chain(img, ica, p):
    """The kernel's per-pixel chain in f32: img (..., 3), ica (...), p the
    image's 16 parameters. Returns y (3, ...). (The kernel evaluates log,
    exp, cos and the divisions with the card's fast intrinsics, which differ
    from these in the last bits only.)"""
    tx = np.maximum(F(1) - p[0] * ica, F(0.01))
    v = [np.exp(p[7] * np.log(np.maximum(
        ((img[..., c] - p[1 + c]) / tx + p[1 + c]) * p[4 + c], F(1e-4))))
        for c in range(3)]
    lum = np.clip(F(0.27) * v[0] + F(0.67) * v[1] + F(0.06) * v[2], 0, 1)
    scale = (F(1) - p[8]) + p[8] * ((-np.cos(F(np.pi) * lum) * F(0.5)
                                     + F(0.5)) / (lum + F(1e-6)))
    return np.stack([vc * scale for vc in v]).astype(F)


def walk(H, W, plan, pixel, usm_s):
    """One image through the plan: pixel(rows, cols) -> y (3, len(rows),
    len(cols)) f32 of the window pixels. Returns (out (H, W, 3), times each
    output was written)."""
    PAD, SW, RO, CO, NT = TK.PAD, TK.SW, TK.RO, TK.CO, TK.NT
    G = TK.gaussian_taps(torch.device("cpu")).numpy()
    win = RO + 2 * PAD
    ob_lanes = SW * 3
    tasks = RO * ob_lanes // CO
    q = np.arange(tasks)
    task_r, rem = q // (ob_lanes // CO), q % (ob_lanes // CO)
    task_s = rem // 3 * (CO * 3) + rem % 3
    task_lanes = task_s[:, None] + 3 * np.arange(CO)
    # the tasks cover every lane of every chunk row once
    cover = np.zeros((RO, ob_lanes), int)
    np.add.at(cover, (task_r[:, None], task_lanes), 1)
    assert (cover == 1).all() and tasks % NT == 0
    out = np.zeros((H, W, 3), F)
    written = np.zeros((H, W), int)
    t = np.arange(NT)
    sr = plan["seg_rows"]
    for by in range(plan["segments"]):
        for bx in range(plan["strips"]):
            x0, s0 = bx * SW, by * sr
            s1 = min(s0 + sr, H)
            gx = reflect(x0 - PAD + t, W)
            out_lanes = min(SW, W - x0) * 3
            yv = np.zeros((3, win, NT), F)
            yrow = np.full(win, -1)           # which image row each slot holds
            for r0 in range(s0 - 2 * PAD, s1, RO):
                yv[:, :2 * PAD] = yv[:, RO:]
                yrow[:2 * PAD] = yrow[RO:]
                rows = reflect(r0 + PAD + np.arange(RO), H)
                yv[:, 2 * PAD:] = pixel(rows, gx)
                yrow[2 * PAD:] = rows
                if r0 < s0:
                    continue
                for j in range(min(RO, s1 - r0)):   # the window of row r0 + j
                    want = reflect(r0 + j + np.arange(-PAD, PAD + 1), H)
                    assert (yrow[j:j + 2 * PAD + 1] == want).all()
                acc = np.zeros((3, RO, NT), F)
                for k in range(2 * PAD + 1):
                    acc = acc + G[k] * yv[:, k:k + RO]
                vb = acc.transpose(1, 2, 0).reshape(RO, NT * 3)   # lane t*3+c
                ob = yv[:, PAD:PAD + RO, PAD:PAD + SW].transpose(1, 2, 0) \
                    .reshape(RO, ob_lanes).copy()
                w = vb[task_r[:, None],
                       task_s[:, None] + 3 * np.arange(CO + 2 * PAD)]
                hacc = np.zeros((tasks, CO), F)
                for k in range(2 * PAD + 1):
                    hacc = hacc + G[k] * w[:, k:k + CO]
                centre = ob[task_r[:, None], task_lanes]
                ob[task_r[:, None], task_lanes] = (centre - hacc) * usm_s \
                    + centre
                for r in range(min(RO, s1 - r0)):
                    seg = ob[r, :out_lanes].reshape(-1, 3)
                    out[r0 + r, x0:x0 + len(seg)] = seg
                    written[r0 + r, x0:x0 + len(seg)] += 1
    return out, written


def _enhance_inputs(b, h, w):
    rng = np.random.default_rng([b, h, w])
    img = rng.uniform(0.02, 0.98, (b, h, w, 3)).astype(F)
    feats = rng.normal(0, 0.7, (b, 15)).astype(F)
    A = rng.uniform(0.6, 0.9, (b, 3)).astype(F)
    ica = rng.uniform(0.2, 0.8, (b, h, w, 1)).astype(F)
    return img, feats, A, ica


@pytest.mark.parametrize("mode", ["fused_enhance", "usm"])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=_ids)
def test_plan_walk_matches_reference(shape, mode):
    b, h, w = shape
    plan = TK.enhance_plan(b, h, w)
    img, feats, A, ica = _enhance_inputs(b, h, w)
    if mode == "fused_enhance":
        p = kernel_params(feats, A)
        want = TK.fused_enhance_reference(
            *map(torch.from_numpy, (img, feats, A, ica))).numpy()
        srcs = [(lambda r, c, i=i: point_chain(img[i][r[:, None], c[None]],
                                               ica[i, ..., 0][r[:, None],
                                                              c[None]], p[i]),
                 p[i, 9]) for i in range(b)]
    else:
        y = img * F(3)                   # values up to 3, like a point output
        s = np.random.default_rng(h).uniform(0, 5, (b, 1)).astype(F)
        want = TK.usm_reference(torch.from_numpy(y),
                                torch.from_numpy(s)).numpy()
        srcs = [(lambda r, c, i=i: y[i][r[:, None], c[None]].transpose(2, 0, 1),
                 s[i, 0]) for i in range(b)]
    for i, (pixel, usm_s) in enumerate(srcs):
        got, written = walk(h, w, plan, pixel, usm_s)
        assert (written == 1).all()      # every output pixel once
        np.testing.assert_allclose(got, want[i], rtol=RTOL, atol=ATOL)


def test_kernel_params_match_param_vec():
    """The kernel's own regression of the filter parameters, with the slots
    and ranges its source compiles in, is the plain `regress_filter_params`
    (as `param_vec` lays it out), to an ulp."""
    _, feats, A, _ = _enhance_inputs(5, 13, 13)
    feats[0, [1, 2, 3]] = [-30.0, 30.0, 0.0]      # saturated tanh, exp(0)
    want = TK.param_vec(torch.from_numpy(feats), torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(kernel_params(feats, A), want, rtol=2e-7,
                               atol=0)


_LOG_G = math.log(E.GAMMA_RANGE)


@pytest.mark.parametrize("name, want", [
    ("DEDARK_SLOT", E.DEDARK_SLOT), ("WB_SLOT", E.WB_SLOTS.start),
    ("GAMMA_SLOT", E.GAMMA_SLOT), ("CONTRAST_SLOT", E.CONTRAST_SLOT),
    ("USM_SLOT", E.USM_SLOT),
    ("DEDARK", E.DEFOG_RANGE), ("WB", (-E.WB_LOG_RANGE, E.WB_LOG_RANGE)),
    ("GAMMA", (-_LOG_G, _LOG_G)), ("USM", E.USM_RANGE)],
    ids=lambda v: v if isinstance(v, str) else "")
def test_regression_constants_mirror_nn_enhance(name, want):
    """Each slot and range csrc/fused_enhance.cu compiles in is the one of
    nn/enhance.py (a range as the f32 span and mid that torch's tanh_range
    scales by)."""
    if name.endswith("_SLOT"):
        assert REGRESSION[name] == want
        return
    lo, hi = want
    assert REGRESSION[f"{name}_SPAN"] == F(hi - lo)
    assert REGRESSION[f"{name}_MID"] == F((hi + lo) / 2.0)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids)
def test_plan_covers_the_image_and_fits_the_card(shape):
    B, H, W = shape
    p = TK.enhance_plan(B, H, W)
    assert p["threads"] == p["sw"] + 2 * TK.PAD == TK.NT
    assert p["threads"] % 32 == 0                  # whole warps
    assert p["seg_rows"] % p["ro"] == 0 and 2 * TK.PAD % p["ro"] == 0
    assert (p["strips"] - 1) * p["sw"] < W <= p["strips"] * p["sw"]
    assert (p["segments"] - 1) * p["seg_rows"] < H \
        <= p["segments"] * p["seg_rows"]
    assert p["grid"] == (p["strips"], p["segments"], B)
    assert p["blocks"] == p["strips"] * p["segments"] * B
    assert p["seg_rows"] >= min(TK.MIN_SEG_ROWS, H)
    assert p["smem_bytes"] == TK.smem_bytes() <= SMEM_PER_BLOCK
    if H * W >= 640 * 640:                         # the card is filled
        assert p["blocks"] >= SM_COUNT


def test_plan_at_the_main_path_shape():
    p = TK.enhance_plan(16, 640, 640)
    # nine 72-column strips (the last 64 wide), seven 96-row segments (the
    # last 64 high): 1,008 blocks, two waves of 4 blocks on 132 SMs
    assert (p["sw"], p["seg_rows"], p["grid"]) == (72, 96, (9, 7, 16))
    assert p["blocks"] <= TK.WAVES * TK.BLOCKS_PER_SM * TK.SM_COUNT
    assert p["smem_bytes"] == 8 * (96 * 3 + 72 * 3) * 4 == 16_128


@pytest.mark.parametrize("name", ["PAD", "SW", "RO", "CO"])
def test_plan_constants_mirror_the_kernel_source(name):
    """The plan's constants are the ones the stage is compiled with
    (csrc/usm_tile.cuh owns them)."""
    found = re.findall(rf"^constexpr int {name} = (\d+);",
                       STAGE_SOURCE.read_text(), re.M)
    assert len(found) == 1 and int(found[0]) == getattr(TK, name)


def test_taps_mirror_the_kernel_source():
    """The source's compiled-in taps are `gaussian_taps`, bit for bit."""
    body = re.search(r"float G\[TAPS\] = \{([^}]*)\}",
                     STAGE_SOURCE.read_text()).group(1)
    taps = np.array([F(v.strip().rstrip("f")) for v in body.split(",")])
    want = TK.gaussian_taps(torch.device("cpu")).numpy()
    assert taps.dtype == want.dtype and taps.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(1, 12, 40), (1, 40, 12), (0, 20, 20)],
                         ids=_ids)
def test_plan_rejects_what_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError):
        TK.enhance_plan(*shape)
