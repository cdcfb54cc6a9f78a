"""The launch plan of the W8A8 conv kernel (`ops/int8_conv.py::kernel_plan`)
on the CPU, before any card: its numbers meet TMA's and wgmma's rules, and a
numpy walk of it — every tile's input halo and weight blocks gathered as the
kernel's TMA boxes with their zero fill, each tap's A operand read from the
halo through the wgmma descriptor's rows and group stride, multiplied,
summed in int64 and requantised as the kernel's epilogue does — equals the
plain conv.

act=None must be bit-exact against `conv3x3_s1_w8a8_reference` (and the JAX
reference); for the fused SiLU the walk's f32 op order (a multiply by
1/out_scale) differs from the reference's division, so at most one int8 step
may differ, on under 1% of the outputs, the JAX package's own bar
(tests/test_int8_conv.py:71-73).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.ops.pallas import int8_conv as JI  # noqa: E402

from dedark_yolo_tpu_torch.ops import int8_conv as TI  # noqa: E402
from chip_smoke import INT8_SHAPES  # noqa: E402

SMEM_PER_SM = 233_472        # H100: shared memory of an SM, of which
SMEM_RESERVED = 1024         # the system reserves this much for each block
# (B, H, W, C, Co): the probe's layer and the card's int8 phase shapes, one
# shape for each K block (C = 32, 96 -> BK 32; 64 -> 64; 128, 256 -> 128)
PLAN_SHAPES = sorted(set(INT8_SHAPES) | {(1, 7, 13, 32, 40),
                                         (2, 9, 21, 96, 136)})
# small enough to walk in numpy: the JAX test shapes, odd and ragged ones
WALK_SHAPES = [(2, 8, 10, 128, 128), (1, 4, 6, 64, 512), (1, 10, 12, 64, 128),
               (1, 9, 11, 64, 128), (1, 7, 13, 32, 40), (2, 9, 21, 96, 136)]


KERNEL_SOURCE = (Path(TI.__file__).resolve().parents[1] / "csrc"
                 / "int8_conv.cu")


def _ids(s):
    return "x".join(map(str, s))


def _inputs(B, H, W, C, Co, seed=0):
    rng = np.random.default_rng([seed, B, H, W, C, Co])
    x = rng.integers(-128, 127, (B, H + 2, W + 2, C), dtype=np.int8)
    w = rng.integers(-128, 127, (3, 3, C, Co), dtype=np.int8)
    scale = rng.uniform(1e-5, 1e-3, Co).astype(np.float32)
    return x, w, scale


def tma_box(arr, coords, box):
    """What a TMA tile load writes to shared memory: the box of `arr` at
    `coords`, both innermost first as in a tensor map, zero outside `arr`."""
    coords, box = coords[::-1], box[::-1]
    out = np.zeros(box, arr.dtype)
    src, dst = [], []
    for c, n, size in zip(coords, box, arr.shape):
        lo, hi = max(c, 0), min(c + n, size)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - c, hi - c))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def silu_floor(inv_out):
    """The kernel's floor on y before its SiLU (csrc/int8_conv.cu)."""
    return np.float32(-20.0 if inv_out < 1e6 else -np.inf)


def walk(x, w, scale, out_scale, act, plan):
    """The kernel's arithmetic in numpy, tile by tile in blockIdx order."""
    B, Hp, Wp, C = x.shape
    H, W, Co = Hp - 2, Wp - 2, w.shape[3]
    wt = np.ascontiguousarray(w.transpose(3, 0, 1, 2).reshape(Co, 9 * C))
    assert x.shape[::-1] == plan["x_dims"] and wt.shape[::-1] == plan["w_dims"]
    assert x.strides[::-1][1:] == plan["x_strides"]
    assert wt.strides[::-1][1:] == plan["w_strides"]
    bk, bn, th, tw = plan["bk"], plan["bn"], plan["th"], plan["tw"]
    out = np.zeros((B, H, W, Co), np.int8)
    written = np.zeros(out.shape, np.int32)
    inv_out = np.float32(1.0 / out_scale)
    # wgmma row m of the tile: warpgroup m // 64, 8-row group m // 8 % 8,
    # row m % 8 of the group; the group's first row is a halo row
    wg, grp, row = np.arange(64 * 2) // 64, np.arange(128) // 8 % 8, \
        np.arange(128) % 8
    step = plan["a_group_stride"] // bk       # halo rows between groups
    for bid in range(plan["blocks"]):
        n0 = bid % plan["tiles_n"] * bn
        m_tile = bid // plan["tiles_n"]
        x0 = m_tile % plan["tiles_x"] * tw
        y0 = m_tile // plan["tiles_x"] % plan["tiles_y"] * th
        b = m_tile // (plan["tiles_x"] * plan["tiles_y"])
        acc = np.zeros((plan["bm"], bn), np.int64)
        for cb in range(plan["c_blocks"]):
            c0 = cb * bk
            # the halo in shared memory: one bk-byte row per box pixel
            halo = tma_box(x, (c0, x0, y0, b), plan["x_box"]).reshape(-1, bk)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                start = (wg * 8 + dy) * (tw + 2) + dx   # descriptor start
                a = halo[start + grp * step + row]
                bt = tma_box(wt, (tap * C + c0, n0), plan["w_box"])
                acc += a.astype(np.int64) @ bt.T.astype(np.int64)
        # epilogue: row r = ty*tw + tx; pixels inside H x W, channels < Co
        ty, tx = np.divmod(np.arange(plan["bm"]), tw)
        rows = (y0 + ty < H) & (x0 + tx < W)
        cols = np.arange(n0, min(n0 + bn, Co))
        y = acc[rows][:, : len(cols)].astype(np.float32) * scale[cols]
        if act == "silu":
            y = np.maximum(y, silu_floor(inv_out))
            y = y * (np.float32(1) / (np.float32(1) + np.exp(-y)))
            y = y * inv_out
        q = np.clip(np.rint(y), -128, 127).astype(np.int8)
        out[b, (y0 + ty)[rows][:, None], (x0 + tx)[rows][:, None],
            cols[None, :]] = q
        written[b, (y0 + ty)[rows][:, None], (x0 + tx)[rows][:, None],
                cols[None, :]] += 1
    assert (written == 1).all()       # every output written exactly once
    return out


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids)
def test_kernel_plan_meets_tma_and_wgmma_rules(shape):
    B, H, W, C, Co = shape
    p = TI.kernel_plan(*shape)
    bk = p["bk"]
    assert bk in (32, 64, 128) and C % bk == 0
    assert bk == (128 if C % 128 == 0 else 64 if C % 64 == 0 else 32)
    assert p["swizzle_bytes"] == bk                 # one box row per span
    assert p["x_box"][0] == p["w_box"][0] == bk     # innermost box bytes
    assert p["x_box"][1:] == (p["tw"] + 2, p["th"] + 2, 1)  # the halo
    assert all(1 <= d <= 256 for d in p["x_box"] + p["w_box"])
    assert all(s % 16 == 0 for s in p["x_strides"] + p["w_strides"])
    # 64 rows a warpgroup, one 8-row wgmma group per halo row of tw pixels
    assert p["th"] * p["tw"] == p["bm"] == 128 and p["tw"] == 8
    assert p["a_group_stride"] == (p["tw"] + 2) * bk
    assert p["a_group_stride"] % 16 == 0 and p["a_group_stride"] >> 4 < 2**14
    assert p["bn"] == 128
    assert p["c_blocks"] * bk == C
    assert 2 <= p["stages"] <= TI.MAX_STAGES
    assert p["halo_bytes"] == (p["th"] + 2) * (p["tw"] + 2) * bk
    assert p["stage_bytes"] == p["bn"] * bk
    # every box starts on the 128-byte swizzle's 1024 B: halos are rounded up
    halo = -(-p["halo_bytes"] // 1024) * 1024
    assert p["bn"] * bk % 1024 == 0
    assert 2 * halo + p["stages"] * p["stage_bytes"] + 1024 <= p["smem_bytes"]
    assert p["epilogue_bytes"] == p["bm"] * (p["bn"] + 8) * 4   # int32 tile
    assert p["epilogue_bytes"] + 1024 <= p["smem_bytes"]
    # two blocks fit on an SM
    assert 2 * (p["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    # the grid covers every output pixel and channel, without a spare tile
    assert p["blocks"] == B * p["tiles_y"] * p["tiles_x"] * p["tiles_n"]
    assert (p["tiles_y"] - 1) * p["th"] < H <= p["tiles_y"] * p["th"]
    assert (p["tiles_x"] - 1) * p["tw"] < W <= p["tiles_x"] * p["tw"]
    assert (p["tiles_n"] - 1) * p["bn"] < Co <= p["tiles_n"] * p["bn"]
    assert p["blocks"] < 2 ** 31
    assert p["x_dims"] == (C, W + 2, H + 2, B) and p["w_dims"] == (9 * C, Co)


def test_kernel_plan_probe_shape():
    p = TI.kernel_plan(32, 80, 80, 256, 256)
    # 80 x 80 tiles exactly; two 128-deep channel blocks, two N tiles
    assert (p["bk"], p["bn"], p["th"], p["tw"]) == (128, 128, 16, 8)
    assert p["blocks"] == 32 * 5 * 10 * 2 and p["c_blocks"] == 2
    # two 23,040-byte halos (23,552 aligned) and four 16 KB weight stages
    assert p["stages"] == 4
    assert p["smem_bytes"] == 1024 + 2 * 23552 + 4 * 16384 + 4 * 16 + 32


@pytest.mark.parametrize("name", ["TH", "TW", "BN", "MAX_STAGES",
                                  "SMEM_LIMIT"])
def test_plan_constants_mirror_the_kernel_source(name):
    """The plan's tile, ring and shared-memory constants are the ones the
    kernel is compiled with (csrc/int8_conv.cu owns them)."""
    found = re.findall(rf"^constexpr int (?:\w+ = \d+, )*{name} = (\d+)",
                       KERNEL_SOURCE.read_text(), re.M)
    assert len(found) == 1 and int(found[0]) == getattr(TI, name)


@pytest.mark.parametrize("shape", [(1, 4, 4, 48, 64), (1, 4, 4, 64, 12)],
                         ids=["C48", "Co12"])
def test_kernel_plan_rejects_unaligned_channels(shape):
    with pytest.raises(ValueError):
        TI.kernel_plan(*shape)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=_ids)
def test_plan_walk_matches_reference(shape, act):
    x, w, scale = _inputs(*shape)
    kw = dict(out_scale=0.05, act=act) if act else {}
    got = walk(x, w, scale, kw.get("out_scale", 1.0), act,
               TI.kernel_plan(*shape))
    ref = TI.conv3x3_s1_w8a8_reference(
        *map(torch.from_numpy, (x, w, scale)), **kw).numpy()
    if act is None:
        np.testing.assert_array_equal(got, ref)
        jref = JI.conv3x3_s1_w8a8_reference(*map(jnp.asarray, (x, w, scale)))
        np.testing.assert_array_equal(got, np.asarray(jref))
    else:
        d = np.abs(got.astype(int) - ref.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("inv_out", [1.0, 20.0, 1e3, 999_999.0])
def test_silu_floor_changes_no_output(inv_out):
    """For y <= -20, |silu(y)| <= 20 e^-20 = 4.2e-8, so q(silu(y) * inv_out)
    is 0 whether y is floored at -20 or not while inv_out < 1e6; the floor
    keeps e^-y finite. Checked in f32 on every y in [-200, 0] at 1/64 steps
    and on the f32 extremes."""
    y = np.concatenate([np.arange(-200 * 64, 1, dtype=np.float32) / 64,
                        np.float32([-3.4e38, -1e30, -88.8, -20.0001])])
    inv = np.float32(inv_out)

    def q(v):
        with np.errstate(over="ignore", invalid="ignore"):
            s = np.float32(1) / (np.float32(1) + np.exp(-v))
        return np.clip(np.rint(v * s * inv), -128, 127).astype(np.int8)

    np.testing.assert_array_equal(q(np.maximum(y, silu_floor(inv_out))), q(y))
