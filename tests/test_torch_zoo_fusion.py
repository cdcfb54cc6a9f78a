"""Torch port vs the JAX package: the zoo's multi-level blocks and the
AsffDetect head (CPU, f32), held as tests/test_torch_zoo_blocks.py holds
the zoo's blocks (eval and train outputs, BN stats and gradients, RTOL =
ATOL = 1e-5).

Widths [P5, P4, P3] of (32, 16, 8) have scale n's ratios (256, 128, 64)
and s's: level 0 aligns the pooled P4 and level 1 the P5 with a 1x1
AddConv, built first in the flax order; (16, 16, 8) are l's and x's
ratios, where neither exists. MFRU aligns P4 to P5's width where they
differ.
"""

import math

import pytest

pytest.importorskip("torch")

from dedark_yolo_tpu.nn import heads as JH  # noqa: E402
from dedark_yolo_tpu.nn import layers as JL  # noqa: E402

from dedark_yolo_tpu_torch.nn import heads as TH  # noqa: E402
from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402

from test_torch_zoo_blocks import _x, check_block, few_threads  # noqa: E402,F401


def _levels(widths, top=4):
    """[P5, P4, P3, ...] NHWC maps of the given widths, P5 top x top."""
    return [_x((2, top * 2 ** k, top * 2 ** k, c), k + 1)
            for k, c in enumerate(widths)]


def test_rfb_block():
    check_block(JL.RFBblock(), TL.RFBblock(16), "RFBblock", _x((2, 9, 8, 16)))


@pytest.mark.parametrize("dims", [(32, 16, 8), (16, 16, 8), (24, 24, 16)],
                         ids=["unequal", "equal", "equal-x"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_asff_tribe_level(level, dims):
    m = TL.AsffTribeLevel(level, dims)
    if level < 2:
        assert hasattr(m, f"align_level_{1 - level}") == (dims[0] != dims[1])
    check_block(JL.AsffTribeLevel(level=level), m, "AsffTribeLevel",
                _levels(dims), args=(level,), dims=dims)


@pytest.mark.parametrize("level", [0, 1])
def test_asff_doub_level(level):
    dims = (32, 16)
    check_block(JL.AsffDoubLevel(level=level), TL.AsffDoubLevel(level, dims),
                "AsffDoubLevel", _levels(dims), args=(level,), dims=dims)


@pytest.mark.parametrize("dims", [(32, 16, 16), (32, 32, 16)],
                         ids=["align", "no-align"])
def test_mfru(dims):
    m = TL.MFRU(dims)
    assert hasattr(m, "align_level_1") == (dims[0] != dims[1])
    check_block(JL.MFRU(), m, "MFRU", _levels(dims, top=2), dims=dims)


@pytest.mark.parametrize("strides", [(8, 16), (8, 16, 32)])
def test_asff_detect(strides):
    """One biased 1x1 a branch and level, the Detect biases (box 1.0, cls
    log(5 / nc / (640 / s)^2)) from the port's init."""
    ch = (16, 32, 32)[:len(strides)]
    xs = [_x((2, 16 // 2 ** k, 12 // 2 ** k, c), k + 1)
          for k, c in enumerate(ch)]
    m = TH.AsffDetect(3, ch, strides)
    m.bias_init()
    for k, s in enumerate(strides):
        assert float(m.cv2[k][0].bias[0].detach()) == 1.0
        assert float(m.cv3[k][0].bias[0].detach()) == pytest.approx(
            math.log(5 / 3 / (640 / s) ** 2))
    check_block(JH.AsffDetect(nc=3, strides=strides), m, "AsffDetect", xs,
                head=True)
