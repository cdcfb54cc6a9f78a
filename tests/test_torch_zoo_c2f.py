"""Torch port vs the JAX package: C2f's bottleneck families (CPU, f32),
held as tests/test_torch_zoo_blocks.py holds the zoo's blocks (eval and
train outputs, BN stats and gradients, RTOL = ATOL = 1e-5)."""

import pytest

pytest.importorskip("torch")

from dedark_yolo_tpu.nn import layers as JL  # noqa: E402

from dedark_yolo_tpu_torch.nn import layers as TL  # noqa: E402

from test_torch_zoo_blocks import _x, check_block, few_threads  # noqa: E402,F401

C2F_FAMILY = {"FasterC2f": "pconv", "FasterC2f_N": "pconv_n", "SCC2f": "scconv",
              "SC_PW_C2f": "sc_pw", "SC_Conv3_C2f": "sc_conv3",
              "Conv3_SC_C2f": "conv3_sc", "SC_PW_PW_C2f": "sc_pw_pw"}


@pytest.mark.parametrize("name", list(C2F_FAMILY))
def test_c2f_family(name):
    """The yaml names of C2f's bottleneck families, n=2, 12 -> 32, with the
    bottlenecks' shortcut (the backbone's form; the FPN's C2fs drop it)."""
    kind = C2F_FAMILY[name]
    check_block(JL.C2f(c2=32, n=2, shortcut=True, bottleneck=kind),
                TL.C2f(12, 32, 2, True, kind), name, _x((2, 8, 7, 12)))
