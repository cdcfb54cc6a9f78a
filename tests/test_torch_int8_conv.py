"""Torch port of the W8A8 3x3 conv (`ops/int8_conv.py`) and of the int8
probe, against the JAX package on the CPU: the JAX kernel in interpret mode,
as tests/test_int8_conv.py runs it, and its XLA reference, at that file's
shapes.

act=None must be bit-exact: both sides sum integers exactly and requantise
with the same f32 multiply and half-to-even rounding. For the fused SiLU the
f32 op orders differ, so at most one int8 step may differ, on under 1% of
the outputs (tests/test_int8_conv.py:71-73).
"""

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.ops.pallas import int8_conv as JI  # noqa: E402

from dedark_yolo_tpu_torch.ops import int8_conv as TI  # noqa: E402
from dedark_yolo_tpu_torch.ops import _build  # noqa: E402
from dedark_yolo_tpu_torch.tools import int8_probe  # noqa: E402

# (B, H, W, C, Co, th, seed, scale_hi): H, W unpadded; th is the JAX tiling
SHAPES = [(2, 8, 10, 128, 128, 4, 0, 1e-3), (1, 4, 6, 64, 512, 2, 0, 1e-3),
          (1, 8, 9, 64, 128, 4, 7, 1e-3), (1, 8, 10, 64, 128, 4, 3, 5e-4)]


def _inputs(B, H, W, C, Co, seed, scale_hi):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 127, (B, H + 2, W + 2, C), dtype=np.int8)
    w = rng.integers(-128, 127, (3, 3, C, Co), dtype=np.int8)
    scale = rng.uniform(1e-5, scale_hi, Co).astype(np.float32)
    return x, w, scale


def _ids(s):
    return f"{s[0]}x{s[1]}x{s[2]}x{s[3]}-{s[4]}"


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_int8_conv_matches_jax(shape, act):
    B, H, W, C, Co, th, seed, scale_hi = shape
    x, w, scale = _inputs(B, H, W, C, Co, seed, scale_hi)
    kw = dict(out_scale=0.05, act=act) if act else {}
    jx = [jnp.asarray(a) for a in (x, w, scale)]
    kernel = np.asarray(JI.conv3x3_s1_w8a8(*jx, th=th, interpret=True, **kw))
    ref = np.asarray(JI.conv3x3_s1_w8a8_reference(*jx, **kw))
    before = _build.LAUNCHES[TI.NAME]
    got = TI.conv3x3_s1_w8a8(*map(torch.from_numpy, (x, w, scale)), **kw)
    assert _build.LAUNCHES[TI.NAME] == before  # CPU tensors launch nothing
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, H, W, Co)
    got = got.numpy()
    for want in (kernel, ref):
        if act is None:
            np.testing.assert_array_equal(got, want)
        else:
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_int8_conv_saturates():
    x = torch.full((1, 6, 6, 128), 127, dtype=torch.int8)
    w = torch.full((3, 3, 128, 128), 127, dtype=torch.int8)
    out = TI.conv3x3_s1_w8a8(x, w, torch.ones(128))
    want = np.asarray(JI.conv3x3_s1_w8a8(jnp.asarray(x.numpy()),
                                         jnp.asarray(w.numpy()),
                                         jnp.ones((128,), jnp.float32), th=4,
                                         interpret=True))
    assert int(out.max()) == 127
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "w_shape", "x_rank",
                                 "scale_shape", "act"])
def test_int8_conv_rejects_bad_input(bad):
    x = torch.zeros((1, 6, 6, 32), dtype=torch.int8)
    w = torch.zeros((3, 3, 32, 8), dtype=torch.int8)
    scale, act = torch.ones(8), None
    if bad == "x_dtype":
        x = x.float()
    elif bad == "w_dtype":
        w = w.to(torch.int32)
    elif bad == "w_shape":
        w = torch.zeros((5, 5, 32, 8), dtype=torch.int8)
    elif bad == "x_rank":
        x = x[0]
    elif bad == "scale_shape":
        scale = torch.ones(16)
    else:
        act = "relu"
    with pytest.raises(ValueError):
        TI.conv3x3_s1_w8a8(x, w, scale, act=act)


def test_int8_probe_runs_on_cpu(capsys):
    res = int8_probe.main(["--layers", "2", "--batch", "1", "--hw", "8",
                           "--ch", "32", "--iters", "1", "--device", "cpu"])
    assert res["device"] == "cpu" and res["int8_calls"] == (1 + 2) * 2
    assert [r["chain"] for r in res["rows"]] == ["bf16", "int8"]
    for r in res["rows"]:
        assert r["ms"] > 0 and r["peak_pct"] is None
    assert "not measured" in capsys.readouterr().out


def test_layer_inputs_draw_and_channel_scales():
    """The probe's seeded layer draw, and per-channel scales that differ
    from channel to channel around the probe's one scale."""
    shape = (1, 4, 6, 64, 24)
    x, w, s = int8_probe.layer_inputs(*shape, "cpu")
    x2, w2, s2 = int8_probe.layer_inputs(*shape, "cpu", channel_scales=True)
    assert x.shape == (1, 6, 8, 64) and w.shape == (3, 3, 64, 24)
    assert x.dtype == w.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(x, x2) and torch.equal(w, w2)
    assert (s == np.float32(int8_probe.requant_scale(64))).all()
    r = s2 / s
    assert 0.5 <= float(r.min()) and float(r.max()) < 2.0
    assert len(torch.unique(s2)) == 24
