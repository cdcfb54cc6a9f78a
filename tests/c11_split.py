"""Split of ROADMAP C11 (bf16 training's gap to JAX's bf16) by seed, on the
CPU: the ratios of tests/test_torch_amp.py's `_quantities` (the port's gap
to JAX's bf16 over JAX's bf16 gap to its f32) for variants of the port's
step, each on the same weights and batch.

    base     the port as it is
    inject   layer 0's output replaced by JAX's bf16 layer-0 output of the
             same step (recorded from `fused_enhance_diff`), the gradient
             passed through unchanged: what is left is the blocks'
    reg16    the plain chain regresses the filter parameters in bf16 with
             each Python constant rounded to bf16 first, as jnp does with a
             weak-typed scalar beside a bf16 array (JAX
             ops/pallas/enhance_kernel.py:210 calls the regression on the
             bf16 features)

    JAX_PLATFORMS=cpu python tests/c11_split.py 0,1,2,3,4 base,inject,reg16

Not collected by pytest (no test_ prefix); about 30 s for all seeds.
"""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dedark_yolo_tpu.ops.pallas import enhance_kernel as jax_kernel  # noqa: E402
from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn import enhance as E  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.ops import enhance_kernel as port_kernel  # noqa: E402

from test_torch_amp import (NB, OVERRIDES, TINY, _batch, _Jax,  # noqa: E402
                            _port_step, _quantities)
from test_torch_layers import randomize, to_plain  # noqa: E402


def weak(v, x):
    """Python constant v as jnp meets it beside x: rounded to bf16."""
    if x.dtype == torch.bfloat16:
        return float(torch.tensor(v, dtype=torch.bfloat16))
    return v


def tanh_range16(x, lo, hi):
    return torch.tanh(x) * weak(hi - lo, x) / 2.0 + weak((hi + lo) / 2.0, x)


def regress16(f):
    """`nn.enhance.regress_filter_params` with jnp's weak constants."""
    wb = torch.cat([f[:, E.WB_SLOTS.start:E.WB_SLOTS.start + 1] * 0.0,
                    f[:, E.WB_SLOTS.start + 1:E.WB_SLOTS.stop]], dim=1)
    scale = torch.exp(tanh_range16(wb, -E.WB_LOG_RANGE, E.WB_LOG_RANGE))
    lum = (weak(1e-5, f) + weak(0.27, f) * scale[:, 0]
           + weak(0.67, f) * scale[:, 1] + weak(0.06, f) * scale[:, 2])
    log_g = math.log(E.GAMMA_RANGE)
    return {"dedark_w": tanh_range16(f[:, E.DEDARK_SLOT:E.DEDARK_SLOT + 1],
                                     *E.DEFOG_RANGE),
            "wb": scale / lum[:, None],
            "gamma": torch.exp(tanh_range16(
                f[:, E.GAMMA_SLOT:E.GAMMA_SLOT + 1], -log_g, log_g)),
            "contrast": torch.tanh(f[:, E.CONTRAST_SLOT:E.CONTRAST_SLOT + 1]),
            "usm": tanh_range16(f[:, E.USM_SLOT:E.USM_SLOT + 1], *E.USM_RANGE)}


def reference16(img, features, dedark_A, IcA):
    p = {k: v.float() for k, v in regress16(features).items()}
    x = E.apply_point_filters(img.float(), p, dedark_A.float(), IcA.float())
    return E.usm_filter(x, p["usm"]).to(img.dtype)


class Inject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, j):
        return j.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def main(seeds, variants):
    rec = []
    diff = jax_kernel.fused_enhance_diff

    def recorded(*args, **kwargs):
        out = diff(*args, **kwargs)
        jax.debug.callback(lambda x: rec.append(np.asarray(x)), out)
        return out
    jax_kernel.fused_enhance_diff = recorded
    side = _Jax()
    sched = DetectionTrainer({**OVERRIDES, "amp": True},
                             model=DetectionModel(model_yaml_load(TINY), nc=3),
                             nb=NB, device="cpu")
    forward, plain = E.LowlightRecovery.forward, port_kernel.fused_enhance_reference
    for s in seeds:
        v = to_plain(randomize(side.template,
                               np.random.default_rng(100 + s if s else 0)))
        batch = _batch(10 * s)
        rec.clear()
        j16 = side.step(v, batch, True, sched)
        layer0 = torch.from_numpy(rec[-1].astype(np.float32))
        j32 = side.step(v, batch, False, sched)
        for var in variants:
            E.LowlightRecovery.forward = forward
            port_kernel.fused_enhance_reference = plain
            if var == "inject":
                def injected(self, x, dedark_A=None, IcA=None):
                    y = forward(self, x, dedark_A, IcA)
                    return Inject.apply(y, layer0.to(y.dtype))
                E.LowlightRecovery.forward = injected
            elif var == "reg16":
                port_kernel.fused_enhance_reference = reference16
            start, _, port = _port_step(v, batch)
            q = _quantities({"start": start, "port": port, "j16": j16,
                             "j32": j32})
            print(f"seed {s} {var}: " + "; ".join(
                f"{k.split(' (')[0]} {a / b:.3f} ({a:.4g}/{b:.4g})"
                for k, (a, b) in q.items()), flush=True)
    E.LowlightRecovery.forward = forward
    port_kernel.fused_enhance_reference = plain


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1].split(",")], sys.argv[2].split(","))
