"""Torch port vs the JAX package: one accumulation window of the train
step on zoo architectures (CPU, f32), as tests/test_torch_train_slice.py
holds the tiny model's: `DetectionTrainer.step` against the JAX tree-path
train_step, two micro-steps of batch 2 at imgsz 64 (nbs 4), SGD inside the
warmup ramp, shared numpy-seeded weights. `yolov8n-mfru-rbf-asff` runs the
align convs, SCConv/CRU, RFB and MFRU's modules applied twice;
`yolov8n-faster-twohead` PConv, AsffDoubLevel and the AsffDetect head on
two levels.

Bars, the train slice's (lines 116-138 there): loss items and total 3e-5
relative; BN running stats and their EMA 2e-6 absolute; the momentum
buffers (the window's summed gradients) 2e-3 of each tensor's largest
entry; the updated parameters and EMA 1e-6 plus half of that share of the
tensor's largest move.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    opt_state_from_jax, state_dict_from_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401
from test_torch_train_slice import (IMGSZ, NB, STEPS, _batches,  # noqa: E402
                                    _jax_trainer, close)


@pytest.mark.parametrize("name", ["yolov8n-mfru-rbf-asff.yaml",
                                  "yolov8n-faster-twohead.yaml"])
def test_train_window_matches_jax(name):
    overrides = {"batch": 2, "nbs": 4, "epochs": 10, "imgsz": IMGSZ,
                 "optimizer": "SGD", "lr0": 0.02}
    jm = JaxModel(jax_yaml_load(name), nc=3)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3),
                                                   jnp.float32))
    v = to_plain(randomize(template, np.random.default_rng(0)))
    jt = _jax_trainer(overrides)
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = v["params"], v["batch_stats"]
    jopt = jax_init_opt(jp)
    jema = {"params": jax_ema_init(jp), "batch_stats": jax_ema_init(jbs)}
    jeu = jnp.int32(0)

    tm = DetectionModel(model_yaml_load(name), nc=3)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    tt = DetectionTrainer(overrides, model=tm, nb=NB, device="cpu")
    for i, batch in zip(STEPS, _batches()):
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu,
            {k: jnp.asarray(a) for k, a in batch.items()},
            jnp.float32(jt._lr_at(i, "bias")), jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        total, items = tt.step(batch, i)
        np.testing.assert_allclose(items.numpy(), np.stack(jitems), rtol=3e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=3e-5)
    assert tt.opt_state.step == int(jopt.step) == 1 and tt.ema_updates == 1

    want = state_dict_from_jax({"params": jp, "batch_stats": jbs}, tm)
    want_ema = state_dict_from_jax(jema, tm)
    start = state_dict_from_jax(v, tm)
    jbuf = opt_state_from_jax(jopt, tm)
    got = tm.state_dict()
    assert sum(not torch.equal(w, start[k]) for k, w in want.items()) \
        > 0.9 * len(want)
    for k, w in want.items():
        if "running_" in k:
            close(got[k], w, 2e-6, k)
            close(tt.ema[k], want_ema[k], 2e-6, k)
            continue
        if jbuf.buf[k].abs().max() > 0:
            close(tt.opt_state.buf[k], jbuf.buf[k],
                  2e-3 * float(jbuf.buf[k].abs().max()), k)
        tol = 1e-6 + 1e-3 * float((w - start[k]).abs().max())
        close(got[k], w, tol, k)
        close(tt.ema[k], want_ema[k], tol, k)


@pytest.mark.parametrize("name", ["yolov8n-mfru-rbf-asff.yaml",
                                  "yolov8n-faster-twohead.yaml"])
def test_amp_step_runs(name):
    """amp=True (bf16) on zoo models: a window of two micro-steps runs, its
    loss items finite, the masters and BN stats left f32 (bf16 parity with
    JAX's bf16 is not held here)."""
    tm = DetectionModel(model_yaml_load(name), nc=3)
    from dedark_yolo_tpu_torch.utils.weights import init_weights
    init_weights(tm, 0)
    tt = DetectionTrainer({"batch": 2, "nbs": 4, "imgsz": IMGSZ, "amp": True},
                          model=tm, nb=NB, device="cpu")
    for i, batch in zip(STEPS, _batches()):
        total, items = tt.step(batch, i)
        assert torch.isfinite(items).all() and torch.isfinite(total)
    assert tt.opt_state.step == 1
    assert all(t.dtype == torch.float32 for t in tm.state_dict().values())


def test_cli_trains_a_variant(tmp_path, capsys):
    """`python -m dedark_yolo_tpu_torch train model=yolov8n-p6.yaml` for an
    epoch on a synth dataset: its checkpoint carries the architecture
    (four levels, strides to 64) into YOLO(best.npz), which predicts."""
    import json
    from pathlib import Path
    import yaml
    from dedark_yolo_tpu_torch import YOLO
    from dedark_yolo_tpu_torch import __main__ as cli
    from synth import make_synth_dataset
    data = yaml.safe_load(Path(make_synth_dataset(
        tmp_path / "ds", n_train=4, n_val=4, imgsz=IMGSZ)).read_text())
    data_json = tmp_path / "ds" / "data.json"
    data_json.write_text(json.dumps(data))
    rc = cli.entrypoint(["train", "model=yolov8n-p6.yaml", f"data={data_json}",
                         "epochs=1", f"imgsz={IMGSZ}", "batch=2", "nbs=2",
                         "workers=0", "mosaic=0.0", "max_boxes=8",
                         "max_det=20", "max_nms=256", "device=cpu",
                         f"project={tmp_path / 'runs'}", "name=p6",
                         "plots=False"])
    assert rc == 0
    assert "metrics/mAP50(B)" in capsys.readouterr().out
    best = YOLO(str(tmp_path / "runs" / "p6" / "weights" / "best.npz"),
                device="cpu")
    assert tuple(best.model.strides) == (8, 16, 32, 64) and best.model.nc == 3
    assert best.model.yaml["head"][-1] == [[20, 23, 26, 29], 1, "Detect",
                                           ["nc"]]
    res = best.predict(str(Path(data["path"]) / "images" / "val"),
                       imgsz=IMGSZ, conf=0.001, max_det=20, max_nms=256,
                       device="cpu")
    assert len(res) == 4
