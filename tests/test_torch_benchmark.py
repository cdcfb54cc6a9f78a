"""The port's precision x batch benchmark (dedark_yolo_tpu_torch/engine/
benchmarks.py, `YOLO.benchmark`, the CLI's `benchmark`) on the CPU,
tests/tiny_model.yaml from one JAX checkpoint.

- The fp32 benchmark step (u8 -> f32, the graph, decode, NMS at conf 0.25
  and iou 0.45) is the predictor's step at those thresholds, bit for bit.
- The bf16 step computes JAX's bf16 row (every float parameter cast to
  bf16, BN statistics f32, the image u8 / 255 in bf16): its decoded boxes
  and scores are no farther from JAX's bf16 ones than JAX's bf16 are from
  JAX's f32 (tests/test_torch_amp.py's yardstick), by norm. As there, the
  JAX model runs layer 0 as `enhance_impl='pallas'` (interpret mode), the
  kernel the port's `FusedEnhance` counterparts: f32 arithmetic on the
  bf16 image, where JAX's default XLA chain rounds every op to bf16.
- The rows: JAX's keys, fp32 then bf16 at each batch size, a val row with
  `data`; a row that raises becomes an "error" row; formats= raises
  naming A12; the CLI prints the rows.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.engine import benchmarks as jax_benchmarks  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.nn.heads import decode_detections  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg  # noqa: E402
from dedark_yolo_tpu_torch.engine import benchmarks  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_torch_val import TINY, tiny_variables  # noqa: E402

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX model, flax variables, checkpoint path)."""
    jm, v = tiny_variables(seed=0)
    path = save_checkpoint(
        tmp_path_factory.mktemp("bench") / "tiny.npz", params=v["params"],
        batch_stats=v["batch_stats"], train_args={"imgsz": IMGSZ},
        model_yaml=jm.yaml)
    return jm, v, str(path)


def images(b, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (b, IMGSZ, IMGSZ, 3),
                                                dtype=np.uint8)


def test_fp32_step_is_the_predictors(tiny):
    _, _, npz = tiny
    model = YOLO(npz, device="cpu").model.eval()
    u8 = images(3)
    dets, counts = benchmarks.bench_step(model, None, torch.from_numpy(u8),
                                         torch.float32)
    pred = DetectionPredictor(
        args=get_cfg({"conf": benchmarks.NMS_CONF, "iou": benchmarks.NMS_IOU,
                      "device": "cpu", "imgsz": IMGSZ}),
        model=model, save_dir=".")
    out = pred.step(u8)
    assert int(counts.sum()) > 0
    assert torch.equal(dets, out["dets"]) and torch.equal(counts, out["counts"])


def jax_decoded(jm, v, u8, dtype):
    """JAX's benchmark step up to the decode (benchmarks.py:26-46)."""
    params = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.dtype in (jnp.float32, jnp.bfloat16)
        else x, v["params"])
    img = jnp.asarray(u8).astype(dtype) / 255.0
    raw = jm.module.apply({"params": params, "batch_stats": v["batch_stats"]},
                          img, train=False)
    b, s = decode_detections(raw, jm.nc, jm.strides, jm.reg_max)
    return (np.asarray(b.astype(jnp.float32)),
            np.asarray(s.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_step_within_jax_bf16_gap(tiny, seed):
    _, v, npz = tiny
    jm = JaxModel(jax_yaml_load(TINY), nc=3, enhance_impl="pallas")
    u8 = images(2, seed)
    j32 = jax_decoded(jm, v, u8, jnp.float32)
    j16 = jax_decoded(jm, v, u8, jnp.bfloat16)
    model = YOLO(npz, device="cpu").model.eval()
    params = benchmarks.bf16_params(model)
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    with torch.inference_mode():
        img = torch.from_numpy(u8).to(torch.bfloat16) / 255.0
        raw = torch.func.functional_call(model, params, (img,))
        mine = [t.float().numpy() for t in model.decode(raw)]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for name, m, a, b in zip(("boxes", "scores"), mine, j16, j32):
        gap, yard = rel(m, a), rel(a, b)
        print(f"{name}: port bf16 vs JAX bf16 {gap:.3g}, "
              f"JAX bf16 vs f32 {yard:.3g}")
        assert gap <= yard, name


def test_rows_match_jax_keys(tiny):
    _, _, npz = tiny
    kw = dict(imgsz=IMGSZ, batch_sizes=(1, 2), warmup=1, iters=2)
    want = jax_benchmarks.benchmark(JaxYOLO(npz), **kw)
    got = YOLO(npz, device="cpu").benchmark(**kw)
    assert [(r["precision"], r["batch"]) for r in got] == \
        [(r["precision"], r["batch"]) for r in want] == \
        [("fp32", 1), ("fp32", 2), ("bf16", 1), ("bf16", 2)]
    for g, w in zip(got, want):
        assert set(g) == set(w) and "error" not in g
        assert g["img_per_sec"] > 0
        # both rounded (img/s to 0.01, ms to 0.001): ms is 1000 / img/s
        # within what the two roundings allow
        ips = g["img_per_sec"]
        assert abs(g["ms_per_img"] - 1000 / ips) <= 5e-4 + 5.0 / (ips - 5e-3) ** 2


def test_data_row_error_row_and_formats(tiny, tmp_path, monkeypatch):
    _, _, npz = tiny
    data = make_synth_dataset(tmp_path / "ds", n_train=0, n_val=4,
                              imgsz=IMGSZ)
    m = YOLO(npz, device="cpu")
    rows = m.benchmark(imgsz=IMGSZ, batch_sizes=(2,), warmup=1, iters=1,
                       data=str(data), batch=2, workers=0, plots=False,
                       verbose=False, device="cpu")
    assert [set(r) for r in rows[:2]] == [
        {"precision", "batch", "img_per_sec", "ms_per_img"}] * 2
    assert set(rows[2]) == {"mAP50-95"} and rows[2]["mAP50-95"] >= 0
    step = benchmarks.bench_step

    def failing(model, params, img, dtype):
        if dtype == torch.bfloat16:
            raise RuntimeError("no bf16 here")
        return step(model, params, img, dtype)
    monkeypatch.setattr(benchmarks, "bench_step", failing)
    rows = m.benchmark(imgsz=IMGSZ, batch_sizes=(1,), warmup=1, iters=1)
    assert "error" not in rows[0]
    assert rows[1] == {"precision": "bf16", "batch": 1,
                       "error": "no bf16 here"}
    with pytest.raises(NotImplementedError, match="A12"):
        m.benchmark(formats=True)


def test_cli_benchmark(tiny, capsys):
    _, _, npz = tiny
    rc = cli.entrypoint(["benchmark", f"model={npz}", "device=cpu",
                         f"imgsz={IMGSZ}", "batch_sizes=[1]", "iters=1"])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("results ")][-1]
    rows = json.loads(line[len("results "):])
    assert [(r["precision"], r["batch"]) for r in rows] == [("fp32", 1),
                                                           ("bf16", 1)]
    assert cli.entrypoint(["benchmark", f"model={npz}", "device=cpu",
                           "formats=True"]) == 1
