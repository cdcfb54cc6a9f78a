"""The port's dynamic-batching InferenceServer (dedark_yolo_tpu_torch/
engine/server.py) on the CPU, tests/tiny_model.yaml at imgsz 96 from one
JAX checkpoint of seeded weights.

- Responses: bit-equal to the port's `YOLO.predict` at batch=max_batch
  (the server's batches are the predictor's: a full batch, then a short
  one padded with its first frame), and paired (tests/pairing.py) with the
  JAX package's InferenceServer on the same checkpoint and frames under
  the predict bars (2e-4 px, scores 1e-6).
- Behaviour: coalescing and the stats counters, the p50/p95 formulas
  against JAX's, a malformed request failing only its own future,
  close() failing what is queued, submit after close, no card without
  device='cpu', the HTTP front-end (/healthz, /stats, POST /predict with a
  PNG, 404s, an undecodable body), the CLI's `serve` in a subprocess, and
  the raises (a mesh of another type: serving over a mesh is
  tests/test_torch_serve_mesh.py's; the JAX package's exported
  artifacts).

JAX's server is built once for the module (its first batch compiles).
"""

import http.client
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.engine.server import InferenceServer as JaxServer  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine.server import InferenceServer  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired  # noqa: E402
from test_torch_val import tiny_variables  # noqa: E402

IMGSZ, MAX_BATCH = 96, 4
BOX_TOL_PX, SCORE_TOL = 2e-4, 1e-6
KW = dict(imgsz=IMGSZ, max_batch=MAX_BATCH, conf=0.02, iou=0.7, max_det=40,
          max_nms=256)
NAMES = {0: "car", 1: "bus", 2: "train"}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs (six
    workers share a few cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    jm, v = tiny_variables(seed=0)
    return str(save_checkpoint(
        tmp_path_factory.mktemp("serve") / "tiny.npz", params=v["params"],
        batch_stats=v["batch_stats"],
        train_args={"imgsz": IMGSZ, "names": NAMES}, model_yaml=jm.yaml))


@pytest.fixture(scope="module")
def frames():
    """Six low-light BGR frames of other sizes than the letterbox's."""
    rng = np.random.default_rng(7)
    shapes = [(100, 120), (96, 96), (70, 128), (128, 90), (61, 77),
              (140, 100)]
    return [(rng.uniform(0, 1, (h, w, 3)) ** 2 * 255).astype(np.uint8)
            for h, w in shapes]


@pytest.fixture(scope="module")
def server(npz):
    # a long window: requests submitted together land in one batch
    s = InferenceServer(npz, max_wait_ms=400.0, device="cpu", **KW)
    yield s
    s.close()


@pytest.fixture(scope="module")
def jax_server(npz):
    s = JaxServer(npz, max_wait_ms=400.0, **KW)
    yield s
    s.close()


def served(srv, frames):
    """The frames in batches of MAX_BATCH, each batch submitted at once and
    resolved before the next (the predictor's batches)."""
    out = []
    for i in range(0, len(frames), MAX_BATCH):
        futs = [srv.submit(f) for f in frames[i:i + MAX_BATCH]]
        out += [f.result(timeout=120) for f in futs]
    return out


def test_responses_equal_port_predict(server, npz, frames):
    got = served(server, frames)
    want = YOLO(npz, device="cpu").predict(
        frames, device="cpu", batch=MAX_BATCH,
        **{k: v for k, v in KW.items() if k != "max_batch"})
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert g["boxes"].dtype == np.float32
        np.testing.assert_array_equal(g["boxes"], w.boxes.data)
        assert g["names"] == NAMES and g["latency_ms"] > 0


def test_responses_paired_with_jax_server(server, jax_server, frames):
    got, want = served(server, frames), served(jax_server, frames)
    assert jax_server.names == server.names == NAMES
    worst = [0.0, 0.0]
    for k, (g, w) in enumerate(zip(got, want)):
        gb, wb = g["boxes"], w["boxes"]
        _, box_err, score_err = assert_paired(
            (wb[:, :4], wb[:, 5], wb[:, 4]), (gb[:, :4], gb[:, 5], gb[:, 4]),
            BOX_TOL_PX, SCORE_TOL, f"frame {k}")
        worst = [max(worst[0], box_err), max(worst[1], score_err)]
    print(f"server vs JAX server: box {worst[0]:.3g} px, score {worst[1]:.3g}")


def test_coalescing_and_stats(server, frames):
    server.reset_stats()
    futs = [server.submit(f) for f in frames[:3]]
    for f in futs:
        f.result(timeout=120)
    st = server.stats()
    assert st["requests"] == 3 and st["batches"] == 1
    assert st["mean_batch_occupancy"] == 3.0
    assert st["max_batch"] == MAX_BATCH and st["imgsz"] == IMGSZ
    assert 0 < st["latency_ms_p50"] <= st["latency_ms_p95"]
    server.reset_stats()
    assert server.stats()["requests"] == 0


@pytest.mark.parametrize("n", [0, 1, 2, 19, 20, 100])
def test_percentiles_are_jax_formulas(server, jax_server, n):
    lats = list(np.random.default_rng(n).uniform(1, 50, n))
    for s in (server, jax_server):
        s._lat_ms.clear()
        s._lat_ms.extend(lats)
    got, want = server.stats(), jax_server.stats()
    for k in ("latency_ms_p50", "latency_ms_p95"):
        assert got[k] == want[k]
    server.reset_stats()
    jax_server.reset_stats()


def test_malformed_request_fails_only_its_own(server, frames):
    bad = [frames[0].astype(np.float32), np.zeros((4, 4), np.uint8), "x"]
    futs = [server.submit(b) for b in bad] + [server.submit(frames[1])]
    for f in futs[:3]:
        with pytest.raises(ValueError, match="HWC-BGR uint8"):
            f.result(timeout=120)
    assert futs[3].result(timeout=120)["boxes"].shape[1] == 6


def test_close_fails_queued_and_refuses_submits(npz, frames):
    s = InferenceServer(npz, max_wait_ms=1.0, warmup=False, device="cpu",
                        **KW)
    futs = [s.submit(frames[i % len(frames)]) for i in range(24)]
    s.close()
    done = failed = 0
    for f in futs:
        try:
            f.result(timeout=60)
            done += 1
        except RuntimeError as e:
            assert "server closed" in str(e)
            failed += 1
    assert done + failed == len(futs)
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(frames[0])


def test_no_card_raises_and_a12_paths(npz, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceServer(npz, **KW)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        InferenceServer(npz, mesh=object(), device="cpu", **KW)
    for spec in ("model.bin", "model.tflite"):
        with pytest.raises(NotImplementedError, match="JAX package"):
            InferenceServer(spec, device="cpu", **KW)
    (tmp_path / "saved_model.pb").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="JAX package"):
        InferenceServer(str(tmp_path), device="cpu", **KW)
    with pytest.raises(FileNotFoundError):
        InferenceServer(str(tmp_path / "missing.npz"), device="cpu", **KW)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_http_front_end(server, frames):
    httpd, port = server.serve(port=0)
    try:
        assert _request(port, "GET", "/healthz") == (200, {"status": "ok"})
        ok, png = cv2.imencode(".png", frames[2])
        assert ok
        code, payload = _request(port, "POST", "/predict", png.tobytes())
        assert code == 200
        want = server.predict(frames[2])
        np.testing.assert_array_equal(
            np.asarray(payload["boxes"], np.float32).reshape(-1, 6),
            want["boxes"])
        assert payload["names"] == {str(k): v for k, v in NAMES.items()}
        code, st = _request(port, "GET", "/stats")
        assert code == 200 and st["requests"] >= 2 and st["max_batch"] == 4
        assert _request(port, "GET", "/nope")[0] == 404
        assert _request(port, "POST", "/nope", b"x")[0] == 404
        assert _request(port, "POST", "/predict", b"not an image")[0] == 400
    finally:
        httpd.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve(npz, frames):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dedark_yolo_tpu_torch", "serve",
         f"model={npz}", f"port={port}", f"imgsz={IMGSZ}", "batch=2",
         "device=cpu", "conf=0.02"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        for _ in range(300):
            try:
                code, body = _request(port, "GET", "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                time.sleep(0.1)
        assert code == 200 and body == {"status": "ok"}
        ok, png = cv2.imencode(".png", frames[0])
        code, payload = _request(port, "POST", "/predict", png.tobytes())
        assert code == 200 and len(payload["boxes"]) > 0
        code, st = _request(port, "GET", "/stats")
        assert st["max_batch"] == 2 and st["imgsz"] == IMGSZ
    finally:
        proc.terminate()
        proc.wait(timeout=30)
