"""The segment and pose tasks in the port's InferenceServer and
`YOLO.track` (CPU), against the JAX package's on the same checkpoints:
JAX's `SEG_TINY` and `POSE_TINY` with numpy-seeded weights at imgsz 96.

- Server responses: equal to the port's own predict of the frames at
  batch=max_batch (masks and keypoints too), and paired with JAX's
  InferenceServer on the same frames under the predictor bars of
  tests/test_torch_segment_task.py and tests/test_torch_pose_task.py
  (boxes 4e-4 px, scores 1e-5; a paired mask differing in at most
  MASK_PIXELS pixels; keypoints 4e-4 px and visibility 1e-5).
- HTTP: POST /predict gives each mask as its largest external contour
  (`imgops`, equal to JAX's cv2.findContours polygon wherever the two
  masks are equal) and the keypoints as arrays.
- `YOLO.track` with ByteTrack (its thresholds set between the random
  weights' scores): each frame's tracks carry JAX's ids in JAX's order,
  boxes 4e-4 px, and each track's mask or keypoints are those of the
  detection it came from (`Results.update_tracks`' det_idx), paired with
  JAX's under the same bars.
Every wait is bounded (futures, HTTP and server setup).
"""

import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.engine.server import InferenceServer as JaxServer  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine.server import (  # noqa: E402
    InferenceServer, mask_polygon)
from dedark_yolo_tpu_torch.trackers import load_tracker_cfg  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from pairing import assert_paired  # noqa: E402
from test_segment_task import SEG_TINY  # noqa: E402
from test_torch_pose_model import POSE_TINY, pose_pair  # noqa: E402
from test_torch_segment_model import seg_pair  # noqa: E402
from test_torch_track import sequence  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

IMGSZ, MAX_BATCH = 96, 4
BOX_PX, SCORE_TOL, KPT_PX, MASK_PIXELS = 4e-4, 1e-5, 4e-4, 64
KW = dict(imgsz=IMGSZ, max_batch=MAX_BATCH, conf=0.05, iou=0.7, max_det=20,
          max_nms=256)
WAIT = 120


@pytest.fixture(scope="module")
def npzs(tmp_path_factory):
    root = tmp_path_factory.mktemp("taskserve")
    out = {}
    for task, (jm, v, _) in (("segment", seg_pair(SEG_TINY, seed=4)),
                             ("pose", pose_pair(POSE_TINY, seed=4))):
        out[task] = str(save_checkpoint(
            root / f"{task}.npz", params=v["params"],
            batch_stats=v["batch_stats"], train_args={"imgsz": IMGSZ},
            model_yaml=jm.yaml))
    return out


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    out = []
    for h, w in ((70, 120), (96, 96), (130, 77), (100, 64), (61, 90)):
        img = rng.integers(60, 140, (h, w, 3), np.uint8)
        for _ in range(3):
            c = rng.uniform(0.25, 0.75, 2) * (w, h)
            cv2.circle(img, (int(c[0]), int(c[1])), int(min(h, w) * 0.15),
                       (220, 60, 60), -1)
        out.append(img)
    return out


@pytest.fixture(scope="module", params=["segment", "pose"])
def servers(request, npzs):
    """(task, the port's server, JAX's server) on one checkpoint."""
    task = request.param
    port = InferenceServer(npzs[task], max_wait_ms=400.0, device="cpu", **KW)
    jax = JaxServer(npzs[task], max_wait_ms=400.0, **KW)
    yield task, port, jax
    port.close()
    jax.close()


def served(srv, frames):
    """The frames in batches of MAX_BATCH, each batch submitted at once and
    resolved before the next (the predictor's batches)."""
    out = []
    for i in range(0, len(frames), MAX_BATCH):
        futs = [srv.submit(f) for f in frames[i:i + MAX_BATCH]]
        out += [f.result(timeout=WAIT) for f in futs]
    return out


def assert_extras_paired(task, g, w, order, k):
    """The paired detections' masks (<= MASK_PIXELS apart) or keypoints."""
    if task == "segment":
        assert g["masks"].shape == w["masks"].shape
        assert g["masks"].shape[1:] == g["masks"].shape[1:]
        for i, j in enumerate(order):
            assert (g["masks"][i] != w["masks"][j]).sum() <= MASK_PIXELS, (k, i)
    else:
        assert g["keypoints"].shape == w["keypoints"].shape
        for i, j in enumerate(order):
            gk, wk = g["keypoints"][i], w["keypoints"][j]
            np.testing.assert_allclose(gk[:, :2], wk[:, :2], rtol=0,
                                       atol=KPT_PX)
            np.testing.assert_allclose(gk[:, 2], wk[:, 2], rtol=0, atol=1e-5)


def test_responses_equal_predict_and_pair_with_jax(servers, npzs, frames):
    task, port, jax = servers
    got, want = served(port, frames), served(jax, frames)
    pred = YOLO(npzs[task], device="cpu").predict(
        frames, device="cpu", batch=MAX_BATCH,
        **{k: v for k, v in KW.items() if k != "max_batch"})
    extra = "masks" if task == "segment" else "keypoints"
    n = 0
    for k, (g, w, p) in enumerate(zip(got, want, pred)):
        assert set(g) == set(w) == {"boxes", "names", "latency_ms", extra}
        np.testing.assert_array_equal(g["boxes"], p.boxes.data)
        np.testing.assert_array_equal(g[extra], getattr(p, extra).data)
        gb, wb = g["boxes"], w["boxes"]
        order, _, _ = assert_paired(
            (wb[:, :4], wb[:, 5], wb[:, 4]), (gb[:, :4], gb[:, 5], gb[:, 4]),
            BOX_PX, SCORE_TOL, f"frame {k}")
        assert_extras_paired(task, g, w, order, k)
        n += len(order)
    assert n > 0


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", "/predict", body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_http_payloads_match_jax(servers, frames):
    task, port, jax = servers
    (httpd, p_port), (jhttpd, j_port) = port.serve(port=0), jax.serve(port=0)
    try:
        for f in frames[:2]:
            ok, png = cv2.imencode(".png", f)
            assert ok
            (code, got), (jcode, want) = (_post(p_port, png.tobytes()),
                                          _post(j_port, png.tobytes()))
            assert code == jcode == 200
            assert set(got) == set(want)
            direct = port.predict(f, timeout=WAIT)
            gb = np.asarray(got["boxes"], np.float32).reshape(-1, 6)
            np.testing.assert_array_equal(gb, direct["boxes"])
            wb = np.asarray(want["boxes"], np.float32).reshape(-1, 6)
            order, _, _ = assert_paired(
                (wb[:, :4], wb[:, 5], wb[:, 4]),
                (gb[:, :4], gb[:, 5], gb[:, 4]), BOX_PX, SCORE_TOL)
            if task == "pose":
                np.testing.assert_array_equal(
                    np.asarray(got["keypoints"], np.float32),
                    direct["keypoints"])
                continue
            jdirect = jax.predict(f, timeout=WAIT)
            for i, j in enumerate(order):
                poly = np.asarray(got["masks"][i], np.int32).reshape(-1, 2)
                np.testing.assert_array_equal(
                    poly, mask_polygon(direct["masks"][i]))
                if np.array_equal(direct["masks"][i], jdirect["masks"][j]):
                    assert got["masks"][i] == want["masks"][j]
    finally:
        httpd.shutdown()
        jhttpd.shutdown()


def _gap_threshold(scores, q):
    """A threshold near the q-quantile of `scores`, at the middle of a gap
    of at least 1e-4 between two of them (so 1e-5 differences of the two
    packages' scores fall on the same side)."""
    s = np.unique(np.round(scores, 6))
    i = int(q * (len(s) - 1))
    for d in range(len(s)):
        for k in (i + d, i - d):
            if 0 <= k < len(s) - 1 and s[k + 1] - s[k] >= 1e-4:
                return float((s[k] + s[k + 1]) / 2)
    raise AssertionError("no score gap")


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_track_reindexes_masks_and_keypoints_as_jax(task, npzs, tmp_path):
    frames = sequence(n=8, hw=(72, 96), seed=3)
    kw = dict(imgsz=IMGSZ, batch=4, iou=0.7, max_det=20, max_nms=256)
    port = YOLO(npzs[task], device="cpu")
    pred = port.predict(frames, device="cpu", conf=0.1, **kw)
    scores = np.concatenate([r.boxes.conf for r in pred])
    high = _gap_threshold(scores, 0.9)
    cfg = {**vars(load_tracker_cfg("bytetrack.yaml")),
           "track_high_thresh": high,
           "track_low_thresh": _gap_threshold(scores, 0.6),
           "new_track_thresh": high}
    tracker = tmp_path / "bytetrack.json"
    tracker.write_text(json.dumps(cfg))
    want = JaxYOLO(npzs[task]).track(frames, tracker=str(tracker),
                                     save=False, **kw)
    got = YOLO(npzs[task], device="cpu").track(
        frames, tracker=str(tracker), device="cpu", **kw)
    assert len(got) == len(want) == len(frames)
    extra = "masks" if task == "segment" else "keypoints"
    n = 0
    for k, (g, w, p) in enumerate(zip(got, want, pred)):
        gd, wd = g.boxes.data, w.boxes.data
        assert g.boxes.is_track and gd.shape == wd.shape, k
        np.testing.assert_array_equal(gd[:, 4], wd[:, 4])        # ids
        assert np.abs(gd[:, :4] - wd[:, :4]).max(initial=0) <= BOX_PX, k
        ge, we = getattr(g, extra).data, getattr(w, extra).data
        assert len(ge) == len(gd) == len(we)
        # each track's mask or keypoints are its own detection's
        for t, row in enumerate(gd):
            j = int(np.argmin(np.abs(p.boxes.conf - row[5])))
            assert abs(p.boxes.conf[j] - row[5]) < 1e-7
            np.testing.assert_array_equal(ge[t], getattr(p, extra).data[j])
        if task == "segment":
            for t in range(len(gd)):
                assert (ge[t] != we[t]).sum() <= MASK_PIXELS, (k, t)
        else:
            np.testing.assert_allclose(ge[..., :2], we[..., :2], rtol=0,
                                       atol=KPT_PX)
        n += len(gd)
    assert n >= len(frames)
