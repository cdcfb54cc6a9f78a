"""The port's trackers (dedark_yolo_tpu_torch/trackers/) against the JAX
package's: a counterpart of every case of tests/test_trackers.py on the
port (Kalman filters, association, the ByteTrack lifecycle, BoT-SORT's
gate and GMC, config loading, Results' track ids), then seeded detection
sequences with births, occlusions, low-confidence second stages and
expiries through both packages' BYTETracker and BOTSORT (GMC none and
sparseOptFlow on textured frames of a panning camera): the outputs must be
bit-equal frame by frame. Host numpy only, a few seconds.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from dedark_yolo_tpu.trackers import make_tracker as jax_make_tracker  # noqa: E402
from dedark_yolo_tpu_torch.engine.results import Boxes, Results  # noqa: E402
from dedark_yolo_tpu_torch.trackers import (load_tracker_cfg,  # noqa: E402
                                            make_tracker, track_results)
from dedark_yolo_tpu_torch.trackers.bot_sort import BOTSORT, GMC  # noqa: E402
from dedark_yolo_tpu_torch.trackers.byte_tracker import (  # noqa: E402
    BYTETracker, iou_matrix, linear_assignment)
from dedark_yolo_tpu_torch.trackers.kalman import (  # noqa: E402
    KalmanFilterXYAH, KalmanFilterXYWH)


def det(x, y, w=40, h=60, conf=0.9, cls=0):
    return [x - w / 2, y - h / 2, x + w / 2, y + h / 2, conf, cls]


# ---------------------------------------------------------------- kalman ----
@pytest.mark.parametrize("kf_cls", [KalmanFilterXYAH, KalmanFilterXYWH])
def test_kalman_update_pulls_toward_measurement(kf_cls):
    kf = kf_cls()
    m0 = np.asarray([100.0, 100.0, 0.7 if kf_cls is KalmanFilterXYAH else 40.0,
                     60.0])
    mean, cov = kf.initiate(m0)
    assert np.allclose(mean[:4], m0) and np.all(np.linalg.eigvalsh(cov) > 0)
    mean, cov = kf.predict(mean, cov)
    meas = m0 + np.asarray([8.0, -5.0, 0, 0])
    upd, _ = kf.update(mean, cov, meas)
    # posterior sits between prior and measurement, nearer the measurement
    assert abs(upd[0] - meas[0]) < abs(mean[0] - meas[0])
    assert abs(upd[1] - meas[1]) < abs(mean[1] - meas[1])


def test_kalman_multi_predict_matches_sequential():
    kf = KalmanFilterXYAH()
    tracks = [kf.initiate(np.asarray([50.0 * i + 10, 30.0 * i + 5, 0.5, 40.0]))
              for i in range(4)]
    means = np.stack([t[0] for t in tracks])
    covs = np.stack([t[1] for t in tracks])
    bm, bc = kf.multi_predict(means.copy(), covs.copy())
    for i, (m, c) in enumerate(tracks):
        sm, sc = kf.predict(m, c)
        np.testing.assert_allclose(bm[i], sm, rtol=1e-12)
        np.testing.assert_allclose(bc[i], sc, rtol=1e-12)


def test_kalman_velocity_learned_from_constant_motion():
    kf = KalmanFilterXYAH()
    mean, cov = kf.initiate(np.asarray([0.0, 0.0, 0.5, 40.0]))
    for k in range(1, 12):
        mean, cov = kf.predict(mean, cov)
        mean, cov = kf.update(mean, cov, np.asarray([5.0 * k, 0.0, 0.5, 40.0]))
    assert abs(mean[4] - 5.0) < 0.5  # vx converged to the true velocity
    mean, _ = kf.predict(mean, cov)
    assert abs(mean[0] - 60.0) < 1.5  # extrapolates the next position


def test_gating_distance_orders_candidates():
    kf = KalmanFilterXYAH()
    mean, cov = kf.initiate(np.asarray([100.0, 100.0, 0.5, 40.0]))
    d = kf.gating_distance(mean, cov, np.asarray(
        [[101.0, 100.0, 0.5, 40.0], [160.0, 100.0, 0.5, 40.0]]))
    assert d[0] < d[1]


# ----------------------------------------------------------- association ----
def test_iou_matrix_values():
    a = np.asarray([[0, 0, 10, 10]], np.float32)
    b = np.asarray([[0, 0, 10, 10], [5, 0, 15, 10], [20, 20, 30, 30]],
                   np.float32)
    m = iou_matrix(a, b)
    np.testing.assert_allclose(m[0], [1.0, 1 / 3, 0.0], atol=1e-6)
    assert iou_matrix([], b).shape == (0, 3)


def test_linear_assignment_respects_gate():
    cost = np.asarray([[0.1, 0.9], [0.95, 0.2]])
    matches, ua, ub = linear_assignment(cost, thresh=0.5)
    assert sorted(matches) == [(0, 0), (1, 1)] and not ua and not ub
    matches, ua, ub = linear_assignment(cost, thresh=0.15)
    assert matches == [(0, 0)] and ua == [1] and ub == [1]


# -------------------------------------------------------------- bytetrack ----
def _args(**kw):
    cfg = load_tracker_cfg("bytetrack.yaml")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_bytetrack_stable_ids_two_objects():
    tr = BYTETracker(_args())
    ids = {0: set(), 1: set()}
    for f in range(25):
        d0 = det(100 + 4 * f, 100)
        d1 = det(400 - 4 * f, 300, cls=1)
        out = tr.update(np.asarray([d0, d1]))
        if f >= 1:  # activation confirmed from frame 2 on
            assert out.shape[0] == 2
            for row in out:
                ids[int(row[6])].add(int(row[4]))
    # one identity per object across the whole sequence, never switched
    assert len(ids[0]) == 1 and len(ids[1]) == 1 and ids[0] != ids[1]


def test_bytetrack_occlusion_reclaims_same_id():
    tr = BYTETracker(_args())
    tid = None
    for f in range(30):
        if 10 <= f < 14:   # object fully occluded: no detection at all
            out = tr.update(np.zeros((0, 6)))
            continue
        out = tr.update(np.asarray([det(50 + 6 * f, 80)]))
        if f == 9:
            tid = int(out[0][4])
        if f == 14:   # reappears within track_buffer -> same identity
            assert out.shape[0] == 1 and int(out[0][4]) == tid


def test_bytetrack_low_conf_second_stage_keeps_id():
    tr = BYTETracker(_args())
    tid = None
    for f in range(20):
        conf = 0.3 if 8 <= f < 12 else 0.9  # dips below track_high_thresh
        out = tr.update(np.asarray([det(60 + 5 * f, 90, conf=conf)]))
        if f == 7:
            tid = int(out[0][4])
        if 8 <= f < 12:
            # stage-2 association keeps the track alive on the low-score det
            assert out.shape[0] == 1 and int(out[0][4]) == tid
    assert int(out[0][4]) == tid


def test_bytetrack_low_conf_never_births_tracks():
    tr = BYTETracker(_args())
    for f in range(6):
        out = tr.update(np.asarray([det(100, 100, conf=0.4)]))
        assert out.shape[0] == 0  # below new_track_thresh: no identity


def test_bytetrack_lost_track_expires_after_buffer():
    tr = BYTETracker(_args(track_buffer=5))
    for f in range(4):
        tr.update(np.asarray([det(100 + 5 * f, 100)]))
    for f in range(7):  # gone past the buffer
        tr.update(np.zeros((0, 6)))
    out = tr.update(np.asarray([det(125, 100)]))
    assert len(tr.lost) == 0
    # second frame after rebirth: a NEW id (old one expired)
    out = tr.update(np.asarray([det(125, 100)]))
    assert out.shape[0] == 1 and int(out[0][4]) == 2


def test_bytetrack_reset_restarts_ids():
    tr = BYTETracker(_args())
    for f in range(3):
        out = tr.update(np.asarray([det(100 + 5 * f, 100)]))
    assert int(out[0][4]) == 1
    tr.reset()
    for f in range(3):
        out = tr.update(np.asarray([det(300, 300)]))
    assert int(out[0][4]) == 1 and tr.frame_id == 3


# ---------------------------------------------------------------- botsort ----
def test_botsort_tracks_and_gates_by_proximity():
    cfg = load_tracker_cfg("botsort.yaml")
    cfg.gmc_method = "none"
    tr = BOTSORT(cfg)
    for f in range(6):
        out = tr.update(np.asarray([det(100 + 3 * f, 100)]))
    tid = int(out[0][4])
    # a far-away detection must NOT inherit this id (proximity gate) even
    # though it is the best (only) candidate
    out = tr.update(np.asarray([det(400, 400)]))
    assert all(int(r[4]) != tid for r in out)


def test_botsort_gmc_estimates_translation():
    rng = np.random.default_rng(0)
    base = (rng.uniform(0, 255, (120, 160)).astype(np.uint8))
    import cv2
    base = cv2.GaussianBlur(base, (5, 5), 0)
    shifted = np.roll(base, (0, 7), axis=(0, 1))
    g = GMC("sparseOptFlow", downscale=1)
    assert np.allclose(g.apply(base), np.eye(2, 3))  # first frame: identity
    H = g.apply(shifted)
    assert abs(H[0, 2] - 7) < 1.5 and abs(H[1, 2]) < 1.5


def test_botsort_gmc_shifts_track_means():
    cfg = load_tracker_cfg("botsort.yaml")
    tr = BOTSORT(cfg)

    class FakeGMC:
        def apply(self, img):
            H = np.eye(2, 3)
            H[0, 2] = 10.0  # constant 10px camera pan per frame
            return H

        def reset(self):
            pass

    tr.gmc = FakeGMC()
    # object static in WORLD coords; camera pans so its image x grows 10/frame
    for f in range(8):
        out = tr.update(np.asarray([det(100 + 10 * f, 100)]),
                        img=np.zeros((200, 300, 3), np.uint8))
    assert out.shape[0] == 1 and int(out[0][4]) == 1  # never lost the lock


# ------------------------------------------------------------ cfg loading ----
def test_tracker_cfg_loading_and_errors(tmp_path):
    for name, cls in (("bytetrack.yaml", BYTETracker), ("botsort", BOTSORT),
                      (None, BOTSORT)):
        t = make_tracker(name or "botsort.yaml")
        assert isinstance(t, cls)
    bad = tmp_path / "weird.yaml"
    bad.write_text("tracker_type: deepsort\n")
    with pytest.raises(ValueError, match="tracker_type"):
        make_tracker(str(bad))
    with pytest.raises(FileNotFoundError, match="choices"):
        make_tracker("nonexistent.yaml")


def test_botsort_with_reid_warns_and_runs(tmp_path):
    cfg = load_tracker_cfg("botsort.yaml")
    cfg.with_reid = True
    tr = BOTSORT(cfg)
    # frame-1 tracks activate immediately (no confirmation lag on frame 1)
    assert tr.update(np.asarray([det(50, 50)])).shape == (1, 8)


# ------------------------------------------------- Results/Boxes plumbing ----
def test_boxes_seven_column_properties():
    data = np.asarray([[10, 20, 30, 60, 7, 0.9, 2]], np.float32)
    b = Boxes(data, (100, 100))
    assert b.is_track and b.id[0] == 7 and b.conf[0] == np.float32(0.9)
    assert b.cls[0] == 2 and np.allclose(b.xyxy[0], [10, 20, 30, 60])
    assert np.allclose(b.xywh[0], [20, 40, 20, 40])
    b6 = Boxes(data[:, [0, 1, 2, 3, 5, 6]], (100, 100))
    assert not b6.is_track and b6.id is None and b6.conf[0] == np.float32(0.9)


def test_results_update_tracks_and_io(tmp_path):
    img = np.zeros((80, 120, 3), np.uint8)
    res = Results(img, "f0.jpg", {0: "a", 1: "b"},
                  boxes=np.asarray([[10, 10, 30, 30, 0.9, 0],
                                    [50, 50, 90, 70, 0.8, 1]]))
    tracks = np.asarray([[50, 50, 90, 70, 3, 0.8, 1, 1],
                         [10, 10, 30, 30, 9, 0.9, 0, 0]], np.float32)
    res.update_tracks(tracks)
    assert res.boxes.is_track and list(res.boxes.id) == [3, 9]
    import json
    js = json.loads(res.tojson())
    assert js[0]["track_id"] == 3 and js[1]["name"] == "a"
    txt = tmp_path / "t.txt"
    res.save_txt(txt, save_conf=True)
    rows = txt.read_text().strip().splitlines()
    assert rows[0].split()[-1] == "3"  # id appended after conf
    assert res.plot().shape == img.shape  # id labels render


def test_track_results_wrapper_resets_between_sources():
    def fake_stream():
        for path, x in (("vidA", 100), ("vidA", 104), ("vidA", 108),
                        ("vidB", 300), ("vidB", 304), ("vidB", 308)):
            img = np.zeros((200, 400, 3), np.uint8)
            yield Results(img, path, {0: "obj"},
                          boxes=np.asarray([det(x, 100)]))

    tr = make_tracker("bytetrack.yaml")
    out = list(track_results(fake_stream(), tr))
    assert all(r.boxes.is_track for r in out[1:3])
    # ids restart at 1 for the new source (tracker reset on path change)
    assert int(out[2].boxes.id[0]) == 1 and int(out[5].boxes.id[0]) == 1


def test_boxes_empty_track_frame_keeps_semantics():
    b = Boxes(np.zeros((0, 7), np.float32), (100, 100))
    assert b.is_track and len(b) == 0 and b.id.shape == (0,)
    # 1-D 7-element row is accepted as one tracked box
    b1 = Boxes(np.asarray([1, 2, 3, 4, 5, 0.9, 0], np.float32), (100, 100))
    assert b1.is_track and int(b1.id[0]) == 5
    res = Results(np.zeros((32, 32, 3), np.uint8), "f", {0: "a"})
    res.update_tracks(np.zeros((0, 8)))
    assert res.boxes.is_track and len(res.boxes) == 0


def test_track_results_on_already_tracked_boxes_drops_id_column():
    tr = make_tracker("bytetrack.yaml")

    def stream():
        r = Results(np.zeros((200, 400, 3), np.uint8), "v", {0: "a"},
                    boxes=np.asarray([det(100, 100)]))
        r.update_tracks(np.asarray([[80, 70, 120, 130, 42, 0.9, 0, 0]]))
        yield r

    out = list(track_results(stream(), tr))[0]
    # re-tracked: fresh id 1 from the new tracker, box coords preserved
    assert int(out.boxes.id[0]) == 1
    assert np.allclose(out.boxes.xyxy[0], [80, 70, 120, 130])


def test_kalman_multi_update_matches_sequential():
    for kf_cls in (KalmanFilterXYAH, KalmanFilterXYWH):
        kf = kf_cls()
        tracks = [kf.predict(*kf.initiate(
            np.asarray([40.0 * i + 10, 25.0 * i + 5,
                        0.5 if kf_cls is KalmanFilterXYAH else 30.0, 40.0])))
            for i in range(5)]
        meas = np.stack([np.asarray(
            [40.0 * i + 12, 25.0 * i + 4,
             0.55 if kf_cls is KalmanFilterXYAH else 31.0, 41.0])
            for i in range(5)])
        bm, bc = kf.multi_update(np.stack([t[0] for t in tracks]),
                                 np.stack([t[1] for t in tracks]), meas)
        for i, (m, c) in enumerate(tracks):
            sm, sc = kf.update(m, c, meas[i])
            np.testing.assert_allclose(bm[i], sm, rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(bc[i], sc, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------- against the JAX trackers
def scene(seed, frames=40, hw=(240, 320)):
    """Seeded per-frame detections (n, 6) of a scene: objects born and
    ending at random frames, moving at constant velocity with jitter,
    hidden for stretches (occlusions), their scores dipping below the
    high threshold for stretches (the second stage), plus clutter of low
    and middling scores."""
    rng = np.random.default_rng(seed)
    h, w = hw
    objs = []
    for _ in range(rng.integers(4, 8)):
        start = int(rng.integers(0, frames // 2))
        objs.append({"start": start,
                     "end": int(rng.integers(start + 5, frames + 10)),
                     "xy": rng.uniform([40, 40], [w - 40, h - 40]),
                     "v": rng.uniform(-4, 4, 2),
                     "wh": rng.uniform([15, 20], [50, 70]),
                     "cls": int(rng.integers(0, 3)),
                     "hide": set(range(s, s + int(rng.integers(1, 5)))
                                 for s in [int(rng.integers(0, frames))])
                     .pop(),
                     "dip": set(range(d, d + int(rng.integers(2, 6)))
                                for d in [int(rng.integers(0, frames))]).pop()})
    seq = []
    for f in range(frames):
        rows = []
        for o in objs:
            if not o["start"] <= f < o["end"] or f in o["hide"]:
                continue
            c = o["xy"] + o["v"] * (f - o["start"]) + rng.normal(0, 1.0, 2)
            wh = o["wh"] * rng.uniform(0.95, 1.05, 2)
            conf = (rng.uniform(0.15, 0.45) if f in o["dip"]
                    else rng.uniform(0.55, 0.98))
            rows.append([*(c - wh / 2), *(c + wh / 2), conf, o["cls"]])
        for _ in range(rng.integers(0, 3)):
            c = rng.uniform([0, 0], [w, h])
            wh = rng.uniform(10, 40, 2)
            rows.append([*(c - wh / 2), *(c + wh / 2),
                         rng.uniform(0.05, 0.7), int(rng.integers(0, 3))])
        seq.append(np.asarray(rows, np.float32).reshape(-1, 6))
    return seq


def panning_frames(seed, n, hw=(240, 320), step=(3, 2)):
    """Textured BGR frames of a camera panning `step` px a frame (for
    sparseOptFlow)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed + 100)
    h, w = hw
    big = rng.uniform(0, 255, (h + n * step[1] + 8, w + n * step[0] + 8))
    big = cv2.GaussianBlur(big.astype(np.uint8), (5, 5), 0)
    out = []
    for f in range(n):
        y, x = f * step[1], f * step[0]
        g = big[y:y + h, x:x + w]
        out.append(np.ascontiguousarray(np.repeat(g[..., None], 3, -1)))
    return out


TRACKER_CASES = [("bytetrack.yaml", None), ("botsort.yaml", "none"),
                 ("botsort.yaml", "sparseOptFlow")]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name,gmc", TRACKER_CASES)
def test_trackers_bit_equal_to_jax(name, gmc, seed):
    seq = scene(seed)
    imgs = (panning_frames(seed, len(seq)) if gmc == "sparseOptFlow"
            else [None] * len(seq))
    trackers = []
    for make in (make_tracker, jax_make_tracker):
        t = make(name)
        if gmc is not None:
            t.gmc.method = gmc
        trackers.append(t)
    births = set()
    for f, (dets, img) in enumerate(zip(seq, imgs)):
        got, want = (t.update(dets.copy(), img=img) for t in trackers)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
        births |= set(got[:, 4].astype(int).tolist())
    # the sequence exercised births, losses and removals in both
    port, jax_t = trackers
    assert len(births) >= 3 and port._id == jax_t._id
    assert len(port.removed) == len(jax_t.removed) > 0


@pytest.mark.parametrize("name", ["bytetrack.yaml", "botsort.yaml"])
def test_tracker_cfgs_equal_jax_yamls(name):
    from dedark_yolo_tpu.trackers import load_tracker_cfg as jax_load
    assert vars(load_tracker_cfg(name)) == vars(jax_load(name))


def test_tracker_cfg_from_json_without_yaml(tmp_path, monkeypatch):
    import json
    import sys
    p = tmp_path / "mine.json"
    p.write_text(json.dumps({"tracker_type": "bytetrack",
                             "track_high_thresh": 0.4, "track_low_thresh": 0.1,
                             "new_track_thresh": 0.5, "track_buffer": 10,
                             "match_thresh": 0.8}))
    monkeypatch.setitem(sys.modules, "yaml", None)
    t = make_tracker(str(p))
    assert isinstance(t, BYTETracker) and t.max_time_lost == 10
    assert isinstance(make_tracker("botsort.yaml"), BOTSORT)


def test_gmc_without_opencv_names_it(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        GMC("sparseOptFlow").apply(np.zeros((32, 32, 3), np.uint8))
    assert np.array_equal(GMC("none").apply(np.zeros((32, 32, 3), np.uint8)),
                          np.eye(2, 3))
