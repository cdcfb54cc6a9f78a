"""`YOLO.track` of the port (dedark_yolo_tpu_torch/engine/model.py,
trackers/) against the JAX package's on the CPU: tests/tiny_model.yaml at
imgsz 96 from one JAX checkpoint, a seeded sequence of low-light frames
with moving rectangles, batch 4.

Both facades run the same frames (a list of arrays: one source, so the
tracker carries its ids through) with ByteTrack and BoT-SORT, their
thresholds set in tracker files (JSON, which both packages read) to the
random weights' score range (0.5-0.57 at the top); each frame's
tracked boxes must carry JAX's ids in JAX's order, boxes within 4e-4 px
and scores within 1e-6 (the CPU parity bars: the two forwards sum their
convolutions in other orders). Then the port alone: the same frames as a
directory of `.npy` files with persist=True (one sequence across files)
equal the list's run; persist across calls continues the ids; save_txt
rows end in the id; the CLI's `track` counts frames and identities.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch.trackers import load_tracker_cfg  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from test_torch_val import tiny_variables  # noqa: E402

IMGSZ, N_FRAMES = 96, 12
BOX_TOL_PX, SCORE_TOL = 4e-4, 1e-6
KW = dict(imgsz=IMGSZ, batch=4, iou=0.7, max_det=40, max_nms=256)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    jm, v = tiny_variables(seed=0)
    return str(save_checkpoint(
        tmp_path_factory.mktemp("track") / "tiny.npz", params=v["params"],
        batch_stats=v["batch_stats"], train_args={"imgsz": IMGSZ},
        model_yaml=jm.yaml))


def sequence(n=N_FRAMES, hw=(72, 96), seed=3):
    """Seeded low-light BGR frames: dark noise with three bright rectangles
    moving at constant velocity, darkened as (u8/255)**2."""
    rng = np.random.default_rng(seed)
    h, w = hw
    boxes = [(8, 10, 22, 30, 3, 1), (40, 50, 20, 16, -2, 1),
             (20, 30, 12, 26, 1, -1)]
    colours = rng.uniform(0.5, 1.0, (3, 3))
    out = []
    for f in range(n):
        img = rng.uniform(0, 0.25, (h, w, 3))
        for (y, x, bh, bw, vx, vy), c in zip(boxes, colours):
            y0, x0 = y + vy * f, x + vx * f
            img[max(y0, 0):y0 + bh, max(x0, 0):x0 + bw] = c
        out.append((img ** 2 * 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def frames():
    return sequence()


@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """bytetrack.yaml and botsort.yaml with the thresholds moved to the
    tiny model's scores, as tracker files."""
    root = tmp_path_factory.mktemp("trackers")
    thresholds = {"track_high_thresh": 0.55, "track_low_thresh": 0.53,
                  "new_track_thresh": 0.555}
    out = {}
    for name in ("bytetrack", "botsort"):
        cfg = {**vars(load_tracker_cfg(f"{name}.yaml")), **thresholds}
        out[name] = root / f"{name}.json"
        out[name].write_text(json.dumps(cfg))
    return {k: str(v) for k, v in out.items()}


def assert_tracks_match(got, want):
    assert len(got) == len(want)
    ids = set()
    for k, (g, w) in enumerate(zip(got, want)):
        gd, wd = g.boxes.data, w.boxes.data
        assert g.boxes.is_track and w.boxes.is_track and gd.shape == wd.shape, k
        np.testing.assert_array_equal(gd[:, 4], wd[:, 4])       # ids
        np.testing.assert_array_equal(gd[:, 6], wd[:, 6])       # classes
        assert np.abs(gd[:, :4] - wd[:, :4]).max(initial=0) <= BOX_TOL_PX, k
        assert np.abs(gd[:, 5] - wd[:, 5]).max(initial=0) <= SCORE_TOL, k
        ids |= set(gd[:, 4].astype(int).tolist())
    return ids


@pytest.mark.parametrize("name", ["bytetrack", "botsort"])
def test_track_matches_jax(npz, frames, trackers, name):
    tracker = trackers[name]
    want = JaxYOLO(npz).track(frames, tracker=tracker, save=False, **KW)
    got = YOLO(npz, device="cpu").track(frames, tracker=tracker,
                                        device="cpu", **KW)
    ids = assert_tracks_match(got, want)
    assert len(ids) >= 2 and sum(len(r) for r in got) >= N_FRAMES
    print(f"{name}: {len(ids)} identities, "
          f"{sum(len(r) for r in got)} tracked boxes")


def test_npy_sequence_persist_and_save_txt(npz, frames, trackers, tmp_path):
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        np.save(seq / f"f{i:03d}.npy", f)
    m = YOLO(npz, device="cpu")
    want = m.track(frames, tracker=trackers["bytetrack"], device="cpu", **KW)
    got = YOLO(npz, device="cpu").track(
        str(seq), persist=True, tracker=trackers["bytetrack"], device="cpu",
        save_txt=True, project=str(tmp_path / "runs"), name="t", **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
    labels = sorted((tmp_path / "runs" / "t" / "labels").glob("*.txt"))
    assert len(labels) == N_FRAMES
    for lab, r in zip(labels, got):
        rows = [ln.split() for ln in lab.read_text().splitlines()]
        assert [int(row[-1]) for row in rows] == r.boxes.id.astype(int).tolist()
    # without persist each file is a new source: the tracker restarts at
    # every frame, whose births take ids 1, 2, ... again
    fresh = YOLO(npz, device="cpu").track(
        str(seq), tracker=trackers["bytetrack"], device="cpu", **KW)
    assert all(r.boxes.id.astype(int).tolist() == list(range(1, len(r) + 1))
               for r in fresh)
    assert sum(len(r) for r in fresh) > 0
    # persist across calls: the second call's ids continue the first's
    m = YOLO(npz, device="cpu")
    first = m.track(frames[:6], persist=True, tracker=trackers["bytetrack"],
                    device="cpu", **KW)
    second = m.track(frames[6:], persist=True, tracker=trackers["bytetrack"],
                     device="cpu", **KW)
    split = first + second
    assert_tracks_match(split, want)


def test_cli_track(npz, frames, trackers, tmp_path, capsys):
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        np.save(seq / f"f{i:03d}.npy", f)
    rc = cli.entrypoint(["track", f"model={npz}", f"source={seq}",
                         "persist=True", f"tracker={trackers['bytetrack']}",
                         "device=cpu", "save=False", f"imgsz={IMGSZ}",
                         "batch=4", "max_det=40", "max_nms=256"])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("results ")][-1]
    res = json.loads(line[len("results "):])
    want = YOLO(npz, device="cpu").track(frames, tracker=trackers["bytetrack"],
                                         device="cpu", **KW)
    ids = {int(i) for r in want for i in r.boxes.id}
    assert res == {"frames": N_FRAMES, "identities": len(ids)}
    assert cli.entrypoint(["track", f"model={npz}", "device=cpu"]) == 1
