"""InferenceServer(mesh=) on the CPU (the counterpart of JAX
tests/test_server.py::test_mesh_sharded_serving): the tiny model's JAX
checkpoint served over `make_mesh(devices=["cpu", "cpu"])`, each padded
batch of 4 split into two groups of 2, one predictor a device.

- Every response paired with the single-device server's answer for its
  frame at the predict bars (a full batch, then a short one whose second
  group is padding only), the responses in the batch's order, each
  group's step dispatched, the warmup through the split.
- The segment and pose tasks' masks and keypoints through the same
  split, against their single-device servers (tests/
  test_torch_segment_serve.py's checkpoints and frames).
- The refusals: max_batch not a multiple of the mesh size (JAX's message),
  an exported artifact (JAX's message for its artifacts), a group mesh,
  an object that is not a mesh, a device that is not the mesh's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from dedark_yolo_tpu_torch.engine.server import InferenceServer  # noqa: E402
from dedark_yolo_tpu_torch.parallel import make_mesh  # noqa: E402

from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from pairing import assert_paired  # noqa: E402
from test_torch_serve import (BOX_TOL_PX, KW, MAX_BATCH, NAMES,  # noqa: E402,F401
                              SCORE_TOL, few_threads, frames, npz, served)

import test_torch_segment_serve as TS  # noqa: E402
from test_segment_task import SEG_TINY  # noqa: E402
from test_torch_pose_model import POSE_TINY, pose_pair  # noqa: E402
from test_torch_segment_model import seg_pair  # noqa: E402


def mesh2():
    return make_mesh(devices=["cpu", "cpu"])


def assert_paired_responses(got, want):
    """Each frame's detections paired with the single-device server's
    (tests/pairing.py) at the predict bars: a group of 2 images sums its
    convs in another order than a batch of 4. A paired detection's mask
    differs in at most MASK_PIXELS pixels, its keypoints within KPT_PX."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gb, wb = g["boxes"], w["boxes"]
        assert gb.dtype == np.float32
        order, _, _ = assert_paired(
            (wb[:, :4], wb[:, 5], wb[:, 4]), (gb[:, :4], gb[:, 5], gb[:, 4]),
            BOX_TOL_PX, SCORE_TOL, f"frame {i}")
        for k in ("masks", "keypoints"):
            assert (k in g) == (k in w)
        if "masks" in w:
            diff = (g["masks"] != w["masks"][order]).reshape(len(wb), -1)
            assert diff.sum(1).max(initial=0) <= TS.MASK_PIXELS
        if "keypoints" in w:
            np.testing.assert_allclose(g["keypoints"][..., :2],
                                       w["keypoints"][order][..., :2], rtol=0,
                                       atol=TS.KPT_PX)


def test_mesh_server_equals_single_device(npz, frames):
    one = InferenceServer(npz, max_wait_ms=400.0, device="cpu", **KW)
    try:
        want = served(one, frames)
    finally:
        one.close()
    s = InferenceServer(npz, max_wait_ms=400.0, mesh=mesh2(), **KW)
    try:
        assert [p.args.batch for p in s._preds] == [MAX_BATCH // 2] * 2
        assert s._preds[0].model is s._preds[1].model   # one a device
        assert s.device == torch.device("cpu") and s.names == NAMES
        calls = []
        for p in s._preds:
            step = p.step
            p.step = (lambda f: lambda img: calls.append(len(img)) or f(img))(
                step)
        got = served(s, frames)
        assert sum(len(r["boxes"]) for r in want) > 0
        assert_paired_responses(got, want)
        # six frames: a full batch and one of two frames, each split in two
        assert calls == [2, 2, 2, 2]
        assert s.stats()["batches"] == 2
    finally:
        s.close()


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_mesh_server_tasks(task, tmp_path):
    rng = np.random.default_rng(11)
    task_frames = [rng.integers(60, 140, (h, w, 3), np.uint8)
                   for h, w in ((70, 120), (96, 96), (130, 77), (100, 64),
                                (61, 90))]
    jm, v, _ = (seg_pair(SEG_TINY, seed=4) if task == "segment"
                else pose_pair(POSE_TINY, seed=4))
    spec = str(save_checkpoint(tmp_path / f"{task}.npz", params=v["params"],
                               batch_stats=v["batch_stats"],
                               train_args={"imgsz": TS.IMGSZ},
                               model_yaml=jm.yaml))
    one = InferenceServer(spec, max_wait_ms=400.0, device="cpu", **TS.KW)
    try:
        want = TS.served(one, task_frames)
    finally:
        one.close()
    s = InferenceServer(spec, max_wait_ms=400.0, mesh=mesh2(), **TS.KW)
    try:
        assert_paired_responses(TS.served(s, task_frames), want)
    finally:
        s.close()


def test_mesh_server_refusals(npz):
    with pytest.raises(ValueError, match="must be a multiple of the mesh "
                                         "size 2"):
        InferenceServer(npz, warmup=False, mesh=mesh2(),
                        **{**KW, "max_batch": 3})
    with pytest.raises(ValueError, match="exported artifacts .* serve the "
                                         "checkpoint instead to shard over "
                                         "a mesh"):
        InferenceServer("model.pt2", mesh=mesh2(), **KW)
    with pytest.raises(ValueError, match=r"devices=\[\.\.\.\]"):
        InferenceServer(npz, mesh=make_mesh(device="cpu"), **KW)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        InferenceServer(npz, mesh=object(), **KW)
    with pytest.raises(ValueError, match="first device"):
        InferenceServer(npz, mesh=mesh2(), device="cuda", **KW)
