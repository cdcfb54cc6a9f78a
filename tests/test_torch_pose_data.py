"""Torch port vs the JAX package: the pose task's data (CPU).

  - `parse_pose_label`, `PoseDataset.load_raw` and `.load` (eval and
    train-flipped) on a seeded keypoint dataset, and `collate_pose` of both
    datasets' items (the port reading `.npy` sidecars with cache='disk'):
    equal;
  - `pose_mosaic4` and `PoseTrainTransforms` under one rng: classes equal,
    boxes and keypoints within 1e-4 px (float64 point transforms), the
    visibility of a keypoint warped out of the frame zeroed alike, images
    bit-equal at the host's OpenCV vector widths
    (tests/test_torch_train_augment.py `host_widths`; its FALLBACK bars
    where no width reproduces the host), the rng's state equal after every
    item, then the collated batch.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data import pose as JP  # noqa: E402

from dedark_yolo_tpu_torch.data import pose as TP  # noqa: E402

from test_torch_train_augment import assert_u8, host_widths  # noqa: E402,F401
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HYP = {"mosaic": 1.0, "scale": 0.5, "translate": 0.1, "degrees": 10.0,
       "shear": 2.0, "perspective": 0.0, "hsv_h": 0.015, "hsv_s": 0.7,
       "hsv_v": 0.4, "photometric": True}
NK = 3


def make_pose_dataset(root, n_train=6, n_val=4, seed=0, nk=NK):
    """root/images/{train,val}/*.jpg of mixed sizes, each with 1-3
    instances of nk keypoints (some labelled invisible, some near or past
    the frame's edge), labels beside; returns the dataset dict."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for k in range(n):
            h, w = (int(v) for v in rng.integers(70, 140, 2))
            img = rng.integers(90, 130, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                cx, cy = rng.uniform(0.25, 0.75, 2) * (w, h)
                bw, bh = rng.uniform(0.2, 0.45, 2) * (w, h)
                pts = np.stack([cx + rng.uniform(-0.6, 0.6, nk) * bw,
                                cy + rng.uniform(-0.6, 0.6, nk) * bh], 1)
                vis = rng.choice([0, 1, 2], nk, p=[0.2, 0.3, 0.5])
                for (x, y), v in zip(pts, vis):
                    if v:
                        cv2.circle(img, (int(x), int(y)), 3, (250, 50, 50), -1)
                cv2.rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)),
                              (int(cx + bw / 2), int(cy + bh / 2)),
                              (60, 200, 60), 1)
                kp = " ".join(f"{x / w:.5f} {y / h:.5f} {v}"
                              for (x, y), v in zip(pts, vis))
                rows.append(f"0 {cx / w:.5f} {cy / h:.5f} {bw / w:.5f} "
                            f"{bh / h:.5f} {kp}")
            cv2.imwrite(str(root / "images" / split / f"{k}.jpg"), img)
            (root / "labels" / split / f"{k}.txt").write_text(
                "\n".join(rows) + "\n")
    return {"path": str(root), "train": str(root / "images" / "train"),
            "val": str(root / "images" / "val"), "nc": 1,
            "names": {0: "person"}, "kpt_shape": [nk, 3]}


@pytest.fixture(scope="module")
def pose_data(tmp_path_factory):
    return make_pose_dataset(tmp_path_factory.mktemp("posedata"))


def _equal_items(b, a, atol=0.0):
    np.testing.assert_array_equal(b[0], a[0])
    for k in (1, 3):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=atol)
    np.testing.assert_array_equal(b[2], a[2])


def test_dataset_items_and_collate_equal_jax(pose_data):
    """Every val image's labels, raw item (max-side resize, pixel boxes and
    keypoints) and letterboxed item, eval and train-flipped, and the
    collated batch: equal, the port reading the sidecars it wrote on its
    first pass."""
    jd = JP.PoseDataset(pose_data["val"], imgsz=96, nc=1, kpt_shape=(NK, 3))
    first = TP.PoseDataset(pose_data["val"], imgsz=96, nc=1,
                           kpt_shape=(NK, 3), cache="disk")
    for ds in (first, TP.PoseDataset(pose_data["val"], imgsz=96, nc=1,
                                     kpt_shape=(NK, 3), cache="disk")):
        assert ds.im_files == jd.im_files
        np.testing.assert_array_equal(ds.image_shapes(), jd.image_shapes())
        items_j, items_t = [], []
        for i in range(len(jd)):
            assert len(ds.labels[i]) == len(jd.labels[i])
            for (c, bx, kp), (jc, jbx, jkp) in zip(ds.labels[i], jd.labels[i]):
                assert c == jc
                np.testing.assert_array_equal(bx, jbx)
                np.testing.assert_array_equal(kp, jkp)
            _equal_items(ds.load_raw(i), jd.load_raw(i))
            for train in (False, True):
                rj, rt = random.Random(i), random.Random(i)
                a = jd.load(i, fliplr_p=0.5, train=train, rng=rj)
                b = ds.load(i, fliplr_p=0.5, train=train, rng=rt)
                _equal_items(b, a)
            items_j.append(a)
            items_t.append(b)
        for mb in (8, 2):
            want = JP.collate_pose(items_j, max_boxes=mb, nk=NK)
            got = TP.collate_pose(items_t, max_boxes=mb, nk=NK)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mosaic_equal_jax(pose_data):
    jd = JP.PoseDataset(pose_data["train"], imgsz=64, nc=1, kpt_shape=(NK, 3))
    td = TP.PoseDataset(pose_data["train"], imgsz=64, nc=1, kpt_shape=(NK, 3))
    for seed in range(4):
        idx = [(seed + j) % len(jd) for j in range(4)]
        r1, r2 = random.Random(seed), random.Random(seed)
        a = JP.pose_mosaic4([jd.load_raw(i) for i in idx], 64, r1)
        b = TP.pose_mosaic4([td.load_raw(i) for i in idx], 64, r2)
        assert r1.getstate() == r2.getstate()
        _equal_items(b, a)


@pytest.mark.parametrize("mosaic", [True, False])
def test_train_transforms_equal_jax(pose_data, mosaic, host_widths):
    """PoseTrainTransforms of both packages on one dataset (the mosaic on,
    or off as after close_mosaic), 10 items each, then their collate."""
    exact = None not in host_widths.values()
    jd = JP.PoseDataset(pose_data["train"], imgsz=64, nc=1, kpt_shape=(NK, 3))
    td = TP.PoseDataset(pose_data["train"], imgsz=64, nc=1, kpt_shape=(NK, 3))
    jt, tt = JP.PoseTrainTransforms(HYP, 64), TP.PoseTrainTransforms(HYP, 64)
    jt.mosaic_enabled = tt.mosaic_enabled = mosaic
    items_j, items_t, n_hidden = [], [], 0
    for item in range(10):
        r1, r2 = random.Random(70 + item), random.Random(70 + item)
        a = jt(jd, item % len(jd), r1)
        b = tt(td, item % len(td), r2)
        assert r1.getstate() == r2.getstate(), item
        np.testing.assert_array_equal(b[2], a[2])
        np.testing.assert_allclose(b[1] * 64, a[1] * 64, rtol=0, atol=1e-4)
        assert b[3].shape == a[3].shape
        np.testing.assert_allclose(b[3][..., :2] * 64, a[3][..., :2] * 64,
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(b[3][..., 2], a[3][..., 2])
        # a keypoint outside the output frame has lost its visibility
        xy = b[3][..., :2]
        out = (xy < 0).any(-1) | (xy >= 1).any(-1)
        assert (b[3][..., 2][out] == 0).all()
        n_hidden += int(out.sum())
        assert_u8(b[0], a[0], exact, "transforms", f"item {item}")
        items_j.append(a)
        items_t.append(b)
    if mosaic:
        assert n_hidden > 0          # the case is reached
    want = JP.collate_pose(items_j, max_boxes=16, nk=NK)
    got = TP.collate_pose(items_t, max_boxes=16, nk=NK)
    for k in ("cls", "mask_gt"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0,
                               atol=1e-4 / 64)
