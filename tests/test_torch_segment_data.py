"""Torch port vs the JAX package: the segment task's data (CPU).

  - the ground-truth raster: `polygons2masks_overlap` at mask ratios 4 and
    1 (convex, concave and border-touching polygons, >255 instances), and
    `collate_segment` of both datasets' items (the port reading `.npy`
    sidecars with cache='disk'): bit-equal;
  - the augmentations under one rng (JAX tests/test_seg_pose_aug.py's
    setups, then `SegTrainTransforms` on a seeded dataset): classes equal,
    polygons within 1e-4 px, images bit-equal at the host's OpenCV vector
    widths (tests/test_torch_train_augment.py `host_widths`; its FALLBACK
    bars where no width reproduces the host), the rng's state equal after
    every item;
  - `Bboxes` and `Instances`: JAX tests/test_instances.py's cases on both.
"""

import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data import instances as JI  # noqa: E402
from dedark_yolo_tpu.data import segment as JS  # noqa: E402

from dedark_yolo_tpu_torch.data import instances as TI  # noqa: E402
from dedark_yolo_tpu_torch.data import segment as TS  # noqa: E402

from test_torch_train_augment import assert_u8, host_widths  # noqa: E402,F401
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

HYP = {"mosaic": 1.0, "copy_paste": 0.5, "fliplr": 0.5, "scale": 0.5,
       "translate": 0.1, "degrees": 10.0, "shear": 2.0, "hsv_h": 0.015,
       "hsv_s": 0.7, "hsv_v": 0.4, "photometric": True}


def _square(cx, cy, r):
    return np.asarray([[cx - r, cy - r], [cx + r, cy - r],
                       [cx + r, cy + r], [cx - r, cy + r]], np.float32)


def _polys(rng, s, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 12))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(2, s / 2, k)
        c = rng.uniform(0, s, 2)
        p = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
        out.append(p.clip(0, s).astype(np.float32))   # seg_affine's clip
    return out


@pytest.mark.parametrize("ratio", [4, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_raster_bit_equal_jax(seed, ratio):
    rng = np.random.default_rng(seed)
    s = int(rng.choice([64, 96, 128]))
    polys = _polys(rng, s, int(rng.integers(1, 9)))
    want = JS.polygons2masks_overlap((s, s), polys, downsample_ratio=ratio)
    got = TS.polygons2masks_overlap((s, s), polys, downsample_ratio=ratio)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for p in polys[:3]:
        np.testing.assert_array_equal(
            TS.polygon2mask((s, s), p, 1, ratio),
            JS.polygon2mask((s, s), p, 1, ratio))


def test_overlap_raster_past_255_instances_is_int32():
    rng = np.random.default_rng(5)
    polys = [_square(*rng.uniform(4, 60, 2), 2.5) for _ in range(300)]
    want = JS.polygons2masks_overlap((64, 64), polys, 4)
    got = TS.polygons2masks_overlap((64, 64), polys, 4)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def make_seg_dataset(root, n_train=6, n_val=4, seed=0, nc=2):
    """root/images/{train,val}/*.jpg of mixed sizes with overlapping
    polygon instances, labels beside; returns the dataset dict."""
    rng = np.random.default_rng(seed)
    colors = [(220, 60, 60), (60, 220, 60), (60, 60, 220)]
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for k in range(n):
            h, w = (int(v) for v in rng.integers(70, 140, 2))
            img = rng.integers(90, 130, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                c = int(rng.integers(0, nc))
                cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
                r = rng.uniform(0.1, 0.3) * min(h, w)
                ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(5, 10))))
                rad = r * rng.uniform(0.6, 1.0, len(ang))
                pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
                cv2.fillPoly(img, [pts.astype(np.int32)], colors[c])
                norm = (pts / (w, h)).clip(0, 1).reshape(-1)
                rows.append(f"{c} " + " ".join(f"{v:.5f}" for v in norm))
            cv2.imwrite(str(root / "images" / split / f"{k}.jpg"), img)
            (root / "labels" / split / f"{k}.txt").write_text(
                "\n".join(rows) + "\n")
    return {"path": str(root), "train": str(root / "images" / "train"),
            "val": str(root / "images" / "val"), "nc": nc,
            "names": {i: f"c{i}" for i in range(nc)}}


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    return make_seg_dataset(tmp_path_factory.mktemp("segdata"))


def test_dataset_items_and_collate_equal_jax(seg_data):
    """Every val item (letterboxed image, boxes, classes, polygons), eval
    and train-flipped, and the collated batch with its masks: equal, the
    port reading the sidecars it wrote on its first pass."""
    jd = JS.SegmentDataset(seg_data["val"], imgsz=96, nc=2)
    first = TS.SegmentDataset(seg_data["val"], imgsz=96, nc=2, cache="disk")
    for ds in (first, TS.SegmentDataset(seg_data["val"], imgsz=96, nc=2,
                                        cache="disk")):
        assert ds.im_files == jd.im_files
        np.testing.assert_array_equal(ds.image_shapes(), jd.image_shapes())
        items_j, items_t = [], []
        for i in range(len(jd)):
            for train in (False, True):
                rj, rt = random.Random(i), random.Random(i)
                a = jd.load(i, train=train, rng=rj)
                b = ds.load(i, train=train, rng=rt)
                np.testing.assert_array_equal(b[0], a[0])
                np.testing.assert_array_equal(b[1], a[1])
                np.testing.assert_array_equal(b[2], a[2])
                for p, q in zip(b[3], a[3]):
                    np.testing.assert_array_equal(p, q)
            items_j.append(a)
            items_t.append(b)
        for mb in (8, 2):
            want = JS.collate_segment(items_j, max_boxes=mb, mask_ratio=4)
            got = TS.collate_segment(items_t, max_boxes=mb, mask_ratio=4)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(list(Path(seg_data["val"]).glob("*.npy"))) == len(jd)


def test_mosaic_copy_paste_affine_equal_jax(host_widths):
    """JAX tests/test_seg_pose_aug.py's setups, each step on both."""
    exact = host_widths["WARP_VECTOR"] is not None
    items = []
    for i in range(4):
        img = np.full((96, 96, 3), 40 + i * 20, np.uint8)
        poly = _square(48, 48, 20)
        cv2.fillPoly(img, [poly.astype(np.int32)], (200, 50, 50))
        items.append((img, np.asarray([float(i % 2)], np.float32), [poly]))
    for seed in range(4):
        a = JS.seg_mosaic4(items, 96, random.Random(seed))
        b = TS.seg_mosaic4(items, 96, random.Random(seed))
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        for p, q in zip(b[2], a[2]):
            np.testing.assert_array_equal(p, q)
        # copy-paste on the mosaic canvas, whose polygons leave it
        r1, r2 = random.Random(seed), random.Random(seed)
        ca = JS.copy_paste(*a, p=1.0, rng=r1)
        cb = TS.copy_paste(*b, p=1.0, rng=r2)
        assert r1.getstate() == r2.getstate()
        np.testing.assert_array_equal(cb[0], ca[0])
        np.testing.assert_array_equal(cb[1], ca[1])
        assert len(cb[2]) == len(ca[2])
        r1, r2 = random.Random(seed), random.Random(seed)
        hyp = {"degrees": 10.0, "translate": 0.1, "scale": 0.5, "shear": 2.0,
               "perspective": 0.0}
        fa = JS.seg_affine(*ca, hyp, (-48, -48), r1)
        fb = TS.seg_affine(*cb, hyp, (-48, -48), r2)
        assert r1.getstate() == r2.getstate()
        assert_u8(fb[0], fa[0], exact, "warp")
        np.testing.assert_array_equal(fb[1], fa[1])
        for p, q in zip(fb[2], fa[2]):
            np.testing.assert_allclose(p, q, rtol=0, atol=1e-4)
    # the overlap gate: a centred instance meets its own mirror
    img = np.full((100, 100, 3), 30, np.uint8)
    out = TS.copy_paste(img, np.asarray([0.0]), [_square(50, 50, 20)], 1.0,
                        random.Random(0))
    assert len(out[1]) == 1


@pytest.mark.parametrize("mosaic", [True, False])
def test_train_transforms_equal_jax(seg_data, mosaic, host_widths):
    """SegTrainTransforms of both packages on one dataset (the mosaic on,
    or off as after close_mosaic), 10 items each, then their collate."""
    exact = None not in host_widths.values()
    jd = JS.SegmentDataset(seg_data["train"], imgsz=64, nc=2)
    td = TS.SegmentDataset(seg_data["train"], imgsz=64, nc=2)
    jt, tt = JS.SegTrainTransforms(HYP, 64), TS.SegTrainTransforms(HYP, 64)
    jt.mosaic_enabled = tt.mosaic_enabled = mosaic
    items_j, items_t = [], []
    for item in range(10):
        r1, r2 = random.Random(50 + item), random.Random(50 + item)
        a = jt(jd, item % len(jd), r1)
        b = tt(td, item % len(td), r2)
        assert r1.getstate() == r2.getstate(), item
        np.testing.assert_array_equal(b[2], a[2])
        np.testing.assert_allclose(b[1] * 64, a[1] * 64, rtol=0, atol=1e-4)
        assert len(b[3]) == len(a[3])
        for p, q in zip(b[3], a[3]):
            np.testing.assert_allclose(p, q, rtol=0, atol=1e-4)
        assert_u8(b[0], a[0], exact, "transforms", f"item {item}")
        items_j.append(a)
        items_t.append(b)
    if exact:
        want = JS.collate_segment(items_j, max_boxes=16, mask_ratio=4)
        got = TS.collate_segment(items_t, max_boxes=16, mask_ratio=4)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_array_equal(got["mask_gt"], want["mask_gt"])


def test_bboxes_convert_roundtrip():
    for mod in (JI, TI):
        b = mod.Bboxes(np.array([[10, 20, 30, 60]], np.float32), "xyxy")
        b.convert("xywh")
        np.testing.assert_allclose(b.bboxes, [[20, 40, 20, 40]])
        b.convert("ltwh")
        np.testing.assert_allclose(b.bboxes, [[10, 20, 20, 40]])
        b.convert("xyxy")
        np.testing.assert_allclose(b.bboxes, [[10, 20, 30, 60]])
        np.testing.assert_allclose(b.areas(), [800])


def test_instances_normalize_flip_clip():
    for mod in (JI, TI):
        inst = mod.Instances(np.array([[0.5, 0.5, 0.25, 0.5]], np.float32),
                             bbox_format="xywh", normalized=True)
        inst.denormalize(w=200, h=100)
        np.testing.assert_allclose(inst.bboxes, [[100, 50, 50, 50]])
        inst.fliplr(w=200)
        np.testing.assert_allclose(inst.bboxes, [[100, 50, 50, 50]])
        inst.convert_bbox("xyxy")
        inst.add_padding(10, 5)
        np.testing.assert_allclose(inst.bboxes, [[85, 30, 135, 80]])
        inst.clip(w=120, h=100)
        np.testing.assert_allclose(inst.bboxes, [[85, 30, 120, 80]])
        keep = inst.remove_zero_area_boxes()
        assert keep.all() and len(inst) == 1
        inst.flipud(h=100)
        np.testing.assert_allclose(inst.bboxes, [[85, 20, 120, 70]])


def test_instances_keypoints_follow():
    for mod in (JI, TI):
        kpts = np.array([[[10.0, 20.0, 1.0]]], np.float32)
        inst = mod.Instances(np.array([[0, 0, 40, 40]], np.float32),
                             keypoints=kpts, bbox_format="xyxy",
                             normalized=False)
        inst.fliplr(w=100)
        np.testing.assert_allclose(inst.keypoints[0, 0, 0], 90.0)
        inst.scale(0.5, 2.0)
        np.testing.assert_allclose(inst.keypoints[0, 0], [45.0, 40.0, 1.0])
        inst.normalize(w=90, h=80)
        np.testing.assert_allclose(inst.keypoints[0, 0], [0.5, 0.5, 1.0])
