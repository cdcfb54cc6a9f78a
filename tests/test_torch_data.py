"""Torch port vs the JAX package: the val data path on the CPU.

On a tests/synth.py dataset: `check_det_dataset` (a yaml path and a dict),
`YOLODataset` (labels, image shapes, loaded samples, the label cache, the
'disk' cache's .npy sidecars), `ValTransforms` (square and rect targets),
`collate` and `DataLoader` batches, and `letterbox` at predict's call and
at the val calls (rect targets, `scaleup=False`, `auto=True`). The port and
the JAX package read the same files with the same cv2, so images must be
equal byte for byte and labels and boxes bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.data import augment as JA  # noqa: E402
from dedark_yolo_tpu.data import dataset as JD  # noqa: E402
from dedark_yolo_tpu.data import loader as JL  # noqa: E402

from dedark_yolo_tpu_torch.data import augment as TA  # noqa: E402
from dedark_yolo_tpu_torch.data import dataset as TD  # noqa: E402
from dedark_yolo_tpu_torch.data import loader as TL  # noqa: E402
from dedark_yolo_tpu_torch.engine.validator import rect_shape  # noqa: E402

from synth import make_synth_dataset  # noqa: E402

N_VAL = 7


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return make_synth_dataset(tmp_path_factory.mktemp("data") / "ds",
                              n_train=2, n_val=N_VAL, imgsz=96, seed=3)


def datasets(data_yaml, **kw):
    d = TD.check_det_dataset(str(data_yaml))
    return (JD.YOLODataset(d["val"], imgsz=96, nc=3, **kw),
            TD.YOLODataset(d["val"], imgsz=96, nc=3, **kw))


def test_check_det_dataset_matches_jax(data_yaml):
    assert TD.check_det_dataset(str(data_yaml)) == \
        JD.check_det_dataset(str(data_yaml))
    d = {"path": str(data_yaml.parent), "train": "images/train",
         "val": "images/val", "names": ["a", "b", "c"]}
    got = TD.check_det_dataset(d)
    assert got == JD.check_det_dataset(d)
    assert got["nc"] == 3 and got["names"] == {0: "a", 1: "b", 2: "c"}
    assert got["val"] == str(data_yaml.parent / "images" / "val")
    assert TD.check_det_dataset({"nc": 2})["names"] == {0: "0", 1: "1"}


@pytest.mark.parametrize("single_cls", [False, True])
def test_dataset_matches_jax(data_yaml, single_cls):
    jd, td = datasets(data_yaml, single_cls=single_cls)
    assert td.im_files == jd.im_files and td.label_files == jd.label_files
    assert len(td) == N_VAL
    for a, b in zip(td.labels, jd.labels):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.image_shapes(), jd.image_shapes())
    for i in range(len(td)):
        for size in (96, 64, None):
            a, b = td(i, size), jd(i, size)
            np.testing.assert_array_equal(a.img, b.img)
            np.testing.assert_array_equal(a.boxes, b.boxes)
            np.testing.assert_array_equal(a.cls, b.cls)


def test_label_cache_crosses_between_packages(tmp_path):
    root = make_synth_dataset(tmp_path / "ds", n_train=1, n_val=3, imgsz=64)
    val = str(root.parent / "images" / "val")
    cache = root.parent / "images" / "labels.cache.npz"
    td = TD.YOLODataset(val, nc=3)          # verifies and writes the cache
    assert cache.is_file()
    jd = JD.YOLODataset(val, nc=3)          # reads the port's cache
    for a, b in zip(td.labels, jd.labels):
        np.testing.assert_array_equal(a, b)
    # a cache of the JAX package's is read back by the port
    cache.unlink()
    JD.YOLODataset(val, nc=3)
    again = TD.YOLODataset(val, nc=3)
    for a, b in zip(again.labels, jd.labels):
        np.testing.assert_array_equal(a, b)


def test_disk_cache_sidecars_stand_in_for_the_images(data_yaml, tmp_path):
    import shutil
    root = tmp_path / "ds"
    shutil.copytree(data_yaml.parent / "images", root / "images")
    shutil.copytree(data_yaml.parent / "labels", root / "labels")
    val = str(root / "images" / "val")
    want_shapes = JD.read_image_shapes(JD._scan_images(val))
    td = TD.YOLODataset(val, nc=3, cache="disk")
    np.testing.assert_array_equal(td.image_shapes(), want_shapes)
    samples = [td(i) for i in range(len(td))]      # writes the sidecars
    # the image files become placeholders: shapes and pixels come from the
    # sidecars alone
    for f in td.im_files:
        Path(f).write_bytes(b"")
    td = TD.YOLODataset(val, nc=3, cache="disk")
    np.testing.assert_array_equal(td.image_shapes(), want_shapes)
    for i, s in enumerate(samples):
        np.testing.assert_array_equal(td(i).img, s.img)


@pytest.mark.parametrize("imgsz", [96, (64, 96), (96, 64), (96, 96)])
def test_val_transforms_match_jax(data_yaml, imgsz):
    jd, td = datasets(data_yaml)
    jt, tt = JA.ValTransforms(imgsz), TA.ValTransforms(imgsz)
    for i in range(len(td)):
        a, b = tt(td, i), jt(jd, i)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("indices", [None, [5, 0, 3, 1, 6], [6, 2]])
def test_loader_batches_match_jax(data_yaml, indices):
    jd, td = datasets(data_yaml)
    kw = dict(max_boxes=8, shuffle=False, workers=3, drop_last=False,
              indices=indices)          # the validators' call
    j = list(JL.DataLoader(jd, JA.ValTransforms(96), 3, **kw))
    t = TL.DataLoader(td, TA.ValTransforms(96), 3, **kw)
    assert t._indices() == JL.DataLoader(jd, None, 3, **kw)._indices()
    got = list(t)
    assert len(got) == len(j) == len(t)
    for a, b in zip(got, j):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # collate alone, with truncation at max_boxes
    items = [TA.ValTransforms(96)(td, i) for i in range(3)]
    for mb in (1, 8):
        a, b = TL.collate(items, mb), JL.collate(items, mb)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_raises_a_transform_error():
    def broken(ds, i, rng):
        raise ValueError("bad item")
    dl = TL.DataLoader(list(range(4)), broken, 2, workers=2)
    with pytest.raises(ValueError, match="bad item"):
        list(dl)


LETTERBOX_CASES = [
    # (image shape, letterbox kwargs): predict's call, the val calls at the
    # rect targets of three aspects, then the options the JAX signature has
    ((480, 640, 3), {"new_shape": 640}),
    ((37, 200, 3), {"new_shape": 128}),
    ((96, 71, 3), {"new_shape": (96, 96), "scaleup": True}),
    ((96, 71, 3), {"new_shape": rect_shape(96, 71, 96), "scaleup": True}),
    ((50, 96, 3), {"new_shape": rect_shape(50, 96, 96), "scaleup": True}),
    ((64, 48, 3), {"new_shape": (128, 96), "scaleup": False}),
    ((300, 200, 3), {"new_shape": 128, "scaleup": False}),
    ((480, 640, 3), {"new_shape": 640, "auto": True}),
    ((37, 200, 3), {"new_shape": (96, 160), "auto": True, "stride": 16}),
    ((40, 60, 3), {"new_shape": 64, "color": 0}),
]


@pytest.mark.parametrize("shape,kw", LETTERBOX_CASES)
def test_letterbox_options_match_jax(shape, kw):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    got, want = TA.letterbox(img, **kw), JA.letterbox(img, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
