"""Torch port vs the JAX package: the train loader's index order, its
per-epoch reshuffle and per-item seeds, and its batches (equal, with the
augmentation off and at the default hyp), on one synthetic dataset."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.data.augment import TrainTransforms as JaxTF  # noqa: E402
from dedark_yolo_tpu.data.dataset import YOLODataset as JaxDS  # noqa: E402
from dedark_yolo_tpu.data.loader import DataLoader as JaxDL  # noqa: E402

from dedark_yolo_tpu_torch.cfg import DEFAULT_CFG, AUGMENT_KEYS  # noqa: E402
from dedark_yolo_tpu_torch.data.augment import TrainTransforms  # noqa: E402
from dedark_yolo_tpu_torch.data.dataset import YOLODataset  # noqa: E402
from dedark_yolo_tpu_torch.data.loader import DataLoader  # noqa: E402

from synth import make_synth_dataset  # noqa: E402

IMGSZ = 64
OFF = {"mosaic": 0.0, "mixup": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0,
       "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0,
       "perspective": 0.0, "flipud": 0.0, "fliplr": 0.0, "photometric": False}


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    make_synth_dataset(root, n_train=11, n_val=1, imgsz=IMGSZ)
    return str(root / "images" / "train")


def _pair(train_dir, hyp, seed, batch=4, fraction=1.0):
    jds = JaxDS(train_dir, imgsz=IMGSZ, nc=3, fraction=fraction)
    tds = YOLODataset(train_dir, imgsz=IMGSZ, nc=3, fraction=fraction)
    jdl = JaxDL(jds, JaxTF(hyp, imgsz=IMGSZ), batch, max_boxes=16, seed=seed,
                workers=2)
    tdl = DataLoader(tds, TrainTransforms(hyp, imgsz=IMGSZ), batch,
                     max_boxes=16, seed=seed, workers=2, shuffle=True)
    return jdl, tdl


@pytest.mark.parametrize("seed", [0, 3])
def test_index_order_and_reshuffle_match_jax(train_dir, seed):
    jdl, tdl = _pair(train_dir, OFF, seed)
    orders = []
    for epoch in range(3):
        jdl.set_epoch(epoch)
        tdl.set_epoch(epoch)
        assert tdl._indices() == jdl._indices()
        assert len(tdl) == len(jdl) == 11 // 4   # drop_last
        orders.append(tdl._indices())
    assert orders[0] != orders[1] != orders[2]   # reshuffled each epoch


def test_fraction_matches_jax(train_dir):
    jdl, tdl = _pair(train_dir, OFF, 0, fraction=0.5)
    assert tdl.dataset.im_files == jdl.dataset.im_files
    assert len(tdl.dataset) == 5


@pytest.mark.parametrize("hyp", [OFF, {k: DEFAULT_CFG[k] for k in AUGMENT_KEYS}],
                         ids=["augmentation_off", "default_hyp"])
def test_batches_match_jax(train_dir, hyp):
    """Two epochs of batches: images, classes and masks equal, boxes
    within 1e-4 px."""
    jdl, tdl = _pair(train_dir, hyp, 1)
    for epoch in range(2):
        jdl.set_epoch(epoch)
        tdl.set_epoch(epoch)
        n = 0
        for jb, tb in zip(jdl, tdl):
            for k in ("img", "cls", "mask_gt"):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            np.testing.assert_allclose(tb["bboxes"], jb["bboxes"], rtol=0,
                                       atol=1e-4 / IMGSZ)
            n += 1
        assert n == len(tdl)
