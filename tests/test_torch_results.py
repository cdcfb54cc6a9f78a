"""Torch port vs the JAX package: Results and Boxes (JAX
engine/results.py:15-295, the detect task) and the drawing behind them
(JAX utils/plotting.py:147-211), on the same detections.

Both packages' Results are built from one image and one (n, 6) array (and
a tracked (n, 7) one), so every comparison is exact: `plot` arrays bit for
bit under each plot option, `save` and `save_crop` files byte for byte,
`save_txt` files, `tojson`, `verbose`, the box views, indexing, `new` and
`update`. The feature grids of `visualize` come out byte-equal PNGs. A
host without OpenCV or matplotlib (the module set to None) gets an
ImportError naming the package from each call that draws or encodes, and
none from those that do not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from dedark_yolo_tpu.engine.results import Results as JaxResults  # noqa: E402
from dedark_yolo_tpu.utils.plotting import (  # noqa: E402
    feature_visualization as jax_features)

from dedark_yolo_tpu_torch.engine.results import Boxes, Results  # noqa: E402
from dedark_yolo_tpu_torch.utils.plotting import feature_visualization  # noqa: E402

NAMES = {0: "car", 1: "bus", 2: "train"}


@pytest.fixture(scope="module")
def dets():
    """An RGB frame and 7 detections on it: boxes that leave the frame, a
    zero score (not drawn), every class."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    xy = rng.uniform(-10, 150, (7, 2))
    wh = rng.uniform(5, 60, (7, 2))
    d = np.concatenate([xy, xy + wh, rng.uniform(0.05, 1, (7, 1)),
                        rng.integers(0, 3, (7, 1))], 1).astype(np.float32)
    d[3, 4] = 0.0
    return img, d


def both(img, d, path="frame.jpg"):
    return (JaxResults(orig_img=img, path=path, names=NAMES, boxes=d),
            Results(orig_img=img, path=path, names=NAMES, boxes=d))


@pytest.mark.parametrize("kw", [
    {}, {"line_width": 1}, {"boxes": False}, {"conf": False},
    {"labels": False}, {"show_conf": False, "line_thickness": 4},
    {"show_boxes": False}], ids=lambda kw: ",".join(kw) or "default")
def test_plot_bit_equal(dets, kw):
    w, g = both(*dets)
    np.testing.assert_array_equal(g.plot(**kw), w.plot(**kw))


def test_tracked_boxes_and_plot(dets):
    img, d = dets
    d7 = np.concatenate([d[:, :4], np.arange(7, dtype=np.float32)[:, None] + 3,
                         d[:, 4:]], 1)
    w, g = both(img, d7)
    assert g.boxes.is_track and w.boxes.is_track
    np.testing.assert_array_equal(g.boxes.id, w.boxes.id)
    np.testing.assert_array_equal(g.plot(), w.plot())
    assert g.tojson() == w.tojson()
    assert Boxes(np.zeros((0, 7)), (4, 4)).is_track
    assert Boxes(d, (4, 4)).id is None


def test_box_views_index_and_update(dets):
    img, d = dets
    w, g = both(img, d)
    for name in ("xyxy", "conf", "cls", "xywh", "xyxyn", "xywhn", "data"):
        a, b = getattr(g.boxes, name), getattr(w.boxes, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert g.boxes.cpu().numpy().to("cpu") is g.boxes
    assert g.boxes.shape == (7, 6) and len(g) == len(w) == 7
    with pytest.raises(NotImplementedError):
        g.boxes.cuda()
    assert g.keys == ["boxes"] and w.keys == ["boxes"]
    for idx in (slice(1, 4), [0, 5], np.array([True] * 3 + [False] * 4), 2):
        gi, wi = g[idx], w[idx]
        np.testing.assert_array_equal(gi.boxes.data, wi.boxes.data)
        assert gi.speed is g.speed and gi.path == wi.path
    assert len(g.new()) == len(w.new()) == 0 and g.new().path == "frame.jpg"
    g.update(boxes=d[:2])
    w.update(boxes=d[:2])
    np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
    assert g.verbose() == w.verbose()


def test_verbose_tojson_and_save_txt(dets, tmp_path):
    img, d = dets
    for rows in (d, d[:1], d[:0]):
        w, g = both(img, rows)
        assert g.verbose() == w.verbose()
        assert g.tojson() == w.tojson()
        for conf in (False, True):
            jt = w.save_txt(tmp_path / f"j{len(rows)}{conf}.txt", conf)
            tt = g.save_txt(tmp_path / f"t{len(rows)}{conf}.txt", conf)
            assert tt.read_text() == jt.read_text()


def test_save_and_save_crop_files_equal(dets, tmp_path):
    img, d = dets
    w, g = both(img, d, path="dir/frame.jpg")
    w.save(tmp_path / "j" / "a.jpg", line_width=2)
    g.save(tmp_path / "t" / "a.jpg", line_width=2)
    assert (tmp_path / "t" / "a.jpg").read_bytes() == \
        (tmp_path / "j" / "a.jpg").read_bytes()
    for _ in range(2):       # the second time every name is taken
        nj = w.save_crop(tmp_path / "jc")
        nt = g.save_crop(tmp_path / "tc")
        assert nt == nj > 0
    jfiles = sorted(p.relative_to(tmp_path / "jc") for p in
                    (tmp_path / "jc").rglob("*.jpg"))
    tfiles = sorted(p.relative_to(tmp_path / "tc") for p in
                    (tmp_path / "tc").rglob("*.jpg"))
    assert tfiles == jfiles and len(tfiles) == 2 * nj
    for f in jfiles:
        assert (tmp_path / "tc" / f).read_bytes() == \
            (tmp_path / "jc" / f).read_bytes(), f


def test_feature_grids_equal(tmp_path):
    rng = np.random.default_rng(1)
    caps = {0: rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32),
            3: rng.normal(0, 1, (1, 8, 8, 32)).astype(np.float32),
            7: rng.normal(0, 1, (1, 4, 4, 12)).astype(np.float32)}
    jax_features(caps, tmp_path / "j")
    feature_visualization(caps, tmp_path / "t")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == [f"stage{i}_features.png" for i in (0, 3, 7)]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_missing_packages_raise_naming_them(dets, tmp_path, monkeypatch):
    img, d = dets
    g = Results(orig_img=img, path="x.jpg", names=NAMES, boxes=d,
                enhanced_img=np.zeros((8, 8, 3), np.float32))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    for call in (g.plot, lambda: g.save(tmp_path / "a.jpg"),
                 lambda: g.save_crop(tmp_path)):
        with pytest.raises(ImportError, match=r"OpenCV \(cv2\)"):
            call()
    with pytest.raises(ImportError, match="matplotlib"):
        feature_visualization({0: np.zeros((1, 4, 4, 3))}, tmp_path / "f")
    # the in-memory outputs need neither
    assert g.tojson() and g.verbose() and g.enhanced_img.shape == (8, 8, 3)
    g.save_txt(tmp_path / "a.txt", save_conf=True)
    assert len((tmp_path / "a.txt").read_text().splitlines()) == 7
