"""Torch port vs the JAX package: the fork's offline dataset tools, on the
CPU.

The same seeded inputs go through both packages' tools and the files they
write are compared byte for byte: the low-light maker (the port with
device="cpu"), the VOC and COCO converters, autosplit, DatasetStats,
calc_dataset_info; and `check_det_dataset("tielu.yaml")` returns the JAX
package's dict. Each tool that writes under a path it names in its output
(data.yaml, the -hub dir, dataset_status.json) runs on the same paths in
turns: JAX first, its files read and removed, then the port.

The maker's bar is equality: integer exponents multiply in the order of
`jax.lax.integer_pow` (`ops/degrade.py::_integer_pow`), and `torch.pow`
on the CPU gives XLA's f32 result at every uint8 level for the
non-integer exponents here; the uint8 quantisation truncates on both.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from dedark_yolo_tpu.data import check_det_dataset as jax_check  # noqa: E402
from dedark_yolo_tpu.data import coco as jax_coco  # noqa: E402
from dedark_yolo_tpu.data import split as jax_split  # noqa: E402
from dedark_yolo_tpu.data import stats as jax_stats  # noqa: E402
from dedark_yolo_tpu.data import voc as jax_voc  # noqa: E402
from dedark_yolo_tpu.utils import dataset_info as jax_info  # noqa: E402
from dedark_yolo_tpu.utils import lowlight_process as jax_maker  # noqa: E402

from dedark_yolo_tpu_torch.data import coco, split, stats, voc  # noqa: E402
from dedark_yolo_tpu_torch.data.dataset import check_det_dataset  # noqa: E402
from dedark_yolo_tpu_torch.utils import dataset_info, lowlight_process  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_coco_converter import (_rle_compress,  # noqa: E402
                                 _rle_encode_uncompressed)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module runs (the
    suite runs six workers on a few cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tree(root):
    """{relative path: bytes} of every file under root."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def in_turns(jax_fn, port_fn, out):
    """jax_fn() then port_fn(), each writing under `out`: (JAX's return,
    the port's, JAX's files, the port's files); `out` is emptied between."""
    want = jax_fn()
    want_files = tree(out)
    shutil.rmtree(out)
    got = port_fn()
    return want, got, want_files, tree(out)


# ------------------------------------------------------------------ maker
def maker_source(root):
    """Seeded PNGs of two resolutions, one in a nested directory, and one
    file that no decoder reads."""
    rng = np.random.default_rng(3)
    (root / "sub" / "deeper").mkdir(parents=True)
    for i, (h, w) in enumerate([(40, 56), (40, 56), (33, 21), (40, 56)]):
        where = root / "sub" / "deeper" if i == 2 else root
        cv2.imwrite(str(where / f"im{i}.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (root / "sub" / "broken.png").write_bytes(b"not an image")


@pytest.mark.parametrize("param", [7.5, 5])
def test_maker_files_equal_jax(tmp_path, param):
    src = tmp_path / "src"
    maker_source(src)
    n_want, n_got, want, got = in_turns(
        lambda: jax_maker.apply_lowlight_and_save(src, tmp_path / "dark",
                                                  param, batch_size=2),
        lambda: lowlight_process.apply_lowlight_and_save(
            src, tmp_path / "dark", param, batch_size=2, device="cpu"),
        tmp_path / "dark")
    assert n_got == n_want == 4
    assert sorted(got) == sorted(want) == [
        "im0.png", "im1.png", "im3.png", "sub/deeper/im2.png"]
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("param", [7.5, 5, 2.2])
def test_maker_every_level_equals_jax(tmp_path, param):
    """Every uint8 level through both: JAX's tool on a lossless PNG of the
    256 levels, the port's array core on the same array."""
    levels = np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16, 1), 3, 2)
    (tmp_path / "src").mkdir()
    cv2.imwrite(str(tmp_path / "src" / "levels.png"), levels)
    jax_maker.apply_lowlight_and_save(tmp_path / "src", tmp_path / "dark", param)
    want = cv2.imread(str(tmp_path / "dark" / "levels.png"))
    (got,) = lowlight_process.lowlight_batches([levels], param, device="cpu")
    assert got.dtype == np.uint8 and got.shape == levels.shape
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1, 0] == 255 and got[0, 0, 0] == 0


def test_maker_no_images_and_device(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "notes.txt").write_text("no images here")
    for fn, kw in ((jax_maker.apply_lowlight_and_save, {}),
                   (lowlight_process.apply_lowlight_and_save, {"device": "cpu"})):
        with pytest.raises(FileNotFoundError, match="no images"):
            fn(tmp_path / "empty", tmp_path / "out", **kw)
    img = np.zeros((4, 4, 3), np.uint8)
    if not torch.cuda.is_available():     # the card by default, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lowlight_process.lowlight_batches([img])
    # shape groups in first-seen order, outputs in input order
    imgs = [np.full((2, 3, 3), v, np.uint8) for v in (255, 128)]
    imgs.insert(1, np.full((3, 2, 3), 255, np.uint8))
    out = lowlight_process.lowlight_batches(imgs, 2, batch_size=1, device="cpu")
    assert [o.shape for o in out] == [(2, 3, 3), (3, 2, 3), (2, 3, 3)]
    assert [int(o[0, 0, 0]) for o in out] == [255, 255, 64]
    assert lowlight_process.group_by_shape(imgs) == {(2, 3, 3): [0, 2],
                                                     (3, 2, 3): [1]}


# -------------------------------------------------------------------- VOC
VOC_CLASSES = ["person", "debrisflow", "rockfall"]


def voc_object(name, box, difficult=None):
    d = "" if difficult is None else f"<difficult>{difficult}</difficult>"
    return (f"<object><name>{name}</name>{d}<bndbox><xmin>{box[0]}</xmin>"
            f"<ymin>{box[1]}</ymin><xmax>{box[2]}</xmax><ymax>{box[3]}</ymax>"
            "</bndbox></object>")


def voc_tree(root):
    """Annotations of three images: kept, difficult, unknown-class,
    out-of-bounds (clipped) and degenerate objects; a fourth id with no
    XML; images for three of the four ids."""
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / d).mkdir(parents=True)
    objects = {
        "a1": [voc_object("person", (10, 20, 110, 220)),
               voc_object("rockfall", (-15, 5, 60.5, 40), difficult=0),
               voc_object("person", (30, 30, 80, 90), difficult=1),
               voc_object("car", (1, 1, 50, 50))],
        "a2": [voc_object("debrisflow", (300, 100, 420, 260)),
               voc_object("rockfall", (50, 50, 50, 80)),
               voc_object("rockfall", (500, 10, 600, 30))],
        "a3": [voc_object("rockfall", (0, 0, 400, 300))],
    }
    for iid, objs in objects.items():
        (root / "Annotations" / f"{iid}.xml").write_text(
            f"<annotation><size><width>400</width><height>300</height>"
            f"<depth>3</depth></size>{''.join(objs)}</annotation>")
    rng = np.random.default_rng(1)
    for iid in ("a1", "a2", "a4"):
        cv2.imwrite(str(root / "JPEGImages" / f"{iid}.jpg"),
                    rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    (root / "ImageSets" / "Main" / "train.txt").write_text("a1\na2 1\n\n")
    (root / "ImageSets" / "Main" / "val.txt").write_text("a3\na4\n")


def test_voc_converter_equals_jax(tmp_path):
    voc_tree(tmp_path / "voc")
    out = tmp_path / "yolo"
    args = (tmp_path / "voc", out, VOC_CLASSES)
    want_yaml, got_yaml, want, got = in_turns(
        lambda: jax_voc.convert_voc_to_yolo(*args),
        lambda: voc.convert_voc_to_yolo(*args), out)
    assert got_yaml == want_yaml == out / "data.yaml"
    assert sorted(got) == sorted(want)
    assert got == want
    assert got["labels/train/a1.txt"].decode().splitlines() == [
        "0 0.150000 0.400000 0.250000 0.666667",
        "2 0.075625 0.075000 0.151250 0.116667"]
    assert got["labels/val/a4.txt"] == b""
    assert "images/train/a1.jpg" in got and "images/val/a4.jpg" in got
    for box in ((10, 20, 110, 220), (-5, 0, 30, 10)):
        assert voc.convert_box((400, 300), box) == jax_voc.convert_box(
            (400, 300), box)


# -------------------------------------------------------------- autosplit
@pytest.mark.parametrize("seed, weights, annotated_only", [
    (0, (0.9, 0.1, 0.0), False), (7, (0.5, 0.3, 0.2), True)])
def test_autosplit_equals_jax(tmp_path, seed, weights, annotated_only):
    root = tmp_path / "ds"
    (root / "images" / "a").mkdir(parents=True)
    (root / "labels" / "a").mkdir(parents=True)
    for k in range(30):
        sub = "a" if k % 3 else ""
        (root / "images" / sub / f"{k}.jpg").write_bytes(b"")
        if k % 4:
            (root / "labels" / sub / f"{k}.txt").write_text("0 0.5 0.5 0.1 0.1\n")
    (root / "autosplit_val.txt").write_text("stale\n")
    outs = []
    for fn in (jax_split.autosplit, split.autosplit):
        paths = fn(root / "images", weights, annotated_only, seed)
        outs.append({p.name: p.read_text() if p.is_file() else None
                     for p in paths})
    assert outs[1] == outs[0]
    listed = sum(len((t or "").splitlines()) for t in outs[1].values())
    assert listed == (22 if annotated_only else 30)
    assert "stale" not in outs[1]["autosplit_val.txt"]


# ------------------------------------------------------------------- COCO
def test_coco_helpers_equal_jax():
    assert coco.coco91_to_coco80_class() == jax_coco.coco91_to_coco80_class()
    mask = np.zeros((13, 9), np.uint8)
    mask[2:8, 1:5] = 1
    mask[10:12, 6:9] = 1
    rle = _rle_encode_uncompressed(mask)
    comp = {"size": rle["size"], "counts": _rle_compress(rle["counts"])}
    text = {"size": rle["size"], "counts": comp["counts"].decode("ascii")}
    for r in (rle, comp, text):
        got = coco.rle_decode(r)
        np.testing.assert_array_equal(got, jax_coco.rle_decode(r))
        np.testing.assert_array_equal(got, mask)
    assert coco.rle2polygon(rle) == jax_coco.rle2polygon(rle)
    parts = [[0, 0, 10, 0, 10, 10, 0, 10], [20, 0, 30, 0, 30, 10, 20, 10],
             [12, 30, 18, 30, 15, 40]]
    for segs in (parts[:2], parts):
        got, want = coco.merge_multi_segment(segs), jax_coco.merge_multi_segment(segs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    a, b = np.array(parts[0]).reshape(-1, 2), np.array(parts[2]).reshape(-1, 2)
    assert coco._min_index(a, b) == jax_coco._min_index(a, b)


def coco_annotations(root):
    """The JAX test's fixture (tests/test_coco_converter.py) plus a
    box-only annotation beside segmented ones, a duplicate box, an unused
    91-id and a second split."""
    root.mkdir()
    mask = np.zeros((100, 200), np.uint8)
    mask[10:30, 20:60] = 1
    rle = _rle_encode_uncompressed(mask)
    data = {
        "images": [{"id": 7, "height": 100, "width": 200, "file_name": "im7.jpg"},
                   {"id": 8, "height": 100, "width": 200, "file_name": "im8.jpg"},
                   {"id": 9, "height": 64, "width": 48,
                    "file_name": "sub/im9.jpg"}],
        "annotations": [
            {"image_id": 7, "category_id": 13, "iscrowd": 0,
             "bbox": [20, 10, 40, 20]},
            {"image_id": 7, "category_id": 1, "iscrowd": 0,
             "bbox": [0, 0, 20, 20],
             "segmentation": [[0, 0, 20, 0, 20, 20], [40, 0, 60, 0, 60, 20]]},
            {"image_id": 8, "category_id": 1, "iscrowd": 0,
             "bbox": [20, 10, 40, 20], "segmentation": rle},
            {"image_id": 8, "category_id": 1, "iscrowd": 1,
             "bbox": [0, 0, 50, 50]},
            {"image_id": 8, "category_id": 1, "iscrowd": 0,
             "bbox": [5, 5, 0, 10]},
            {"image_id": 9, "category_id": 90, "bbox": [3.3, 4.1, 10.7, 20.2],
             "segmentation": [[3.3, 4.1, 14, 4.1, 14, 24.3]]},
            {"image_id": 9, "category_id": 90, "bbox": [3.3, 4.1, 10.7, 20.2]},
            {"image_id": 9, "category_id": 12, "bbox": [1, 1, 5, 5]},
            {"image_id": 9, "category_id": 2, "bbox": [30, 40, 8, 9]},
        ],
    }
    (root / "instances_val.json").write_text(json.dumps(data))
    train = {"images": data["images"][:1], "annotations": data["annotations"][:2]}
    (root / "instances_train.json").write_text(json.dumps(train))


@pytest.mark.parametrize("kw", [{}, {"use_segments": True},
                                {"use_segments": True, "cls91to80": False}],
                         ids=["boxes", "segments", "segments_91"])
def test_convert_coco_equals_jax(tmp_path, kw):
    coco_annotations(tmp_path / "ann")
    out = tmp_path / "out"
    want_dir, got_dir, want, got = in_turns(
        lambda: jax_coco.convert_coco(tmp_path / "ann", out, **kw),
        lambda: coco.convert_coco(tmp_path / "ann", out, **kw), out)
    assert got_dir == want_dir == out
    assert sorted(got) == ["labels/train/im7.txt", "labels/val/im7.txt",
                           "labels/val/im8.txt", "labels/val/sub/im9.txt"]
    assert got == want
    with pytest.raises(FileNotFoundError, match="no COCO json"):
        coco.convert_coco(tmp_path / "out", tmp_path / "x")


# ------------------------------------------------------------ the stats
def test_dataset_stats_equal_jax(tmp_path):
    yp = make_synth_dataset(tmp_path / "ds", n_train=4, n_val=3, imgsz=96, nc=3)
    hub = Path(str(tmp_path / "ds") + "-hub")
    want, got, want_files, got_files = in_turns(
        lambda: jax_stats.DatasetStats(yp).get_json(save=True),
        lambda: stats.DatasetStats(yp).get_json(save=True), hub)
    assert json.dumps(got) == json.dumps(want)
    assert got_files == want_files and list(got_files) == ["stats.json"]
    # the compressed previews
    shutil.rmtree(hub)
    _, _, want_files, got_files = in_turns(
        lambda: jax_stats.DatasetStats(yp).process_images(),
        lambda: stats.DatasetStats(yp).process_images(), hub)
    assert len(got_files) == 7 and got_files == want_files
    # a zip of the dataset: the same JSON, unzipped beside it
    z = stats.zip_directory(tmp_path / "ds")
    assert z.read_bytes() == jax_stats.zip_directory(tmp_path / "ds").read_bytes()
    shutil.move(str(tmp_path / "ds"), str(tmp_path / "moved"))
    want = jax_stats.DatasetStats(z).get_json()
    shutil.rmtree(tmp_path / "ds")
    got = stats.DatasetStats(z).get_json()
    assert json.dumps(got) == json.dumps(want)
    assert got["train"]["image_stats"]["total"] == 4


def test_compress_one_image_cv2_fallback(tmp_path):
    """A file Pillow cannot open (Radiance HDR) goes through OpenCV, as
    in JAX, and is resized to max_dim with INTER_AREA."""
    rng = np.random.default_rng(2)
    src = tmp_path / "big.hdr"
    cv2.imwrite(str(src), rng.random((50, 2000, 3)).astype(np.float32))
    outs = []
    for mod in (jax_stats, stats):
        dst = tmp_path / f"{mod.__name__.split('.')[0]}.jpg"
        mod.compress_one_image(src, dst, max_dim=500)
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1]
    assert cv2.imread(str(tmp_path / "dedark_yolo_tpu_torch.jpg")).shape == (12, 500, 3)


def test_calc_dataset_info_equals_jax(tmp_path):
    yp = make_synth_dataset(tmp_path / "ds", n_train=6, n_val=2, imgsz=96, nc=3)
    out = tmp_path / "ds" / "dataset_status.json"
    for split_name in ("train", "val"):
        want = jax_info.calc_dataset_info(str(yp), split=split_name)
        want_text = out.read_text()
        out.unlink()
        got = dataset_info.calc_dataset_info(str(yp), split=split_name)
        assert got == want and out.read_text() == want_text
    explicit = tmp_path / "info.json"
    got = dataset_info.calc_dataset_info(str(yp), "train", str(explicit))
    assert json.loads(explicit.read_text()) == got
    assert got["total_images"] == 6


def test_packaged_card_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)             # the card's path is relative
    got, want = check_det_dataset("tielu.yaml"), jax_check("tielu.yaml")
    assert got == want
    assert got["val"] == "../datasets/tielu-yolo/images/test_dark"
    assert got["nc"] == 3 and got["test"] is None
    # a file of that name wins over the card
    (tmp_path / "tielu.yaml").write_text('{"path": "here", "val": "v", '
                                         '"names": ["a"]}')
    assert check_det_dataset("tielu.yaml") == jax_check("tielu.yaml")
    assert check_det_dataset("tielu.yaml")["val"] == "here/v"


def test_tools_import_without_host_packages(tmp_path):
    """The port's data package, the tools and the plots import with
    PyYAML, OpenCV and matplotlib hidden; the packaged card resolves; a
    matplotlib plot draws nothing; a tool that needs a missing package
    raises an ImportError naming it."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.png").write_bytes(b"")
    code = f"""
import sys
for m in ("yaml", "cv2", "matplotlib", "matplotlib.pyplot"):
    sys.modules[m] = None
import numpy as np
import dedark_yolo_tpu_torch.data as data
from dedark_yolo_tpu_torch.data import coco, split, stats, voc
from dedark_yolo_tpu_torch.data.dataset import check_det_dataset
from dedark_yolo_tpu_torch.utils import dataset_info, lowlight_process, plotting
assert data.convert_coco is coco.convert_coco
assert data.convert_voc_to_yolo is voc.convert_voc_to_yolo
assert check_det_dataset("tielu.yaml")["nc"] == 3
assert not plotting.matplotlib_available()
out = {str(tmp_path)!r} + "/pr.png"
assert plotting.plot_pr_curve(np.linspace(0, 1, 1000), [], np.zeros((0, 10)), out) is None
assert plotting.plot_labels(np.zeros((1, 4)), [0], save_dir={str(tmp_path)!r}) is None
for fn, args, name in ((voc.convert_voc_to_yolo, ("a", "b", ["x"]), "PyYAML"),
                       (coco.rle2polygon, ({{"size": [2, 2], "counts": [4]}},), "OpenCV"),
                       (lowlight_process.apply_lowlight_and_save,
                        ({str(tmp_path / "src")!r}, {str(tmp_path / "x")!r}), "OpenCV")):
    try:
        fn(*args)
    except ImportError as e:
        assert name in str(e), e
    else:
        raise AssertionError(fn)
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    assert not (tmp_path / "pr.png").exists()
