"""Torch port vs the JAX package: the CLI (`python -m dedark_yolo_tpu_torch`)
and the config checks it runs, on the CPU.

The value parser and `check_cfg_alignment` are held to the JAX package's
on tables of inputs. `val` through the CLI is held to `YOLO(...).val()` of
the port (equal, the same process) and to the JAX CLI's val on the same
.npz and JSON dataset (the results dict within METRIC_TOL, the bar of
tests/test_torch_val.py). Train and predict run through the CLI on a tiny
synthetic dataset; a model the port cannot build yet exits with 1 in every
mode and names its ROADMAP item.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu import __main__ as jax_cli  # noqa: E402
from dedark_yolo_tpu.cfg import DEFAULT_CFG_KEYS as JAX_KEYS  # noqa: E402
from dedark_yolo_tpu.cfg import check_cfg_alignment as jax_alignment  # noqa: E402
from dedark_yolo_tpu.engine import model as jax_model  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch import __main__ as cli  # noqa: E402
from dedark_yolo_tpu_torch import cfg as cfg_module  # noqa: E402
from dedark_yolo_tpu_torch.cfg import (  # noqa: E402
    DEFAULT_CFG, check_cfg_alignment, get_cfg, model_yaml_load)
from dedark_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402

from synth import make_synth_dataset  # noqa: E402
from test_torch_val import tiny_variables  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")
IMGSZ = 96
METRIC_TOL = 1e-6
VAL_KW = ["imgsz=96", "batch=4", "workers=2", "plots=False", "verbose=False"]


def last_results(out):
    line = [ln for ln in out.splitlines() if ln.startswith("results ")][-1]
    return json.loads(line[len("results "):])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JSON dataset of 6 val and 4 train images and a .npz of the tiny
    model (JAX container, numpy-drawn weights)."""
    root = tmp_path_factory.mktemp("cli")
    yaml_path = make_synth_dataset(root / "ds", n_train=4, n_val=6,
                                   imgsz=IMGSZ)
    import yaml
    data = yaml.safe_load(Path(yaml_path).read_text())
    data_json = root / "ds" / "data.json"
    data_json.write_text(json.dumps(data))
    jm, v = tiny_variables()
    npz = root / "tiny.npz"
    jax_save(npz, params=v["params"], batch_stats=v["batch_stats"],
             model_yaml=jm.yaml)
    return root, str(data_json), str(npz)


@pytest.mark.parametrize("text", [
    "true", "False", "none", "Null", "", "3", "-2", "0.5", "1e-3", "640",
    "[1,2]", "[ 0.5 , true, x ]", "[]", "yolov8l.yaml", "cuda:0", "[640]",
    "1.0", "nan", "inf"])
def test_parse_value_matches_jax(text):
    want, got = jax_cli._parse_value(text), cli._parse_value(text)
    if isinstance(want, float) and want != want:
        assert got != got
        return
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("typo", ["epoch", "imgz", "batchsize", "lr", "momentun",
                                  "weight_decy", "dark_parm", "qwerty"])
def test_alignment_refuses_typos_as_jax(typo):
    """Both refuse the typo with the same message and suggestions."""
    with pytest.raises(SyntaxError) as jax_err:
        jax_alignment(JAX_KEYS, {typo: 1})
    with pytest.raises(SyntaxError) as err:
        check_cfg_alignment(DEFAULT_CFG.keys(), {typo: 1})
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(SyntaxError):
        get_cfg(overrides={typo: 1})


def test_unported_keys_refused_as_not_ported():
    """Every key of the JAX package's defaults is a key of the port's: none
    is refused as not ported any more (the `UNPORTED_KEYS` set is gone).
    What the port still refuses is a value, named with its reason: the
    export formats of JAX's toolchain, by the exporter."""
    assert set(DEFAULT_CFG) == JAX_KEYS
    assert not hasattr(cfg_module, "UNPORTED_KEYS")
    for k in sorted(JAX_KEYS):
        jax_alignment(JAX_KEYS, {k: 1})
        check_cfg_alignment(DEFAULT_CFG.keys(), {k: 1})
    from dedark_yolo_tpu_torch.engine.exporter import Exporter
    for fmt, why in (("stablehlo", "JAX package"), ("saved_model", "JAX package"),
                     ("onnx", "ONNX")):
        with pytest.raises((NotImplementedError, RuntimeError), match=why):
            Exporter(get_cfg(overrides={"format": fmt, "device": "cpu"}))(
                DetectionModel(model_yaml_load(TINY), nc=3))


@pytest.mark.parametrize("key,item", [("mesh_shape", "A12i"),
                                      ("mesh_axes", "A12i"),
                                      ("remat", "A12j")])
def test_unported_key_names_its_item(key, item):
    """The keys of A12i (the mesh's data and spatial axes) and A12j (remat)
    are ported: accepted with JAX's defaults and typed; with A12i-d and
    A12j-b nothing of them stays unported: a trainer takes remat on a
    data x spatial mesh (its mesh and remat as set)."""
    check_cfg_alignment(DEFAULT_CFG.keys(), {key: 1})
    assert key in DEFAULT_CFG and item in ("A12i", "A12j")
    assert DEFAULT_CFG[key] == {"mesh_shape": None, "mesh_axes": ["data"],
                                "remat": -1}[key]
    value = {"mesh_shape": [2], "mesh_axes": ["data"], "remat": 5}[key]
    assert getattr(get_cfg(overrides={key: value}), key) == value
    assert cli._parse_value(str(value).replace("'", "").replace(" ", "")) \
        == value
    over = {"mesh_shape": [1, 2], "mesh_axes": ["data", "spatial"],
            "remat": 4, "batch": 2, "imgsz": 64}
    tr = DetectionTrainer(over,
                          model=DetectionModel(model_yaml_load(TINY), nc=3),
                          device="cpu")
    tr._setup_mesh()
    assert (tr.model.remat_upto, tr.mesh.shape, tr.mesh.spatial,
            tr.mesh.spans_ranks) == (4, (1, 2), 2, False)
    assert not hasattr(cfg_module, "UNPORTED_ITEMS")


def test_cli_val_equals_facade_and_jax_cli(setup, capsys, monkeypatch):
    root, data, npz = setup
    rc = cli.entrypoint(["val", f"model={npz}", f"data={data}", "device=cpu",
                         *VAL_KW])
    assert rc == 0
    got = last_results(capsys.readouterr().out)
    want = YOLO(npz, device="cpu").val(data=data, device="cpu", imgsz=IMGSZ,
                                       batch=4, workers=2, plots=False,
                                       verbose=False)
    assert got == {k: float(v) for k, v in want.items()}
    assert got["metrics/mAP50(B)"] > 0

    seen = []
    val = jax_model.YOLO.val
    monkeypatch.setattr(jax_model.YOLO, "val",
                        lambda self, **kw: seen.append(val(self, **kw))
                        or seen[-1])
    assert jax_cli.entrypoint(["val", f"model={npz}", f"data={data}",
                               *VAL_KW]) == 0
    assert set(seen[0]) == set(got)
    for k, v in seen[0].items():
        assert abs(float(v) - got[k]) <= METRIC_TOL, k


def test_cli_train_and_predict(setup, capsys):
    root, data, npz = setup
    project = root / "runs"
    rc = cli.entrypoint(["train", f"model={TINY}", f"data={data}", "epochs=1",
                         "imgsz=64", "batch=2", "nbs=2", "workers=0",
                         "mosaic=0.0", "max_boxes=8", "max_det=20",
                         "max_nms=256", "device=cpu", f"project={project}",
                         "name=cli", "plots=False"])
    assert rc == 0
    res = last_results(capsys.readouterr().out)
    assert set(res) >= {"metrics/mAP50(B)", "fitness"}
    best = project / "cli" / "weights" / "best.npz"
    assert best.is_file()
    img_dir = Path(json.loads(Path(data).read_text())["path"]) / "images" / "val"
    rc = cli.entrypoint(["predict", f"model={best}", f"source={img_dir}",
                         "imgsz=64", "conf=0.001", "max_det=20", "max_nms=256",
                         "device=cpu", f"project={root / 'predict'}"])
    assert rc == 0
    out = last_results(capsys.readouterr().out)
    want = YOLO(str(best), device="cpu").predict(
        str(img_dir), imgsz=64, conf=0.001, max_det=20, max_nms=256,
        device="cpu")
    assert out == {"images": 6, "detections": sum(len(r) for r in want)}
    assert cli.entrypoint(["predict", f"model={best}", "device=cpu"]) == 1


# a user graph with a row that no builder takes, in either package
UNBUILT = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]],
                                 [-1, 1, "ChannelAttention", [16]],
                                 [-1, 1, "Conv", [32, 3, 2]]],
           "head": [[[1, 2], 1, "Detect", ["nc"]]]}


@pytest.mark.parametrize("argv,item", [
    (["val"], "ChannelAttention"), (["export"], "ChannelAttention"),
    (["benchmark"], "ChannelAttention"),
    (["serve", "port=0"], "ChannelAttention"),
    (["track", "source=x"], "ChannelAttention"),
    (["train"], "ChannelAttention"), (["predict", "source=x"],
                                      "ChannelAttention"),
    (["val", "task=detect"], "ChannelAttention")])
def test_unported_modes_and_tasks_exit_nonzero(argv, item, caplog, tmp_path):
    """Every mode and task is ported; a model the port cannot build (a
    graph row no builder takes) exits with 1 in each mode, naming what it
    refuses."""
    path = tmp_path / "unbuilt.json"
    path.write_text(json.dumps(UNBUILT))
    with caplog.at_level("ERROR", logger="dedark_yolo_tpu_torch"):
        assert cli.entrypoint([*argv, f"model={path}", "device=cpu"]) == 1
    assert f"module '{item}'" in caplog.text


def test_bare_token_suggests_and_exits_2(caplog):
    with caplog.at_level("ERROR", logger="dedark_yolo_tpu_torch"):
        assert cli.entrypoint(["vall", "data=x"]) == 2
    assert "did you mean 'val'" in caplog.text
    with pytest.raises(SyntaxError, match="Did you mean"):
        cli.entrypoint(["val", "imgz=64"])


def test_special_commands(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    import dedark_yolo_tpu_torch.utils.settings as settings
    monkeypatch.setattr(settings, "_SETTINGS", None)
    assert cli.entrypoint(["cfg"]) == 0
    assert json.loads(capsys.readouterr().out) == DEFAULT_CFG
    assert cli.entrypoint(["copy-cfg"]) == 0
    copied = tmp_path / "default_copy.json"
    assert vars(get_cfg(overrides={"cfg": str(copied)})) == DEFAULT_CFG
    copied.write_text(json.dumps({**DEFAULT_CFG, "epochs": 7}))
    assert get_cfg(overrides={"cfg": str(copied), "batch": 4}).epochs == 7
    capsys.readouterr()
    assert cli.entrypoint(["settings"]) == 0
    out = capsys.readouterr().out
    st = json.loads(out[out.index("{"):])
    assert st["runs_dir"] == str(tmp_path / "runs")
    assert (tmp_path / "config" / "dedark_yolo_tpu_torch"
            / "settings.json").is_file()
    for cmd in ("version", "checks", "help"):
        assert cli.entrypoint([cmd]) == 0
    out = capsys.readouterr().out
    assert "torch" in out and "nvcc" in out and "numpy" in out


def test_settings_reset_on_corrupt_file(tmp_path):
    from dedark_yolo_tpu_torch.utils.settings import SettingsManager
    f = tmp_path / "s.json"
    st = SettingsManager(f)
    assert json.loads(f.read_text()) == dict(st)
    f.write_text('{"settings_version": "0.0.1"}')
    assert dict(SettingsManager(f)) == st.defaults
    f.write_text("{not json")
    assert dict(SettingsManager(f)) == st.defaults
    st["sync"] = True
    st.save()
    assert SettingsManager(f)["sync"] is True
    np.testing.assert_equal(SettingsManager(f).file, f)
