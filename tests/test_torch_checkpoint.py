"""Torch port vs the JAX package: loading a JAX `.npz` checkpoint.

The JAX package's own `save_checkpoint` writes the tiny model with raw
`params`/`batch_stats` and different `ema`/`ema_bs` trees, and train_args
with names, imgsz, data and contrast_mode. `YOLO(npz, device="cpu")` must
hold exactly `state_dict_from_jax` of the EMA trees, take the names back
with integer keys and the carried train_args, and `.val()` must validate
like the JAX package's `YOLO(npz).val()` (per image and in the results
dict, under test_torch_val's tolerances), in both contrast modes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.engine import validator as jax_validator  # noqa: E402
from dedark_yolo_tpu.engine.model import YOLO as JaxYOLO  # noqa: E402
from dedark_yolo_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.engine import validator  # noqa: E402
from dedark_yolo_tpu_torch.nn.enhance import LowlightRecovery  # noqa: E402
from dedark_yolo_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, section_tree)
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from jax_native import jax_native_letterbox  # noqa: E402,F401
from synth import make_synth_dataset  # noqa: E402
from test_torch_val import (IMGSZ, N_VAL, assert_same_images,  # noqa: E402
                            assert_same_results, record_matches,
                            tiny_variables)

NAMES = {0: "car", 1: "bus", 2: "train"}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One checkpoint per contrast mode, beside a synth dataset."""
    root = tmp_path_factory.mktemp("ckpt")
    data = make_synth_dataset(root / "ds", n_train=0, n_val=N_VAL, imgsz=IMGSZ)
    jm, ema = tiny_variables(seed=0)
    _, raw = tiny_variables(seed=1)
    out = {}
    for mode in ("channel", "reference"):
        out[mode] = save_checkpoint(
            root / f"{mode}.npz", params=raw["params"],
            batch_stats=raw["batch_stats"], ema_params=ema["params"],
            ema_batch_stats=ema["batch_stats"], epoch=3,
            train_args={"names": NAMES, "imgsz": IMGSZ, "data": str(data),
                        "contrast_mode": mode, "batch": 4},
            model_yaml=jm.yaml)
    return out, ema, raw


def test_section_tree_rebuilds_the_flax_trees(checkpoints):
    paths, ema, raw = checkpoints
    meta, flat = load_checkpoint(paths["channel"])
    assert meta["epoch"] == 3 and meta["train_args"]["names"]["0"] == "car"
    for section, tree in (("params", raw["params"]), ("ema", ema["params"]),
                          ("ema_bs", ema["batch_stats"])):
        got = section_tree(flat, section)
        assert sorted(got) == sorted(tree)
        for key, sub in tree.items():
            for leaf_path, arr in _leaves(sub):
                node = got[key]
                for p in leaf_path:
                    node = node[p]
                np.testing.assert_array_equal(node, arr)
    with pytest.raises(KeyError):
        section_tree(flat, "opt")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("mode", ["channel", "reference"])
def test_checkpoint_loads_ema_and_validates_like_jax(checkpoints, mode,
                                                     tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)       # both facades default to runs/detect/val
    paths, ema, raw = checkpoints
    y = YOLO(paths[mode], device="cpu")
    want_sd = state_dict_from_jax(ema, y.model)
    got_sd = y.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    raw_sd = state_dict_from_jax(raw, y.model)
    assert not torch.equal(got_sd["model.1.conv.weight"],
                           raw_sd["model.1.conv.weight"])
    assert y.model.names == NAMES
    assert y.overrides["contrast_mode"] == mode and y.overrides["imgsz"] == IMGSZ

    kw = {"batch": 4, "workers": 2, "plots": False, "verbose": False}
    jrec = record_matches(monkeypatch, jax_validator)
    trec = record_matches(monkeypatch, validator)
    want = JaxYOLO(str(paths[mode])).val(**kw)
    got = y.val(device="cpu", **kw)
    assert all(m.contrast_mode == mode for m in y.model.modules()
               if isinstance(m, LowlightRecovery))
    assert y.validator.args.conf == 0.001 and y.validator.args.imgsz == IMGSZ
    assert_same_images(jrec, trec)
    assert_same_results(want, got)
    assert y.metrics is got
