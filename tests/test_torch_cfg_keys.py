"""The port's `get_cfg` against the JAX package's, key by key.

Every key of JAX's `cfg/default.yaml` (one case each) and each of JAX's
three deprecated aliases: the default and an override of each come out of
the port's `get_cfg` with JAX's value and type (`format`'s default is the
port's 'pt2', JAX's 'stablehlo', on the allowlist of
tests/test_torch_surface.py). A config file as the base (`cfg=`) and as a
nested override (`overrides={"cfg": ...}`) gives JAX's namespace on every
key; the namespace iterates, has `get` and prints as JAX's; JAX's call
forms work; a typo among the overrides raises JAX's message.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu import cfg as J  # noqa: E402

from dedark_yolo_tpu_torch import cfg as T  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while the module runs. Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# keys the port types beyond JAX (ints it coerces, its own string checks):
# an override of the kind both take
PORT_TYPED = {"imgsz": 320, "remat": 2, "ckpt_period": 2, "val_period": 2,
              "pose": 10.0, "kobj": 2.0, "contrast_mode": "reference",
              "prior_mode": "computed", "cache": "disk",
              "matmul_precision": "float32", "mesh_shape": [1],
              "mesh_axes": ["data", "spatial"], "tracker": "bytetrack.yaml",
              "data": "data.json", "project": "runs", "name": "x",
              "pretrained": "w.npz", "format": "npz"}


def override_for(key):
    """An override value of `key` unlike its default, typed as a CLI or a
    script would give it, so that JAX's coercion shows."""
    if key in PORT_TYPED:
        return PORT_TYPED[key]
    if key == "cfg":                        # a file name; None loads none
        return None
    d = J.DEFAULT_CFG_DICT[key]
    if isinstance(d, bool):
        return not d
    if key in J.CFG_INT_KEYS:
        return float((d or 0) + 2)          # 3.0 -> 3
    if key in J.CFG_FLOAT_KEYS:
        return int(d) + 1                   # 16 -> 16.0
    if key in J.CFG_FRACTION_KEYS:
        return 1                            # 1 -> 1.0
    if d is None:
        return "None"                       # -> None
    return d


def typed(v):
    return (type(v).__name__, v)


@pytest.mark.parametrize("key", sorted(J.DEFAULT_CFG_KEYS))
def test_key_takes_jax_value(key):
    port, jax_ = T.get_cfg(), J.get_cfg()
    if key != "format":
        assert typed(port.get(key)) == typed(jax_.get(key))
    v = override_for(key)
    got = T.get_cfg(overrides={key: v}).get(key)
    want = J.get_cfg(J.DEFAULT_CFG_DICT, {key: v}).get(key)
    assert typed(got) == typed(want), (key, v)


@pytest.mark.parametrize("alias,value,key,want", [
    ("hide_labels", True, "show_labels", False),
    ("hide_labels", "False", "show_labels", True),
    ("hide_conf", False, "show_conf", True),
    ("hide_conf", True, "show_conf", False),
    ("line_thickness", 3, "line_width", 3),
    ("line_thickness", 2.0, "line_width", 2),
])
def test_alias_maps_as_jax(alias, value, key, want, caplog):
    jax_ = J.get_cfg(J.DEFAULT_CFG_DICT, {alias: value})
    with caplog.at_level("WARNING", logger="dedark_yolo_tpu_torch"):
        port = T.get_cfg(overrides={alias: value})
    assert typed(port.get(key)) == typed(jax_.get(key)) == typed(want)
    assert alias not in vars(port) and "deprecated" in caplog.text


def test_jax_config_file_as_base_and_as_nested_override():
    """JAX's own default.yaml (what its copy-cfg writes), as `cfg` and as
    an override's `cfg` key: JAX's namespace on every key, `format`
    included, in the file's order."""
    path = str(J.DEFAULT_CFG_PATH)
    want = J.get_cfg(path)
    got = T.get_cfg(path)
    assert [typed(v) for v in vars(got).items()] == \
        [typed(v) for v in vars(want).items()]
    assert str(got) == str(want) and got.format == "stablehlo"
    nested = T.get_cfg(overrides={"cfg": path, "batch": 4})
    jnested = J.get_cfg(J.DEFAULT_CFG_DICT, {"cfg": path, "batch": 4})
    assert vars(nested) == vars(jnested) and nested.batch == 4
    assert T.get_cfg(cfg=path, overrides={"conf": 0.5}).conf == 0.5


def test_namespace_iterates_and_gets_as_jax(tmp_path):
    port, jax_ = T.get_cfg(), J.get_cfg()
    assert isinstance(port, T.IterableSimpleNamespace)
    assert set(dict(port)) == set(dict(jax_)) == T.DEFAULT_CFG_KEYS
    assert dict(port) == {**dict(jax_), "format": "pt2"}
    assert port.get("conf") is jax_.get("conf") is None
    assert port.get("no_such_key", 7) == jax_.get("no_such_key", 7) == 7
    assert [ln.split("=")[0] for ln in str(port).splitlines()] == list(
        vars(port))
    # JAX's call forms: positional base and overrides, overrides alone, a
    # namespace as the base, a JSON file the port's copy-cfg writes
    assert T.get_cfg(T.DEFAULT_CFG_DICT, {"batch": 2}).batch == 2
    assert T.get_cfg(overrides={"batch": 2}).batch == 2
    assert T.get_cfg(port, {"iou": 0.5}).iou == 0.5
    f = tmp_path / "c.json"
    f.write_text(json.dumps({**T.DEFAULT_CFG, "epochs": 3}))
    assert T.get_cfg(str(f)).epochs == 3
    assert T.DEFAULT_CFG_DICT is T.DEFAULT_CFG
    for name in ("CFG_FLOAT_KEYS", "CFG_FRACTION_KEYS", "CFG_INT_KEYS",
                 "CFG_BOOL_KEYS", "DEFAULT_CFG_KEYS"):
        assert getattr(T, name) == getattr(J, name), name


@pytest.mark.parametrize("typo", ["imgz", "confidence", "hide_label", "epoch"])
def test_typo_raises_jax_message(typo):
    with pytest.raises(SyntaxError) as want:
        J.get_cfg(J.DEFAULT_CFG_DICT, {typo: 1})
    with pytest.raises(SyntaxError) as got:
        T.get_cfg(overrides={typo: 1})
    assert str(got.value) == str(want.value)


def test_port_checks_stay():
    """The port's own checks beside JAX's: imgsz a multiple of 32, its
    string keys' choices, a bool where JAX wants one."""
    with pytest.raises(ValueError, match="multiple of 32"):
        T.get_cfg(overrides={"imgsz": 100})
    with pytest.raises(ValueError):
        T.get_cfg(overrides={"contrast_mode": "rgb"})
    for k, v in (("half", 1), ("deterministic", "yes")):
        with pytest.raises(TypeError):
            T.get_cfg(overrides={k: v})
