"""Torch port vs the JAX package: the detect architectures' structure.

Every detect yaml of the JAX package builds in the port with JAX's
parameter count (`jax.eval_shape` of init against the port's module built
on the meta device): the flagship and `yolov8-mfru-rbf-asff` (the widest
spread of align convs) at every scale token, the others at n (align convs)
and l (none); with AsffTribeLevel's and MFRU's
align convs where the widths differ; the port's Python-data copies load as
JAX's `model_yaml_load` reads the yamls; the facade builds each variant and
`info()` and `perform.flops_params` carry it; the rows no builder takes
(ChannelAttention, SpatialAttention, an unknown name) raise, naming them
(RT-DETR's head and AIFI build: tests/test_torch_rtdetr_head.py).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import model_yaml_load as jax_model_yaml_load  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.perform import flops_params  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401
from test_torch_zoo_graphs import STRIDES  # noqa: E402

ARCHS = list(STRIDES) + ["yolov8ori"]


def scaled(arch, scale):
    return arch.replace("yolov8", "yolov8" + scale) + ".yaml"


def jax_template(name, nc=3):
    jm = JaxModel(jax_model_yaml_load(name), nc=nc)
    return jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))


@pytest.mark.parametrize("arch,scale", [
    (a, s) for a in ARCHS for s in
    ("nsmlx" if a in ("yolov8", "yolov8-mfru-rbf-asff") else "nl")])
def test_param_count_equals_jax(arch, scale):
    name = scaled(arch, scale)
    want = sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(jax_template(name)["params"]))
    with torch.device("meta"):
        m = DetectionModel(model_yaml_load(name), nc=3)
    assert sum(p.numel() for p in m.parameters()) == want


def test_align_convs_where_widths_differ():
    """Scales n, s, m give P5 another width than P4 in these graphs: the
    ASFF levels 0 and 1 and MFRU build their align convs there, l and x
    none."""
    for scale, want in zip("nsmlx", (True, True, True, False, False)):
        with torch.device("meta"):
            m = DetectionModel(model_yaml_load(
                scaled("yolov8-mfru-rbf-asff", scale)), nc=3)
        mfru, asff0, asff1 = (m.model[s.i] for s in m.specs
                              if s.name in ("MFRU", "AsffTribeLevel")
                              and s.args[:1] != (2,))
        assert hasattr(mfru, "align_level_1") == want
        assert hasattr(asff0, "align_level_1") == want
        assert hasattr(asff1, "align_level_0") == want


@pytest.mark.parametrize("scale", ["", "n", "l"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_data_equals_jax_yaml(arch, scale):
    """cfg/models.py's copy, as the port's model_yaml_load returns it, is
    what JAX's model_yaml_load reads from the yaml."""
    name = scaled(arch, scale)
    assert model_yaml_load(name) == jax_model_yaml_load(name)


@pytest.mark.parametrize("arch", list(STRIDES))
def test_facade_builds_and_counts(arch):
    """YOLO(name) at scale n with seeded weights on the CPU: every tensor
    set (the module is built on the meta device, so an uninitialised one
    would hold garbage), info() its parameter count, the head's strides;
    perform.flops_params counts the yaml's own nc."""
    name = scaled(arch, "n")
    m = YOLO(name, nc=3, device="cpu", seed=0)
    assert m.info()[1] == sum(p.numel() for p in m.model.parameters())
    assert tuple(m.model.strides) == STRIDES[arch]
    assert all(torch.isfinite(p).all() for p in m.model.state_dict().values())
    n, flops = flops_params(name, imgsz=64, device="cpu")
    with torch.device("meta"):
        own_nc = DetectionModel(model_yaml_load(name))
    assert n == sum(p.numel() for p in own_nc.parameters()) and flops > 0


def _with_row(block, args):
    """A tiny detect graph with one `block` row before its head: a row the
    port does not build (ChannelAttention and SpatialAttention, which JAX's
    graph has no module for either; a name neither package knows)."""
    return {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "Conv", [32, 3, 2]],
                                  [-1, 1, block, args],
                                  [-1, 1, "Conv", [32, 3, 2]]],
            "head": [[[2, 3], 1, "Detect", ["nc"]]]}


@pytest.mark.parametrize("arch,head", [
    ("ChannelAttention", "ChannelAttention"),
    ("SpatialAttention", "SpatialAttention"),
    ("DeformConv", "DeformConv")])
def test_other_heads_raise(arch, head, tmp_path):
    """The rows the port does not build raise when it builds the graph,
    naming them, from DetectionModel and from YOLO."""
    path = tmp_path / f"{arch}.json"
    path.write_text(json.dumps(_with_row(arch, [32])))
    with pytest.raises(NotImplementedError, match=head):
        DetectionModel(model_yaml_load(path), nc=3)
    with pytest.raises(NotImplementedError, match=head):
        YOLO(str(path), device="cpu")
