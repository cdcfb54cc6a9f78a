"""Torch port vs the JAX package: every detect architecture's flax trees
go through `state_dict_from_jax` and back through `state_dict_to_jax` bit
for bit, at scale n (where AsffTribeLevel and MFRU build align convs, which
shift the flax numbering of the AddConvs after them) and at l (where they
build none): the same keys and shapes as the port's module, the same tree
back."""

import numpy as np
import pytest
import jax

torch = pytest.importorskip("torch")

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax, state_dict_to_jax)

from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_arch import ARCHS, jax_template, scaled  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401


@pytest.mark.parametrize("scale", ["n", "l"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_bit_exact(arch, scale):
    name = scaled(arch, scale)
    v = to_plain(randomize(jax_template(name), np.random.default_rng(0)))
    v = {k: v[k] for k in ("params", "batch_stats")}
    with torch.device("meta"):
        m = DetectionModel(model_yaml_load(name), nc=3)
    sd = state_dict_from_jax(v, m)
    assert set(sd) == set(m.state_dict())
    assert all(tuple(sd[k].shape) == tuple(t.shape)
               for k, t in m.state_dict().items())
    back = state_dict_to_jax(sd, m)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
