"""Row-sharded inference (dedark_yolo_tpu_torch/parallel/spatial.py) on the
CPU against the port's unsharded forward and the JAX package.

A mesh of repeated CPU devices (`make_mesh(devices=["cpu"] * n)`) holds
every slab, as JAX's tests shard over virtual host devices. The tiny model
(tests/tiny_model.yaml) on numpy-seeded JAX trees carried across by
`state_dict_from_jax`: `spatial_infer` at 128 over 2 and 4 slabs and at 64
over 2 (P5's slabs one row each, narrower than SPPF's 2-row halo) against
the port's `eval_outputs` (boxes within 1e-4 px, scores within 1e-6, the
detections after NMS equal) and against JAX's `apply_eval` on the same
trees (the bars the unsharded port meets, tests/test_torch_model.py:
4e-4 px, 1e-6), and at 128 over 2 against JAX's own `spatial_infer` on two
virtual devices. Then layer 0 on slabs in both contrast modes and the
256-row resize of tall slabs bit-equal to the whole image's, the
SCConv/RFB/ASFF zoo graph (group norms and channel means over H x W) and
the every-block graph of tests/test_torch_layers_rest_graphs.py (HGStem's
bottom pad, Focus, SPP, CBAM, C3TR joined, ConvTranspose's uneven slabs)
against the unsharded forward, RT-DETR's joined decoder, and the raises:
an H off the 32 * n rule, a slab with no output row, an op that mixes
rows, a mesh that is not local.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from dedark_yolo_tpu.parallel import spatial_infer as jax_spatial_infer  # noqa: E402
from dedark_yolo_tpu.parallel import spatial_pad_to as jax_spatial_pad_to  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.nn.enhance import (  # noqa: E402
    LowlightRecovery, torch_bilinear_resize)
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.ops.nms import non_max_suppression  # noqa: E402
from dedark_yolo_tpu_torch.parallel import (  # noqa: E402
    make_mesh, spatial_infer, spatial_pad_to)
from dedark_yolo_tpu_torch.parallel import spatial as S  # noqa: E402
from dedark_yolo_tpu_torch.tools.enhance_ab import TOL  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

from test_torch_layers_rest_graphs import EVERY  # noqa: E402
from test_torch_val import tiny_variables  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401

BOX_TOL, SCORE_TOL = 1e-4, 1e-6          # against the unsharded port
JAX_BOX_TOL, JAX_SCORE_TOL = 4e-4, 1e-6  # against JAX (the unsharded bars)
NMS_ARGS = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, max_nms=2048,
                multi_label=False)


def mesh_of(n):
    return make_mesh(devices=["cpu"] * n, axes=("spatial",))


def image(h, w=None, b=2, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, h, w or h, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jm, v = tiny_variables(seed=0)
    tm = DetectionModel(model_yaml_load("tests/tiny_model.yaml"), nc=3).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm


def seeded(graph, imgsz=64, seed=0):
    """The port's model of `graph` with numpy-seeded weights and BN stats."""
    tm = DetectionModel(copy.deepcopy(graph), nc=3, imgsz=imgsz).eval()
    rng = np.random.default_rng(seed)
    sd = tm.state_dict()
    for k, v in sd.items():
        if k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)))
        elif v.is_floating_point():
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape)))
    return tm


def unsharded(tm, img):
    with torch.inference_mode():
        return tm.eval_outputs(torch.from_numpy(img))


def assert_outputs_close(got, want, box_tol=BOX_TOL, score_tol=SCORE_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=box_tol)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0,
                               atol=score_tol)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=box_tol)


def test_spatial_pad_to_matches_jax():
    for h in (1, 31, 32, 33, 64, 127, 640, 721, 1080, 2160, 4000):
        for n in (1, 2, 3, 4, 8):
            for stride in (32, 64):
                assert spatial_pad_to(h, n, stride) == \
                    jax_spatial_pad_to(h, n, stride), (h, n, stride)
    assert spatial_pad_to(2160, 4) == 2176


@pytest.mark.parametrize("h,n", [(128, 2), (128, 4), (64, 2)])
def test_tiny_against_unsharded_and_jax(tiny, h, n):
    jm, v, tm = tiny
    img = image(h)
    want = unsharded(tm, img)
    got = spatial_infer(tm, img, mesh_of(n))
    assert_outputs_close(got, want)
    wd, wc = non_max_suppression(*want, **NMS_ARGS)
    gd, gc = non_max_suppression(*got, **NMS_ARGS)
    assert int(wc.min()) > 0
    np.testing.assert_array_equal(gc.numpy(), wc.numpy())
    for i, k in enumerate(wc.tolist()):
        np.testing.assert_allclose(gd[i, :k].numpy(), wd[i, :k].numpy(),
                                   rtol=0, atol=BOX_TOL)
    jb, js = jax.jit(lambda var, x: jm.apply_eval(var, x))(
        v, jnp.asarray(img))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jb), rtol=0,
                               atol=JAX_BOX_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(js), rtol=0,
                               atol=JAX_SCORE_TOL)


def test_against_jax_spatial_infer(tiny):
    """JAX's own row-sharded inference on two virtual host devices."""
    jm, v, tm = tiny
    img = image(128, b=1)
    jb, js = jax_spatial_infer(
        jm, v, img, mesh=jax_make_mesh(devices=jax.devices()[:2],
                                       axes=("spatial",)))
    tb, ts = spatial_infer(tm, img, mesh_of(2))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=JAX_BOX_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=JAX_SCORE_TOL)


def slabs_of(img, n):
    return S.row_slabs(torch.from_numpy(img), [torch.device("cpu")] * n)


@pytest.mark.parametrize("mode", ["channel", "reference"])
def test_layer0_on_slabs(mode):
    torch.manual_seed(0)
    mod = LowlightRecovery(mode).eval()
    img = image(128, 96)
    with torch.inference_mode():
        want = mod(torch.from_numpy(img))
        got = mod(slabs_of(img, 4))
        assert isinstance(got, S.RowSlabs) and got.bounds == [0, 32, 64, 96,
                                                               128]
        got = got.join()
    atol, rtol = TOL["float32"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("h,n", [(256, 2), (320, 2), (640, 4), (1088, 2),
                                 (2176, 4)])
def test_resize_rows_bit_equal(h, n):
    """Layer 0's 256-row resize, band by band from the slabs' rows, equals
    the resize of the whole image bit for bit."""
    img = image(h, 40, b=2, seed=h)
    want = torch_bilinear_resize(torch.from_numpy(img), 256, 256)
    got = S._resize_rows(slabs_of(img, n))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name,h,n", [
    ("yolov8n-mfru-rbf-asff.yaml", 128, 4), ("every", 64, 2),
    ("tests/tiny_rtdetr.yaml", 128, 2), ("yolov8n-seg.yaml", 64, 2)])
def test_graphs_against_unsharded(name, h, n):
    """SCConv's group norms and CRU's means over every slab, RFB's dilated
    convs, ASFF's pools; the every-block graph; RT-DETR's AIFI and decoder
    on joined maps; Proto's transposed conv in uneven slabs."""
    graph = EVERY if name == "every" else model_yaml_load(name)
    tm = seeded(graph, imgsz=h)
    img = image(h)
    assert_outputs_close(spatial_infer(tm, img, mesh_of(n)),
                         unsharded(tm, img))


def test_refusals(tiny):
    _, _, tm = tiny
    with pytest.raises(ValueError, match=r"must divide 32 \* 2 devices "
                                         r"\(use spatial_pad_to\)"):
        spatial_infer(tm, image(96), mesh_of(2))
    p6 = seeded(model_yaml_load("yolov8n-p6.yaml"), imgsz=64)
    with pytest.raises(ValueError, match="too short"):
        spatial_infer(p6, image(64), mesh_of(2))
    with pytest.raises(TypeError, match="devices="):
        spatial_infer(tm, image(64), mesh=object())
    x = slabs_of(image(64), 2).permute(0, 3, 1, 2)
    with pytest.raises(NotImplementedError, match="flip"):
        torch.flip(x, [2])
    with pytest.raises(NotImplementedError, match="along their rows"):
        torch.cat([x, x], 2)
    with pytest.raises(NotImplementedError, match="moves their rows"):
        x.reshape(2, 3, -1)
    with pytest.raises(NotImplementedError, match="along their rows"):
        torch.ones(64, 1) * x
    # a reduction over the rows sums every slab
    np.testing.assert_allclose(x.mean((2, 3)).numpy(),
                               x.join().mean((2, 3)).numpy(), rtol=1e-6)
