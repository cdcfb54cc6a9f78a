"""Torch port vs the JAX package: the Segment head, its weights and its loss
(CPU, f32), on JAX's `SEG_TINY` (tests/test_segment_task.py), on
`SEG_TINY_L0` (the same rows under a `lowlight_recovery` row 0) and on
`yolov8-seg.yaml`, with numpy-seeded weights drawn into the flax trees.
Bars, each with its reason:
  - parameter counts at n/s/m/l/x, the weight round trip: exact;
  - eval outputs (boxes, scores, coef_flat, protos) at 64 and 96: boxes
    4e-4 px, scores, coefficients and protos 1e-5 absolute (f32
    convolutions summing in another order than XLA's, as
    tests/test_torch_zoo_graphs.py);
  - the loss: items 2e-5 relative, gradients of the maps and protos 1e-5
    of the largest (the same reason; the top-k and the assignment are
    integer choices made equal by the equal inputs);
  - one accumulation window of the trainer: tests/test_torch_train_slice.py's
    bars (loss 3e-5 relative; BN stats and EMA 2e-6; momentum buffers 2e-3
    of their largest; parameters and EMA 1e-6 plus 1e-3 of the largest
    move).
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dedark_yolo_tpu.cfg import DEFAULT_CFG_DICT, get_cfg as jax_get_cfg  # noqa: E402
from dedark_yolo_tpu.cfg import model_yaml_load as jax_yaml_load  # noqa: E402
from dedark_yolo_tpu.engine import segment as JSeg  # noqa: E402
from dedark_yolo_tpu.engine.optim import (  # noqa: E402
    init_opt_state as jax_init_opt, label_params as jax_labels)
from dedark_yolo_tpu.losses import segment as JL  # noqa: E402
from dedark_yolo_tpu.nn.graph import DetectionModel as JaxModel  # noqa: E402
from dedark_yolo_tpu.utils.ema import ema_init as jax_ema_init  # noqa: E402

from dedark_yolo_tpu_torch.cfg import model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.engine.segment import SegmentationTrainer  # noqa: E402
from dedark_yolo_tpu_torch.losses import segment as TL  # noqa: E402
from dedark_yolo_tpu_torch.nn.graph import DetectionModel  # noqa: E402
from dedark_yolo_tpu_torch.utils.weights import (  # noqa: E402
    init_weights, opt_state_from_jax, state_dict_from_jax, state_dict_to_jax)

from test_segment_task import SEG_TINY  # noqa: E402
from test_torch_layers import randomize, to_plain  # noqa: E402
from test_torch_zoo_blocks import few_threads  # noqa: E402,F401
from test_torch_train_slice import close  # noqa: E402


def with_layer0(d):
    """`d` with a lowlight_recovery row 0 and every later index shifted."""
    d = copy.deepcopy(d)
    shift = lambda f: [x if x == -1 else x + 1 for x in f] \
        if isinstance(f, list) else (f if f == -1 else f + 1)
    d["backbone"] = [[-1, 1, "lowlight_recovery", [3]]] + [
        [shift(f), n, m, a] for f, n, m, a in d["backbone"]]
    d["head"] = [[shift(f), n, m, a] for f, n, m, a in d["head"]]
    return d


SEG_TINY_L0 = with_layer0(SEG_TINY)
GRAPHS = {"tiny": SEG_TINY, "tiny_l0": SEG_TINY_L0}
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5}


def jax_variables(jm, imgsz=64, seed=0):
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, imgsz, imgsz, 3),
                                                   jnp.float32))
    return to_plain(randomize(template, np.random.default_rng(seed)))


def seg_pair(d, seed=0):
    jm = JaxModel(copy.deepcopy(d))
    v = jax_variables(jm, seed=seed)
    tm = DetectionModel(copy.deepcopy(d)).eval()
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("scale", list("nsmlx"))
def test_param_counts_equal_jax(scale):
    name = f"yolov8{scale}-seg.yaml"
    jm = JaxModel(jax_yaml_load(name))
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = DetectionModel(model_yaml_load(name))
    assert tm.task == jm.task == "segment" and tm.nc == 80
    assert tm.head["args"] == jm.head["args"]
    assert sum(p.numel() for p in tm.parameters()) == want


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_weights_round_trip(graph):
    """flax -> the port -> flax, equal; the proto's transposed conv kernel
    is (I, O, kh, kw) and mirrored in both spatial axes."""
    jm, v, tm = seg_pair(GRAPHS[graph])
    back = state_dict_to_jax(tm.state_dict(), tm)
    for section in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(v[section])
        got = dict(jax.tree_util.tree_leaves_with_path(back[section]))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf)
    head = len(tm.specs) - 1
    k = v["params"][f"mods_{head}"]["Proto_0"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(
        tm.state_dict()[f"model.{head}.proto.upsample.weight"].numpy(),
        np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def test_unflipped_transposed_kernel_breaks_protos():
    """The flip is needed: the same kernel only transposed gives other
    protos (the check that fails if the map drops the flip)."""
    jm, v, tm = seg_pair(SEG_TINY)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.eval_outputs(v, jnp.asarray(x))[3])
    head = len(tm.specs) - 1
    sd = tm.state_dict()
    k = v["params"][f"mods_{head}"]["Proto_0"]["ConvTranspose_0"]["kernel"]
    sd[f"model.{head}.proto.upsample.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))
    bad = copy.deepcopy(tm)
    bad.load_state_dict(sd)
    with torch.no_grad():
        good = tm.eval_outputs(torch.from_numpy(x))[3].numpy()
        wrong = bad.eval_outputs(torch.from_numpy(x))[3].numpy()
    np.testing.assert_allclose(good, want, rtol=0, atol=1e-5)
    assert np.abs(wrong - want).max() > 1e-2


@pytest.mark.parametrize("imgsz", [64, 96])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_eval_outputs_match_jax(graph, imgsz):
    jm, v, tm = seg_pair(GRAPHS[graph])
    x = np.random.default_rng(imgsz).uniform(0, 1, (2, imgsz, imgsz, 3)
                                             ).astype(np.float32)
    want = [np.asarray(o) for o in jm.eval_outputs(v, jnp.asarray(x))]
    with torch.no_grad():
        got = [o.numpy() for o in tm.eval_outputs(torch.from_numpy(x))]
    n = (imgsz // 8) ** 2 * (1 + 1 / 4 + 1 / 16)
    assert got[0].shape == (2, n, 4) and got[2].shape == (2, n, 8)
    assert got[3].shape == (2, imgsz // 4, imgsz // 4, 8)
    for g, w, tol in zip(got, want, (4e-4, 1e-5, 1e-5, 1e-5)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def _loss_inputs(b=2, nm=8, nc=3, key=0, fg=True):
    rng = np.random.default_rng(key)
    shapes = [(8, 8), (4, 4), (2, 2)]
    raw = [rng.normal(0, 1.0, (b, h, w, 64 + nc)).astype(np.float32)
           for h, w in shapes]
    coefs = [rng.normal(0, 0.5, (b, h, w, nm)).astype(np.float32)
             for h, w in shapes]
    protos = rng.normal(0, 0.5, (b, 16, 16, nm)).astype(np.float32)
    m = 4
    batch = {"cls": rng.integers(0, nc, (b, m)).astype(np.float32),
             "bboxes": rng.uniform(0.25, 0.6, (b, m, 4)).astype(np.float32),
             "mask_gt": np.concatenate([np.ones((b, m - 1)),
                                        np.zeros((b, 1))], 1).astype(np.float32)}
    if not fg:
        batch["mask_gt"][:] = 0
    return raw, coefs, protos, batch


@pytest.mark.parametrize("case", ["overlap", "per_instance", "no_fg"])
def test_loss_items_and_grads_match_jax(case):
    """segmentation_loss on the same maps, coefficients, protos and labels
    (JAX tests/test_seg_pose_loss.py's shapes): items and the gradients of
    every input."""
    raw, coefs, protos, batch = _loss_inputs(fg=case != "no_fg")
    b, m = batch["cls"].shape
    overlap = case != "per_instance"
    if overlap:
        masks = np.zeros((b, 16, 16), np.float32)
        masks[:, :5] = 1
        masks[:, 5:10, 3:12] = 2
        masks[:, 11:, :7] = 3
    else:
        masks = (np.random.default_rng(2).uniform(0, 1, (b, m, 16, 16)) > 0.5
                 ).astype(np.float32)
    batch["masks"] = masks

    def jf(raw, coefs, protos):
        t, items = JL.segmentation_loss(
            raw, coefs, protos, {k: jnp.asarray(a) for k, a in batch.items()},
            nc=3, strides=[8, 16, 32], hyp=HYP, max_fg=16, overlap=overlap)
        return t, items

    (jt, jitems), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(r) for r in raw], [jnp.asarray(c) for c in coefs],
        jnp.asarray(protos))
    traw = [torch.tensor(r, requires_grad=True) for r in raw]
    tco = [torch.tensor(c, requires_grad=True) for c in coefs]
    tpr = torch.tensor(protos, requires_grad=True)
    total, items = TL.segmentation_loss(
        traw, tco, tpr, {k: torch.from_numpy(a) for k, a in batch.items()},
        nc=3, strides=[8, 16, 32], hyp=HYP, max_fg=16, overlap=overlap)
    want = np.asarray([float(jitems[k]) for k in ("box", "seg", "cls", "dfl")])
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), want,
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=2e-5)
    if case == "no_fg":
        assert float(items.seg) == 0.0
    grads = torch.autograd.grad(total, traw + tco + [tpr], allow_unused=True)
    wants = list(jg[0]) + list(jg[1]) + [jg[2]]
    for g, w in zip(grads, wants):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-5)


def test_topk_fg_ties_take_the_lower_index():
    """Equal summed scores: the lower anchor index first, as lax.top_k."""
    from dedark_yolo_tpu.losses.tal import AssignResult as JaxAssign
    ts = np.zeros((1, 10, 2), np.float32)
    ts[0, [1, 3, 4, 7], 0] = 0.5
    fg = np.zeros((1, 10), bool)
    fg[0, [1, 3, 4, 7, 8]] = True
    j = JaxAssign(jnp.zeros((1, 10), jnp.int32), jnp.zeros((1, 10, 4)),
                  jnp.asarray(ts), jnp.asarray(fg), jnp.zeros((1, 10), jnp.int32))
    from dedark_yolo_tpu_torch.losses.tal import AssignResult
    t = AssignResult(
        torch.zeros(1, 10, dtype=torch.int32), torch.zeros(1, 10, 4),
        torch.from_numpy(ts), torch.from_numpy(fg),
        torch.zeros(1, 10, dtype=torch.int32))
    ji, jw = JL._topk_fg(j, 6)
    ti, tw = TL._topk_fg(t, 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _seg_batches(b=2, s=64, m=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        masks = np.zeros((b, s // 4, s // 4), np.float32)
        masks[:, 2:8, 2:9] = 1
        masks[:, 6:13, 8:15] = 2
        out.append({"img": rng.integers(0, 256, (b, s, s, 3), np.uint8),
                    "cls": rng.integers(0, 2, (b, m)).astype(np.float32),
                    "bboxes": rng.uniform(0.25, 0.6, (b, m, 4)).astype(np.float32),
                    "mask_gt": np.concatenate([np.ones((b, m - 1)),
                                               np.zeros((b, 1))], 1
                                              ).astype(np.float32),
                    "masks": masks})
    return out


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_train_window_matches_jax(graph):
    """One accumulation window (two micro-steps of b2, nbs 4) at 64:
    SegmentationTrainer.step against JAX's tree-path train_step of its
    SegmentationTrainer, SGD inside the warmup ramp."""
    steps, nb = (37, 38), 20
    overrides = {"batch": 2, "nbs": 4, "epochs": 10, "imgsz": 64,
                 "optimizer": "SGD", "lr0": 0.02, "max_boxes": 4}
    d = GRAPHS[graph]
    jm, v, tm = seg_pair(d)
    jt = JSeg.SegmentationTrainer.__new__(JSeg.SegmentationTrainer)
    jt.args = jax_get_cfg(DEFAULT_CFG_DICT, overrides)
    jt.data = {"nc": 2}
    jt.build_optimizer(nb)
    jt._opt_spec = None
    step = jt.make_train_step(jm, jax_labels(v["params"]))
    jp, jbs = v["params"], v["batch_stats"]
    jopt = jax_init_opt(jp)
    jema = {"params": jax_ema_init(jp), "batch_stats": jax_ema_init(jbs)}
    jeu = jnp.int32(0)

    tt = SegmentationTrainer(overrides, model=tm, nb=nb, device="cpu")
    assert (tt.opt_name, tt.accumulate) == (jt.opt_name, jt.accumulate)
    for i, batch in zip(steps, _seg_batches()):
        jp, jbs, jopt, jema, jeu, jtotal, jitems = step(
            jp, jbs, jopt, jema, jeu,
            {k: jnp.asarray(a) for k, a in batch.items()},
            jnp.float32(jt._lr_at(i, "bias")),
            jnp.float32(jt._lr_at(i, "weight")),
            jnp.float32(jt._momentum_at(i)))
        total, items = tt.step(batch, i)
        np.testing.assert_allclose(items.numpy(), np.stack(jitems), rtol=3e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=3e-5)
    assert tt.opt_state.step == int(jopt.step) == 1 and tt.ema_updates == 1

    want = state_dict_from_jax({"params": jp, "batch_stats": jbs}, tm)
    want_ema = state_dict_from_jax(jema, tm)
    start = state_dict_from_jax(v, tm)
    jbuf = opt_state_from_jax(jopt, tm)
    got = tm.state_dict()
    for k, w in want.items():
        if "running_" in k:
            close(got[k], w, 2e-6, k)
            close(tt.ema[k], want_ema[k], 2e-6, k)
            continue
        if jbuf.buf[k].abs().max() > 0:
            close(tt.opt_state.buf[k], jbuf.buf[k],
                  2e-3 * float(jbuf.buf[k].abs().max()), k)
        tol = 1e-6 + 1e-3 * float((w - start[k]).abs().max())
        close(got[k], w, tol, k)
        close(tt.ema[k], want_ema[k], tol, k)


def test_get_model_seeds_and_refuses_other_tasks():
    """JAX's form: the trainer builds the `model` key's architecture at the
    nc of `data` with seeded weights; another task's architecture raises."""
    over = {"model": "yolov8n-seg.yaml", "data": {"nc": 3}, "device": "cpu"}
    net = SegmentationTrainer(over).model
    assert net.task == "segment" and net.nc == 3
    ref = DetectionModel(model_yaml_load("yolov8n-seg.yaml"), nc=3)
    init_weights(ref, 0)
    for k, t in ref.state_dict().items():
        assert torch.equal(net.state_dict()[k], t), k
    with pytest.raises(ValueError, match="segment"):
        SegmentationTrainer({**over, "model": "yolov8n.yaml"})
