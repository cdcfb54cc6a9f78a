"""Model-dict parser and the DetectionModel walk (JAX nn/graph.py).

`parse_model` is a copy of the JAX package's (graph.py:145-278): the same
`[from, repeats, module, args]` schema and channel rules as the reference
(ultralytics/nn/tasks.py:803-921). `DetectionModel` builds one torch module
per row and walks them with the save-list (graph.py:484-551), in the plain
form: no lazy upsample/concat, space-to-depth stem or FPN fuse, which are
exact rewrites of the same params in the JAX package. `remat_upto` (the
trainer's `remat` key, JAX graph.py:384-402, :520-541) recomputes the
layers up to that index in the backward instead of keeping their
activations, in training only. Every
row JAX's `_build_module` takes builds here (graph.py:281-381) but the
attention rows JAX builds no module for (ChannelAttention,
SpatialAttention); a non-repeat row of n > 1 is n modules in a chain. The
heads are Detect, AsffDetect and RTDETRDecoder (task 'detect'), Classify
(task 'classify'), Segment (task 'segment') and Pose (task 'pose'); `task`
is JAX's (graph.py:575-576).

Layout: the image enters NHWC in [0, 1]; layer 0 (lowlight_recovery) works
on NHWC, the backbone on NCHW (a permuted view, so channels_last memory);
the head returns per-level (B, H, W, 4*reg_max + nc) maps (Segment: also
the (B, H, W, nm) coefficient maps and the NHWC protos; Pose: also the
(B, H, W, nk * kdim) keypoint maps); RTDETRDecoder its (B, nq, 4 + nc)
queries in eval and its loss's dict in train. `forward` can
also return layers' activations (`capture`, NHWC as JAX's), and `tta_eval`
is JAX's test-time augmentation (graph.py:621-665).
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .enhance import LowlightRecovery, torch_bilinear_resize
from .heads import (AsffDetect, Detect, Pose, RTDETRDecoder, Segment,
                    decode_detections, decode_keypoints)
from .transformer import AIFI


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


@dataclass(frozen=True)
class LayerSpec:
    i: int                      # layer index
    f: Tuple[int, ...]          # from-layer indices (-1 = previous)
    n: int                      # effective repeats (after depth scaling)
    name: str                   # module name from the architecture
    args: Tuple[Any, ...]       # resolved constructor args
    c2: int                     # output channels
    stride: int                 # cumulative spatial stride of the output


_CONVLIKE = {
    "Conv", "ConvTranspose", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
    "SPPF", "DWConv", "Focus", "BottleneckCSP", "C1", "C2", "C2f", "C3", "C3Ghost",
    "C3x", "C3TR", "RepC3", "FasterC2f_N", "FasterC2f", "PconvBottleneck",
    "PconvBottleneck_n", "SCConvBottleneck", "SCC2f", "SC_PW_Bottleneck",
    "SC_PW_C2f", "SC_Conv3_Bottleneck", "SC_Conv3_C2f", "Conv3_SC_C2f",
    "Conv3_SC_Bottleneck", "SC_PW_PW_C2f", "Classify",
}
_REPEAT_BLOCKS = {
    "BottleneckCSP", "C1", "C2", "C2f", "C3", "C3Ghost", "C3x", "C3TR", "RepC3",
    "FasterC2f_N", "FasterC2f", "SCC2f", "SC_PW_C2f", "SC_Conv3_C2f",
    "Conv3_SC_C2f", "SC_PW_PW_C2f",
}
C2F_FAMILY = {
    "C2f": "standard", "FasterC2f": "pconv", "FasterC2f_N": "pconv_n",
    "SCC2f": "scconv", "SC_PW_C2f": "sc_pw", "SC_Conv3_C2f": "sc_conv3",
    "Conv3_SC_C2f": "conv3_sc", "SC_PW_PW_C2f": "sc_pw_pw",
}
_HEADS = {"Detect", "AsffDetect", "Segment", "Pose", "RTDETRDecoder"}
# rows a remat never wraps: the heads and the functional rows (graph.py:
# 509-541 calls them outside its lifted remat)
_NO_REMAT = _HEADS | {"nn.Upsample", "Concat", "nn.BatchNorm2d"}
# head -> task (JAX graph.py:575-576); heads not listed are detect's
TASKS = {"Classify": "classify", "Segment": "segment", "Pose": "pose"}
_STRIDE2 = {"Focus", "HGStem"}


def parse_model(d: dict, ch: int = 3, verbose: bool = False):
    """Parse a model dict into (specs, savelist, head_info); `verbose`
    prints a row a layer, as JAX's does (nn/graph.py:273-274)."""
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        scale = d.get("scale") or tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    ch_list: List[int] = [ch]
    stride_list: List[int] = [1]
    specs: List[LayerSpec] = []
    save: List[int] = []
    head = None

    rows = list(d["backbone"]) + list(d["head"])
    for i, (f, n, m, args) in enumerate(rows):
        f_tuple = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        f_tuple = tuple(x if x == -1 else x % i for x in f_tuple)
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, list):
                args[j] = tuple(a)
            if isinstance(a, str):
                if a == "nc":
                    args[j] = nc
                elif a in ("None", "none"):
                    args[j] = None
                elif a in ("True", "False"):
                    args[j] = a == "True"
        n_eff = max(round(n * depth), 1) if n > 1 else n

        def in_ch(fi):
            return ch_list[fi] if fi != -1 else ch_list[-1]

        def in_stride(fi):
            return stride_list[fi] if fi != -1 else stride_list[-1]

        c1 = in_ch(f_tuple[0])
        stride = in_stride(f_tuple[0])

        if m == "Classify" and i == len(rows) - 1:
            head = {"name": "Classify", "nc": args[0], "strides": (stride,),
                    "from": f_tuple, "ch": (c1,), "index": i}
            c2 = args[0]
        elif m in _CONVLIKE:
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c2, *args[1:]]
            if m in _REPEAT_BLOCKS:
                args.insert(1, n_eff)
                n_eff = 1
            s = args[2] if m in ("Conv", "DWConv") and len(args) > 2 else 1
            if m in _STRIDE2:
                s = 2 if m == "Focus" else 4
            if m == "ConvTranspose":
                stride = max(stride // (args[2] if len(args) > 2 else 2), 1)
            else:
                stride = stride * (s if isinstance(s, int) else 1)
        elif m in ("HGStem",):
            c2 = args[1]
            stride = stride * 4
        elif m in ("HGBlock",):
            c2 = args[1]
            args.insert(3, n_eff)
            n_eff = 1
        elif m == "nn.Upsample":
            c2 = c1
            sf = int(args[1]) if len(args) > 1 and args[1] else 2
            stride = max(stride // sf, 1)
        elif m == "nn.BatchNorm2d":
            c2 = c1
        elif m == "Concat":
            c2 = sum(in_ch(x) for x in f_tuple)
        elif m == "lowlight_recovery":
            c2 = args[0]
        elif m == "MFRU":
            c2 = in_ch(f_tuple[2])
            stride = in_stride(f_tuple[2])
        elif m in ("AsffDoubLevel", "AsffTribeLevel"):
            c2 = in_ch(f_tuple[args[0]])
            stride = in_stride(f_tuple[args[0]])
        elif m == "RFBblock":
            c2 = (c1 // 4) * 4
        elif m in ("PConv",):
            c2 = c1
        elif m in ("SCConv",):
            c2 = c1
            args = [c1, *args[1:]]
        elif m in _HEADS:
            ch_ins = [in_ch(x) for x in f_tuple]
            strides_in = tuple(in_stride(x) for x in f_tuple)
            if m == "Segment" and len(args) > 2:
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            head = {"name": m, "nc": args[0], "strides": strides_in,
                    "from": f_tuple, "ch": tuple(ch_ins), "index": i,
                    "args": tuple(args)}
            c2 = 0
        elif m == "AIFI":
            c2 = c1
            args = [c1, *args]
        elif m in ("CBAM", "ChannelAttention", "SpatialAttention"):
            c2 = c1
        else:
            raise NotImplementedError(f"module '{m}' not supported by parse_model")

        specs.append(LayerSpec(i=i, f=f_tuple, n=n_eff, name=m,
                               args=tuple(args), c2=c2, stride=stride))
        if verbose:
            print(f"{i:>3} {str(f_tuple):>18} {n_eff:>3} {m:<20} {args} "
                  f"-> c2={c2} s={stride}")
        save.extend(x % i for x in f_tuple if x != -1)
        if i == 0:
            ch_list = []
            stride_list = []
        ch_list.append(c2)
        stride_list.append(stride)

    if head is None:
        raise ValueError("model yaml has no Detect head")
    return tuple(specs), sorted(set(save)), head


def layer_inputs(specs) -> List[List[int]]:
    """Each row's input channel counts, in its `f` order."""
    outs, prev, cins = [], 3, []
    for s in specs:
        cins.append([prev if f == -1 else outs[f] for f in s.f])
        outs.append(s.c2)
        prev = s.c2
    return cins


def _build_module(spec: LayerSpec, cins: List[int], head: dict) -> nn.Module:
    """The torch module of one row; `cins` are its inputs' channel counts
    (JAX graph.py:281-381, with the args JAX's `_build_module` drops dropped
    here too: Conv's p; DWConv's d and act; ConvTranspose's p; Focus's s;
    Bottleneck's all but c2; C3Ghost's shortcut; HGBlock's lightconv and
    shortcut; CBAM's k). A non-repeat row of n > 1 chains n distinct
    modules (JAX graph.py:469-477). C3TR's position table is sized by
    `DetectionModel`."""
    if chained(spec):
        one = LayerSpec(spec.i, spec.f, 1, spec.name, spec.args, spec.c2,
                        spec.stride)
        return nn.Sequential(*(_build_module(one, cins, head)
                               for _ in range(spec.n)))
    name, a, c1 = spec.name, list(spec.args), cins[0]
    arg = lambda j, default: a[j] if len(a) > j else default
    if name == "Conv":
        return L.Conv(c1, a[0], arg(1, 1), arg(2, 1))
    if name == "DWConv":
        return L.DWConv(c1, a[0], arg(1, 1), arg(2, 1))
    if name == "ConvTranspose":
        return L.ConvTranspose(c1, a[0], arg(1, 2), arg(2, 2))
    if name == "Focus":
        return L.Focus(c1, a[0], arg(1, 1))
    if name == "GhostConv":
        return L.GhostConv(c1, a[0], arg(1, 1), arg(2, 1))
    if name in C2F_FAMILY:
        return L.C2f(c1, a[0], a[1], shortcut=arg(2, False),
                     bottleneck_kind=C2F_FAMILY[name])
    if name == "C1":
        return L.C1(c1, a[0], a[1])
    if name == "C2":
        return L.C2(c1, a[0], a[1], shortcut=arg(2, True))
    if name in ("C3", "C3x", "BottleneckCSP"):
        return getattr(L, name)(c1, a[0], a[1], arg(2, True))
    if name == "C3TR":
        return L.C3TR(c1, a[0], a[1])
    if name == "C3Ghost":
        return L.C3Ghost(c1, a[0], a[1])
    if name == "RepC3":
        return L.RepC3(c1, a[0], a[1])
    if name == "Bottleneck":
        return L.Bottleneck(c1, a[0])
    if name == "GhostBottleneck":
        return L.GhostBottleneck(c1, a[0], arg(1, 3), arg(2, 1))
    if name == "SPP":
        return L.SPP(c1, a[0], tuple(arg(1, (5, 9, 13))))
    if name == "SPPF":
        return L.SPPF(c1, a[0], arg(1, 5))
    if name == "HGStem":
        return L.HGStem(c1, a[0], a[1])
    if name == "HGBlock":
        return L.HGBlock(c1, a[0], a[1], arg(2, 3), a[3])
    if name == "CBAM":
        return L.CBAM(c1)
    if name == "AIFI":
        return AIFI(a[0])
    if name in ("ChannelAttention", "SpatialAttention"):
        raise NotImplementedError(
            f"module '{name}' is built by no graph row (the JAX "
            "package's graph builds none either)")
    if name == "lowlight_recovery":
        if spec.i != 0:
            raise NotImplementedError("lowlight_recovery must be row 0")
        return LowlightRecovery()
    if name == "AsffTribeLevel":
        return L.AsffTribeLevel(a[0], cins)
    if name == "AsffDoubLevel":
        return L.AsffDoubLevel(a[0], cins)
    if name == "MFRU":
        return L.MFRU(cins)
    if name == "RFBblock":
        return L.RFBblock(c1)
    if name == "PConv":
        return L.PConv(c1, arg(1, 4))
    if name == "SCConv":
        return L.SCConv(a[0])
    if name == "Classify":
        return L.Classify(c1, a[0], arg(1, 1), arg(2, 1))
    if name == "Segment":
        ha = head.get("args", ())
        return Segment(head["nc"], cins, head["strides"],
                       nm=ha[1] if len(ha) > 1 else 32,
                       npr=ha[2] if len(ha) > 2 else 256)
    if name == "Pose":
        ha = head.get("args", ())
        return Pose(head["nc"], cins, head["strides"],
                    kpt_shape=tuple(ha[1]) if len(ha) > 1 and ha[1]
                    else (17, 3))
    if name == "RTDETRDecoder":
        # the optional args after nc: [nc, hd, nq, ndl] (JAX graph.py:
        # 369-378; the reference's signature order)
        ha = head.get("args", ())
        return RTDETRDecoder(head["nc"], cins, head["strides"],
                             hd=ha[1] if len(ha) > 1 else 256,
                             nq=ha[2] if len(ha) > 2 else 300,
                             ndl=ha[3] if len(ha) > 3 else 6)
    if name in ("Detect", "AsffDetect"):
        return (Detect if name == "Detect" else AsffDetect)(
            head["nc"], cins, head["strides"])
    if name == "nn.Upsample":
        return L.Upsample(int(a[1]) if len(a) > 1 and a[1] else 2)
    if name == "Concat":
        return L.Concat()
    raise NotImplementedError(f"module '{name}' is not ported to torch yet")


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute runs BN
    on the batch statistics without moving its running stats, so they
    move once a step (JAX's lifted remat passes batch_stats through)."""
    return contextlib.nullcontext(), L.frozen_running_stats()


def remat_call(mod, *args):
    """`mod(*args)` under `torch.utils.checkpoint` (non-reentrant): the
    backward recomputes the module's activations instead of keeping them.
    The weights the module holds now (under `torch.func.functional_call`,
    amp's bf16 casts, which are gone from the module by the backward) go in
    as inputs, so the recompute runs on them and their gradients flow
    back through the casts. Row slabs (`parallel/spatial.py`) go in as
    they are: the recompute runs the module on them again, halo exchanges
    and BN's moment sums included (across ranks every rank reaches its
    recompute at the same point of the backward, so the collectives
    match), its BN running stats frozen."""
    names, tensors = zip(*mod.named_parameters())
    k = len(names)

    def run(*flat):
        return torch.func.functional_call(mod, dict(zip(names, flat[:k])),
                                          flat[k:])
    return checkpoint(run, *tensors, *args, use_reentrant=False,
                      context_fn=_remat_contexts)


def chained(spec: LayerSpec) -> bool:
    """Whether row `spec` is n distinct modules in a chain (`model.{i}.{k}`,
    flax `mods_{i}_{k}`)."""
    return spec.n > 1 and spec.name not in _REPEAT_BLOCKS


def require_detect(model, what):
    """Raise for a model (or AutoBackend) of another task than detect:
    `what` reads boxes and scores."""
    task = getattr(model, "task", "detect")
    if task != "detect":
        raise ValueError(f"{what} needs a detect model; this one is a "
                         f"{task} model (use its task's predictor and "
                         "validator: engine/classify.py for classify, "
                         "engine/segment.py for segment, engine/pose.py "
                         "for pose)")


class DetectionModel(nn.Module):
    """Graph of the task model. forward(x NHWC in [0,1], priors) -> raw head
    maps (detect), (maps, coefficient maps, protos) (segment), (maps,
    keypoint maps) (pose) or logits (classify, (B, nc)).

    `model.{i}` is row i, so state_dict keys are the reference's. `imgsz`
    sizes the position tables of C3TR rows, as JAX's init at that imgsz
    does (the facade builds at JAX's default, 640; a loaded state dict
    brings its own size).

    `remat_upto` (-1: off; the trainer sets it from `remat`): in training,
    each row of index <= remat_upto runs under `remat_call`, layer 0
    (lowlight_recovery, JAX's _REMAT_ENHANCE) whole, a chained n > 1 row
    module by module as JAX's loop does; never a head, an Upsample or a
    Concat (JAX graph.py:520-541). Eval is untouched.

    The parameters are JAX's (graph.py:561-564), then `imgsz`.
    `contrast_mode` is layer 0's, `repconv_deploy` builds every RepConv in
    its fused deploy form. `enhance_impl` ('xla' or 'pallas') picks no
    path here: layer 0 runs its CUDA kernel on a card and the plain chain
    on the CPU. `stem_s2d` and `fpn_fuse` are TPU layouts that leave the
    function and the checkpoint as they are, so the graph ignores them.
    """

    remat_upto = -1

    def __init__(self, cfg_dict: dict, nc: Optional[int] = None,
                 verbose: bool = False, enhance_impl: str = "xla",
                 contrast_mode: str = "channel", repconv_deploy: bool = False,
                 remat_upto: int = -1, stem_s2d: bool = False,
                 fpn_fuse: Optional[bool] = None, imgsz: int = 640):
        super().__init__()
        if enhance_impl not in ("xla", "pallas"):
            raise ValueError(f"enhance_impl must be 'xla' or 'pallas', not "
                             f"{enhance_impl!r}")
        self.yaml = copy.deepcopy(cfg_dict)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        self.specs, self.save, self.head = parse_model(self.yaml, ch=3,
                                                       verbose=verbose)
        self.task = TASKS.get(self.head["name"], "detect")
        self.strides = self.head["strides"]
        self.reg_max = 16
        self.names = {i: str(i) for i in range(self.nc)}
        self.model = nn.ModuleList(
            _build_module(s, cins, self.head)
            for s, cins in zip(self.specs, layer_inputs(self.specs)))
        self._size_position_tables(imgsz)
        for m in self.modules():
            if isinstance(m, LowlightRecovery):
                m.contrast_mode = contrast_mode
        if repconv_deploy:
            L.fuse_repconv(self)
        self.remat_upto = int(remat_upto)

    def _size_position_tables(self, imgsz):
        """Each C3TR's position table sized by the map it gets from an
        imgsz x imgsz image, as JAX's init sizes it (its rows' strides do
        not say: parse_model counts no GhostConv or GhostBottleneck
        stride): one forward of a meta image through meta copies of the
        weights, each TransformerBlock recording its map and passing its
        input on."""
        from .transformer import TransformerBlock
        blocks = [m for m in self.modules() if isinstance(m, TransformerBlock)]
        if not blocks:
            return
        for b in blocks:
            b.sizing = []
        try:
            meta = {k: torch.empty_like(v, device="meta") for k, v in
                    [*self.named_parameters(), *self.named_buffers()]}
            torch.func.functional_call(
                self, meta, (torch.zeros(1, imgsz, imgsz, 3, device="meta"),))
            for b in blocks:
                b.size_for(b.sizing[0])
        finally:
            for b in blocks:
                b.sizing = None

    def forward(self, x, dedark_A=None, IcA=None, capture=()):
        """x (B, H, W, 3) in [0, 1]; dedark_A (B, 3) and IcA (B, H, W, 1) are
        layer 0's priors (None: its defaults), as JAX `apply_train` and
        `apply_eval` take them (graph.py:599-611). In train mode the BN
        running stats move; the raw maps are returned in both modes.

        `capture` (layer indices) also returns {i: the first image's output
        of layer i, its first 32 channels, NHWC} as (raw, caps), JAX
        `apply(..., capture=)` (graph.py:485-551): sliced on the device, so
        a readback stays small. The head's list of maps is not captured."""
        caps = {}
        upto = self.remat_upto if self.training else -1
        if self.specs[0].name == "lowlight_recovery":
            x = (remat_call(self.model[0], x, dedark_A, IcA) if upto >= 0
                 else self.model[0](x, dedark_A, IcA))
            if 0 in capture:
                caps[0] = x[:1, ..., :32]
        # NHWC -> NCHW as a view (channels_last memory); the image is
        # promoted against the params' dtype here, as flax's promote_dtype
        # does at the first conv: a bf16 image meets f32 params as f32
        # (half predict), bf16 params as bf16 (amp training)
        y = x.permute(0, 3, 1, 2)
        y = y.to(torch.promote_types(y.dtype, next(self.parameters()).dtype))
        saved = {}
        for spec, mod in zip(self.specs, self.model):
            if spec.name != "lowlight_recovery":
                if len(spec.f) == 1:
                    inp = y if spec.f[0] == -1 else saved[spec.f[0]]
                else:
                    inp = [y if fi == -1 else saved[fi] for fi in spec.f]
                if spec.i > upto or spec.name in _NO_REMAT:
                    y = mod(inp)
                elif chained(spec):
                    y = inp
                    for sub in mod:
                        y = remat_call(sub, y)
                else:
                    y = remat_call(mod, inp)
                if spec.i in capture and torch.is_tensor(y) and y.dim() == 4:
                    caps[spec.i] = y[:1, :32].permute(0, 2, 3, 1)
            if spec.i in self.save:
                saved[spec.i] = y
        return (y, caps) if capture else y

    @property
    def kpt_shape(self):
        """(nk, kdim) of the Pose head's row (JAX graph.py:665-669; COCO's
        17 x 3 where the row gives none)."""
        args = self.head.get("args", ())
        return tuple(args[1]) if len(args) > 1 else (17, 3)

    @property
    def is_rtdetr(self) -> bool:
        return self.head["name"] == "RTDETRDecoder"

    def decode(self, raw, hw=None):
        """Raw maps -> (boxes_xywh (B, N, 4), scores (B, N, nc)); RT-DETR's
        (B, nq, 4 + nc) queries -> their normalized boxes times the input's
        (h, w) `hw` and their scores (JAX graph.py:614-618); a
        classify model's logits -> (probs (B, nc),), their softmax (JAX
        graph.py:612-613); a segment model's (maps, coefficient maps,
        protos) -> (boxes_xywh, scores, coef_flat (B, N, nm), protos (B,
        mh, mw, nm)), the coefficients in the anchors' order (JAX
        graph.py:681-688); a pose model's (maps, keypoint maps) ->
        (boxes_xywh, scores, keypoints (B, N, nk, kdim) in pixels) (JAX
        graph.py:689-695)."""
        if self.task == "classify":
            return (L.softmax(raw, -1),)
        if self.is_rtdetr:     # Python scalars: no upload in the step
            h, w = hw
            return (torch.cat([raw[..., 0:1] * w, raw[..., 1:2] * h,
                               raw[..., 2:3] * w, raw[..., 3:4] * h], -1),
                    raw[..., 4:])
        if self.task == "segment":
            det, coefs, protos = raw
            nm = protos.shape[-1]
            coef_flat = torch.cat([c.reshape(c.shape[0], -1, nm)
                                   for c in coefs], 1)
            return (*decode_detections(det, self.nc, self.strides,
                                       self.reg_max), coef_flat, protos)
        if self.task == "pose":
            det, kpt_maps = raw
            return (*decode_detections(det, self.nc, self.strides,
                                       self.reg_max),
                    decode_keypoints(kpt_maps, self.strides, self.kpt_shape))
        return decode_detections(raw, self.nc, self.strides, self.reg_max)

    def eval_outputs(self, x, params=None):
        """The task's decoded output tuple, the one definition that the
        exporter, AutoBackend's live branch and the classify predictor and
        validator share (JAX nn/graph.py:671-700): detect ->
        (boxes_xywh (B, N, 4), scores (B, N, nc)), segment -> (boxes_xywh,
        scores, coef_flat (B, N, nm), protos (B, mh, mw, nm)), pose ->
        (boxes_xywh, scores, keypoints (B, N, nk, kdim)), classify ->
        (probs (B, nc),), each decode(forward(x)). `params` (a state dict,
        e.g. the bf16 casts of `engine.benchmarks.bf16_params`) runs in
        place of the module's own weights through
        `torch.func.functional_call`."""
        raw = (self(x) if params is None
               else torch.func.functional_call(self, params, (x,)))
        return self.decode(raw, x.shape[1:3])

    def tta_eval(self, x, forward=None):
        """Test-time-augmented inference (JAX graph.py:621-665; reference
        tasks.py:303-343): x (B, H, W, 3) in [0, 1] -> (boxes_xywh, scores)
        of three passes at scales 1, 0.83 and 0.67, the middle one flipped
        left-right. A scaled pass resizes bilinearly (`torch_bilinear_resize`)
        and pads bottom and right with 0.447 to a stride multiple; its boxes
        are descaled and un-flipped into x's frame. The unscaled pass drops
        its coarsest level's anchors, the smallest pass its finest level's;
        the rest concatenate for one NMS. `forward` (default: this module)
        maps an image to raw maps, e.g. one ensemble member's weights."""
        require_detect(self, "test-time augmentation")
        if self.is_rtdetr:
            raise ValueError("RT-DETR has no test-time augmentation (the "
                             "predictor falls back to one scale)")
        forward = forward or self
        h, w = int(x.shape[1]), int(x.shape[2])
        gs = int(max(self.strides))
        nl = len(self.strides)
        g = sum(4 ** i for i in range(nl))
        outs = []
        for si, flip_lr in ((1.0, False), (0.83, True), (0.67, False)):
            xi = torch.flip(x, [2]) if flip_lr else x
            if si != 1.0:
                sh, sw = int(h * si), int(w * si)
                xi = torch_bilinear_resize(xi, sh, sw)
                ph = math.ceil(h * si / gs) * gs
                pw = math.ceil(w * si / gs) * gs
                xi = F.pad(xi, (0, 0, 0, pw - sw, 0, ph - sh), value=0.447)
            boxes, scores = self.decode(forward(xi))
            boxes = boxes / si
            if flip_lr:   # xywh: only the centre x mirrors
                boxes = torch.cat([w - boxes[..., :1], boxes[..., 1:]], -1)
            outs.append((boxes, scores))
        (b0, s0), (b1, s1), (b2, s2) = outs
        i0 = b0.shape[1] // g
        i2 = (b2.shape[1] // g) * 4 ** (nl - 1)
        return (torch.cat([b0[:, :-i0], b1, b2[:, i2:]], 1),
                torch.cat([s0[:, :-i0], s1, s2[:, i2:]], 1))
