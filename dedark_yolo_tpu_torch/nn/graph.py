"""Model-dict parser and the DetectionModel walk (JAX nn/graph.py).

`parse_model` is a copy of the JAX package's (graph.py:145-278): the same
`[from, repeats, module, args]` schema and channel rules as the reference
(ultralytics/nn/tasks.py:803-921). `DetectionModel` builds one torch module
per row and walks them with the save-list (graph.py:484-551), in the plain
form only: no lazy upsample/concat, remat, space-to-depth stem or FPN fuse,
which are exact rewrites of the same params in the JAX package. The
built heads are Detect and AsffDetect (task 'detect'), Classify (task
'classify') and Segment (task 'segment'); `task` is JAX's (graph.py:
575-576).

Layout: the image enters NHWC in [0, 1]; layer 0 (lowlight_recovery) works
on NHWC, the backbone on NCHW (a permuted view, so channels_last memory);
the head returns per-level (B, H, W, 4*reg_max + nc) maps (Segment: also
the (B, H, W, nm) coefficient maps and the NHWC protos). `forward` can
also return layers' activations (`capture`, NHWC as JAX's), and `tta_eval`
is JAX's test-time augmentation (graph.py:621-665).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .enhance import LowlightRecovery, torch_bilinear_resize
from .heads import AsffDetect, Detect, Segment, decode_detections


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
PORTED_HEADS = {"Detect": Detect, "AsffDetect": AsffDetect,
                "Segment": Segment, "Classify": L.Classify}
# head -> task (JAX graph.py:575-576); heads not listed are detect's
TASKS = {"Classify": "classify", "Segment": "segment", "Pose": "pose"}
_STRIDE2 = {"Focus", "HGStem"}


def parse_model(d: dict, ch: int = 3):
    """Parse a model dict into (specs, savelist, head_info)."""
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
    (JAX graph.py:281-381 for the rows the detect architectures use)."""
    name, a, c1 = spec.name, list(spec.args), cins[0]
    if spec.n > 1 and name not in _REPEAT_BLOCKS:
        raise NotImplementedError(f"{name} repeated {spec.n} times is not ported")
    if name == "Conv":
        return L.Conv(c1, a[0], a[1] if len(a) > 1 else 1,
                      a[2] if len(a) > 2 else 1)
    if name in C2F_FAMILY:
        return L.C2f(c1, a[0], a[1], shortcut=a[2] if len(a) > 2 else False,
                     bottleneck_kind=C2F_FAMILY[name])
    if name == "C2":
        return L.C2(c1, a[0], a[1], shortcut=a[2] if len(a) > 2 else True)
    if name == "SPPF":
        return L.SPPF(c1, a[0], a[1] if len(a) > 1 else 5)
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
        return L.PConv(c1, a[1] if len(a) > 1 else 4)
    if name == "SCConv":
        return L.SCConv(a[0])
    if name == "Classify":
        return L.Classify(c1, a[0], a[1] if len(a) > 1 else 1,
                          a[2] if len(a) > 2 else 1)
    if name == "Segment":
        ha = head.get("args", ())
        return Segment(head["nc"], cins, head["strides"],
                       nm=ha[1] if len(ha) > 1 else 32,
                       npr=ha[2] if len(ha) > 2 else 256)
    if name in PORTED_HEADS:
        return PORTED_HEADS[name](head["nc"], cins, head["strides"])
    if name == "nn.Upsample":
        return L.Upsample(int(a[1]) if len(a) > 1 and a[1] else 2)
    if name == "Concat":
        return L.Concat()
    raise NotImplementedError(f"module '{name}' is not ported to torch yet")


def require_detect(model, what):
    """Raise for a model (or AutoBackend) of another task than detect:
    `what` reads boxes and scores."""
    task = getattr(model, "task", "detect")
    if task != "detect":
        raise ValueError(f"{what} needs a detect model; this one is a "
                         f"{task} model (use its task's predictor and "
                         "validator: engine/classify.py for classify, "
                         "engine/segment.py for segment)")


class DetectionModel(nn.Module):
    """Graph of the task model. forward(x NHWC in [0,1], priors) -> raw head
    maps (detect), (maps, coefficient maps, protos) (segment) or logits
    (classify, (B, nc)).

    `model.{i}` is row i, so state_dict keys are the reference's.
    """

    def __init__(self, cfg_dict: dict, nc: Optional[int] = None):
        super().__init__()
        self.yaml = copy.deepcopy(cfg_dict)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        self.specs, self.save, self.head = parse_model(self.yaml, ch=3)
        if self.head["name"] not in PORTED_HEADS:
            raise NotImplementedError(
                f"{self.head['name']} head is not ported to torch yet "
                "(ROADMAP A12f-A12g)")
        self.task = TASKS.get(self.head["name"], "detect")
        self.strides = self.head["strides"]
        self.reg_max = 16
        self.names = {i: str(i) for i in range(self.nc)}
        self.model = nn.ModuleList(
            _build_module(s, cins, self.head)
            for s, cins in zip(self.specs, layer_inputs(self.specs)))

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
        if self.specs[0].name == "lowlight_recovery":
            x = self.model[0](x, dedark_A, IcA)
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
                y = mod(inp)
                if spec.i in capture and torch.is_tensor(y) and y.dim() == 4:
                    caps[spec.i] = y[:1, :32].permute(0, 2, 3, 1)
            if spec.i in self.save:
                saved[spec.i] = y
        return (y, caps) if capture else y

    def decode(self, raw):
        """Raw maps -> (boxes_xywh (B, N, 4), scores (B, N, nc)); a
        classify model's logits -> (probs (B, nc),), their softmax (JAX
        graph.py:612-613); a segment model's (maps, coefficient maps,
        protos) -> (boxes_xywh, scores, coef_flat (B, N, nm), protos (B,
        mh, mw, nm)), the coefficients in the anchors' order (JAX
        graph.py:681-688)."""
        if self.task == "classify":
            return (L.softmax(raw, -1),)
        if self.task == "segment":
            det, coefs, protos = raw
            nm = protos.shape[-1]
            coef_flat = torch.cat([c.reshape(c.shape[0], -1, nm)
                                   for c in coefs], 1)
            return (*decode_detections(det, self.nc, self.strides,
                                       self.reg_max), coef_flat, protos)
        return decode_detections(raw, self.nc, self.strides, self.reg_max)

    def eval_outputs(self, x, params=None):
        """The task's decoded output tuple, the one definition that the
        exporter, AutoBackend's live branch and the classify predictor and
        validator share (JAX nn/graph.py:671-700): detect ->
        (boxes_xywh (B, N, 4), scores (B, N, nc)), segment -> (boxes_xywh,
        scores, coef_flat (B, N, nm), protos (B, mh, mw, nm)), classify ->
        (probs (B, nc),), each decode(forward(x)). `params` (a state dict,
        e.g. the bf16 casts of `engine.benchmarks.bf16_params`) runs in
        place of the module's own weights through
        `torch.func.functional_call`. Pose heads are not built (the
        constructor refuses them)."""
        raw = (self(x) if params is None
               else torch.func.functional_call(self, params, (x,)))
        return self.decode(raw)

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
