"""Weights: the seeded init, and the map between the JAX param trees and
the port's state_dict, both ways.

`state_dict_from_jax` is a copy, without jax, of the JAX package's
`utils/torch_import.py` (`_torch_base` :62-166 and `export_state_dict`
:237-278) for the modules the port has. It takes the flax
{"params", "batch_stats"} trees as nested dicts of arrays and returns the
reference-named, NCHW/OIHW state_dict that `DetectionModel.load_state_dict`
takes; `opt_state_from_jax` maps an optimizer state the same way.
`state_dict_to_jax` and `opt_state_to_jax` are their inverses (the JAX
package's `convert_state_dict`, torch_import.py:169): flax names, NHWC/HWIO
kernels, fc1's rows in the NHWC flatten order, so that a checkpoint the
port writes restores in the JAX package.

Names. Flax names a module's unnamed children `<Class>_<k>`, k counting the
children of that class in the order they are CONSTRUCTED, not called: in
RFBblock's `Conv2d(i, 3)(Conv2d(i, 1)(x))` the outer 3x3 is built first and
is Conv2d_1, the inner 1x1 Conv2d_2. The port's Conv and flax's nn.Conv
share the prefix `Conv`. Where `torch_import.py` names a module (Conv,
DWConv, C2f, SPP, SPPF, GhostConv, C3, C3x, Detect, AsffDetect,
AsffTribeLevel at equal widths, AsffDoubLevel, layer 0) the port takes its
names; for the rest, the reference's attribute names where the structure
matches, in the table (flax child -> port child; a conv's or BN's flax
child holds its params on the port module itself; `<Class>_2k` and
`<Class>_2k+1`: every even and odd index):

  PConv            Conv_0 -> conv
  Pconv bottleneck PConv_0 -> pconv, Conv_0 -> cv1, Conv2d_0 -> cv2
    (PconvBottleneck, PconvBottleneckN)
  SC bottleneck    SCConv_0 -> sc, Conv_0 -> cv1 (SCConvBottleneck,
                   SCConv3Bottleneck, Conv3SCBottleneck); SCPWBottleneck:
                   Conv2d_0 -> cv1; SCPWPWBottleneck: Conv_0 -> cv1,
                   Conv2d_0 -> cv2
  SCConv           sru_weight, sru_bias (params of SCConv itself),
                   CRU_0 -> cru
  CRU              Conv_0..4 -> squeeze1, squeeze2, GWC, PWC1, PWC2
  C2f family       Conv_0 -> cv1, Conv_1 -> cv2, <Bottleneck class>_k -> m.k
  C2               Conv_0 -> cv1, Conv_1 -> cv2, Bottleneck_k -> m.k
  RFBblock         Conv2d_0 -> b0, Conv2d_1 -> b1.1, Conv2d_2 -> b1.0,
                   Conv2d_3..5 -> b2.0..2, Conv2d_6..8 -> b3.0..2
  AsffTribeLevel   AddConv_k in the order [align_level_1 (level 0) or
                   align_level_0 (level 1), where that branch's width
                   differs from the level's: scales n, s, m],
                   stride_level_2, weight_level_0..2, expand; level 2:
                   compress_level_0, compress_level_1, weight_level_0..2,
                   expand; Conv2d_0 -> weight_levels
  MFRU             SCConv_0 -> sc_deep, SCConv_1 -> sc_out, Conv2d_0 -> pw,
                   AddConv_0 -> align_level_1 (where P4's width differs
                   from P5's), Conv2d_1..3 -> weight_level_0..2, Conv2d_4
                   -> weight_levels
  Conv2d           Conv_0 -> the bare conv itself; AddConv: Conv_0 -> conv,
                   BatchNorm_0 -> batch_norm
  Classify         Conv_0 -> conv (a Conv: conv.conv, conv.bn), Dense_0 ->
                   linear (the reference's `model.{i}.linear`; its kernel
                   only transposed, unlike layer 0's fc1, whose rows are
                   also permuted: the map keys on the row's module)
  Segment          detect/<Detect's names> -> the head's own cv2, cv3;
                   Proto_0 -> proto; cv4_{i}_{j} -> cv4.{i}.{j} (j < 2 a
                   Conv, j = 2 the biased 1x1) (torch_import.py:123-139)
  Pose             Segment's names without Proto_0: detect/ -> cv2, cv3;
                   cv4_{i}_{j} -> cv4.{i}.{j} (the keypoint branch)
  Proto            Conv_0, ConvTranspose_0, Conv_1, Conv_2 -> cv1,
                   upsample, cv2, cv3
  DWConv           Conv_0 -> the port module itself (a Conv: conv, bn)
  Conv2            Conv_0 -> conv, Conv_1 -> cv2, BatchNorm_0 -> bn
  LightConv        Conv_0 -> conv1, DWConv_0 -> conv2
  ConvTranspose    ConvTranspose_0 -> conv_transpose, BatchNorm_0 -> bn
  Focus            Conv_0 -> conv; CrossConv: Conv_0 -> conv, BatchNorm_0
                   -> bn
  GhostConv, SPP   Conv_0 -> cv1, Conv_1 -> cv2
  CBAM             ChannelAttention_0 -> channel_attention (Conv_0 -> fc),
                   SpatialAttention_0 -> spatial_attention (Conv_0 -> cv1)
  RepConv          Conv_0 -> conv1, Conv_1 -> conv2, BatchNorm_0 -> bn;
                   the deploy form's fused -> conv
  GhostBottleneck  GhostConv_0 -> conv.0, DWConv_0 -> conv.1 (s = 2),
                   GhostConv_1 -> conv.2, DWConv_1 -> shortcut.0, Conv_0
                   -> shortcut.1 (s = 2)
  C1               Conv_0 -> cv1, Conv_{k+1} -> m.k
  C3 family        Conv_0, Conv_1, Conv_2 -> cv1, cv2, cv3; C3:
                   Bottleneck_k -> m.k; C3x: CrossConv_2k, CrossConv_2k+1
                   -> m.k.cv1, m.k.cv2 (torch_import.py:96-103); C3Ghost:
                   GhostBottleneck_k -> m.k (JAX builds these where its
                   torch_import.py names Bottleneck_k); C3TR:
                   TransformerBlock_0 -> m; RepC3: RepConv_k -> m.k
  BottleneckCSP    Conv_0 -> cv1, Bottleneck_k -> m.k, Conv2d_0 -> cv3,
                   Conv2d_1 -> cv2, BatchNorm_0 -> bn, Conv_1 -> cv4
  HGStem           Conv_0..4 -> stem1, stem2a, stem2b, stem3, stem4
  HGBlock          Conv_k -> m.k (k < n), Conv_n -> sc, Conv_{n+1} -> ec;
                   HGBlockLight (lightconv=True, which no row builds):
                   LightConv_k -> m.k, Conv_0 -> sc, Conv_1 -> ec
  TransformerBlock Conv_0 -> conv (where c1 != c2), pos (its own
                   parameter), Dense_0 -> linear, TransformerLayer_k ->
                   tr.k; TransformerLayer: MultiHeadDotProductAttention_0
                   -> ma (query, key, value, out), Dense_0, Dense_1 ->
                   fc1, fc2
  AIFI             TransformerEncoderLayer_0 -> the port module itself
                   (an encoder layer: MultiHeadDotProductAttention_0 -> ma,
                   LayerNorm_0, Dense_0, Dense_1, LayerNorm_1 -> norm1,
                   fc1, fc2, norm2)
  MLP              Dense_k -> layers.k; LayerNorm2d: LayerNorm_0 -> itself
  RTDETRDecoder    input_proj_{i}_conv, _bn -> input_proj.{i}.0, .1;
                   enc_output_0, _1 -> enc_output.0, .1; enc_score_head;
                   enc_bbox_head_{j}, query_pos_head_{j} -> *.layers.{j};
                   decoder_layer_{i} -> decoder.{i} (self_attn, norm1,
                   cross_attn (MSDeformAttn: sampling_offsets,
                   attention_weights, value_proj, output_proj), norm2,
                   linear1, linear2, norm3); dec_score_head_{i} ->
                   dec_score_head.{i}; dec_bbox_head_{i}_{j} ->
                   dec_bbox_head.{i}.layers.{j}
  chained row      mods_{i}_{k} -> model.{i}.{k} (a non-repeat row of n > 1)

Kernels: a conv's OIHW weight is flax's HWIO kernel transposed. Proto's
transposed conv is not: torch stores it (I, O, kh, kw) and applies it as
the gradient of a conv, with the kernel mirrored, where flax's
ConvTranspose applies its (kh, kw, I, O) kernel unmirrored; so its kernel
is transposed AND flipped in both spatial axes, both ways
(torch_import.py:196-203, 258-264); so is ConvTranspose's. The attention's
DenseGeneral kernels, (c, heads, depth) and out's (heads, depth, c), are a
Linear's (c, c) weight flattened and transposed, their (heads, depth)
biases a Linear's (c,) bias; a LayerNorm's scale its weight.

A module applied twice (MFRU's sc_deep, pw and sc_out) is one flax child and
one port child, so it has one set of keys. AsffTribeLevel's order depends on
its input widths, which the maps take from the model (`layer_inputs`).
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..engine.optim import OptState
from ..nn.graph import C2F_FAMILY, chained, layer_inputs
from ..nn.heads import Detect, RTDETRDecoder
from ..nn.layers import BatchNorm, GroupBatchnorm2d, SCConv
from ..nn.transformer import (LayerNorm, MSDeformAttn, MultiHeadAttention,
                              TransformerBlock)


def _fc1_permutation(c=32, h=8, w=8):
    """Maps the NHWC-flatten index (flax) to the NCHW-flatten index (torch)."""
    idx = np.zeros(c * h * w, dtype=np.int64)
    for hh in range(h):
        for ww in range(w):
            for cc in range(c):
                idx[hh * (w * c) + ww * c + cc] = cc * (h * w) + hh * w + ww
    return idx


# flax child name -> (port child name, the child's kind); kind None: a flax
# nn.Conv or nn.BatchNorm whose params sit on that port module; "" as the
# port name: the module itself (Conv2d's inner conv). `<Class>_*` matches
# every index k of that class and maps to the name with {k}.
_PAIR = {"Conv_0": ("conv", None), "BatchNorm_0": ("bn", None)}
_CV = {"Conv_0": ("cv1", "Conv"), "Conv_1": ("cv2", "Conv")}
_SC = {"SCConv_0": ("sc", "SCConv"), "Conv_0": ("cv1", "Conv")}
_C2F_BLOCK = {"standard": "Bottleneck", "pconv": "PconvBottleneck",
              "pconv_n": "PconvBottleneckN", "scconv": "SCConvBottleneck",
              "sc_pw": "SCPWBottleneck", "sc_conv3": "SCConv3Bottleneck",
              "conv3_sc": "Conv3SCBottleneck", "sc_pw_pw": "SCPWPWBottleneck"}
_TABLES = {
    "Conv": _PAIR,
    "AddConv": {"Conv_0": ("conv", None), "BatchNorm_0": ("batch_norm", None)},
    "Conv2d": {"Conv_0": ("", None)},
    "SPPF": _CV,
    "Bottleneck": _CV,
    "C2": {**_CV, "Bottleneck_*": ("m.{k}", "Bottleneck")},
    **{name: {**_CV, f"{_C2F_BLOCK[kind]}_*": ("m.{k}", _C2F_BLOCK[kind])}
       for name, kind in C2F_FAMILY.items()},
    "PConv": {"Conv_0": ("conv", None)},
    "Classify": {"Conv_0": ("conv", "Conv"), "Dense_0": ("linear", None)},
    "Proto": {"Conv_0": ("cv1", "Conv"), "ConvTranspose_0": ("upsample", None),
              "Conv_1": ("cv2", "Conv"), "Conv_2": ("cv3", "Conv")},
    "GroupBatchnorm2d": {},
    "PconvBottleneck": {"PConv_0": ("pconv", "PConv"), "Conv_0": ("cv1", "Conv"),
                        "Conv2d_0": ("cv2", "Conv2d")},
    "SCConvBottleneck": _SC,
    "SCConv3Bottleneck": _SC,
    "Conv3SCBottleneck": _SC,
    "SCPWBottleneck": {"SCConv_0": ("sc", "SCConv"),
                       "Conv2d_0": ("cv1", "Conv2d")},
    "SCPWPWBottleneck": {**_SC, "Conv2d_0": ("cv2", "Conv2d")},
    "SCConv": {"CRU_0": ("cru", "CRU")},
    "CRU": {f"Conv_{k}": (n, None) for k, n in
            enumerate(("squeeze1", "squeeze2", "GWC", "PWC1", "PWC2"))},
    "RFBblock": {f"Conv2d_{k}": (n, "Conv2d") for k, n in enumerate(
        ("b0", "b1.1", "b1.0", "b2.0", "b2.1", "b2.2", "b3.0", "b3.1",
         "b3.2"))},
    "MFRU": {"SCConv_0": ("sc_deep", "SCConv"), "SCConv_1": ("sc_out", "SCConv"),
             "Conv2d_0": ("pw", "Conv2d"), "AddConv_0": ("align_level_1", "AddConv"),
             **{f"Conv2d_{k}": (n, "Conv2d") for k, n in enumerate(
                 ("weight_level_0", "weight_level_1", "weight_level_2",
                  "weight_levels"), 1)}},
}
_TABLES["PconvBottleneckN"] = _TABLES["PconvBottleneck"]
_C3 = {"Conv_0": ("cv1", "Conv"), "Conv_1": ("cv2", "Conv"),
       "Conv_2": ("cv3", "Conv")}
_TABLES.update({
    "DWConv": {"Conv_0": ("", "Conv")},
    "CrossConv": _PAIR,
    "Conv2": {"Conv_0": ("conv", None), "Conv_1": ("cv2", None),
              "BatchNorm_0": ("bn", None)},
    "LightConv": {"Conv_0": ("conv1", "Conv"), "DWConv_0": ("conv2", "DWConv")},
    "ConvTranspose": {"ConvTranspose_0": ("conv_transpose", None),
                      "BatchNorm_0": ("bn", None)},
    "Focus": {"Conv_0": ("conv", "Conv")},
    "GhostConv": _CV,
    "SPP": _CV,
    "ChannelAttention": {"Conv_0": ("fc", None)},
    "SpatialAttention": {"Conv_0": ("cv1", None)},
    "CBAM": {"ChannelAttention_0": ("channel_attention", "ChannelAttention"),
             "SpatialAttention_0": ("spatial_attention", "SpatialAttention")},
    "RepConv": {"Conv_0": ("conv1", "Conv"), "Conv_1": ("conv2", "Conv"),
                "BatchNorm_0": ("bn", None), "fused": ("conv", None)},
    "GhostBottleneck": {"GhostConv_0": ("conv.0", "GhostConv"),
                        "DWConv_0": ("conv.1", "DWConv"),
                        "GhostConv_1": ("conv.2", "GhostConv"),
                        "DWConv_1": ("shortcut.0", "DWConv"),
                        "Conv_0": ("shortcut.1", "Conv")},
    "C1": {"Conv_0": ("cv1", "Conv"), "Conv_*+1": ("m.{k}", "Conv")},
    "C3": {**_C3, "Bottleneck_*": ("m.{k}", "Bottleneck")},
    "C3x": {**_C3, "CrossConv_2*": ("m.{k}.cv1", "Conv"),
            "CrossConv_2*+1": ("m.{k}.cv2", "Conv")},
    "C3TR": {**_C3, "TransformerBlock_0": ("m", "TransformerBlock")},
    "C3Ghost": {**_C3, "GhostBottleneck_*": ("m.{k}", "GhostBottleneck")},
    "RepC3": {**_C3, "RepConv_*": ("m.{k}", "RepConv")},
    "BottleneckCSP": {"Conv_0": ("cv1", "Conv"),
                      "Bottleneck_*": ("m.{k}", "Bottleneck"),
                      "Conv2d_0": ("cv3", "Conv2d"),
                      "Conv2d_1": ("cv2", "Conv2d"),
                      "BatchNorm_0": ("bn", None), "Conv_1": ("cv4", "Conv")},
    "HGStem": {f"Conv_{k}": (n, "Conv") for k, n in enumerate(
        ("stem1", "stem2a", "stem2b", "stem3", "stem4"))},
    "HGBlockLight": {"LightConv_*": ("m.{k}", "LightConv"),
                     "Conv_0": ("sc", "Conv"), "Conv_1": ("ec", "Conv")},
    "TransformerBlock": {"Conv_0": ("conv", "Conv"), "Dense_0": ("linear", None),
                         "TransformerLayer_*": ("tr.{k}", "TransformerLayer")},
    "TransformerLayer": {"MultiHeadDotProductAttention_0": (
        "ma", "MultiHeadDotProductAttention"), "Dense_0": ("fc1", None),
        "Dense_1": ("fc2", None)},
    "MultiHeadDotProductAttention": {n: (n, None) for n in
                                     ("query", "key", "value", "out")},
    "AIFI": {"TransformerEncoderLayer_0": ("", "TransformerEncoderLayer")},
    "TransformerEncoderLayer": {
        "MultiHeadDotProductAttention_0": ("ma", "MultiHeadDotProductAttention"),
        "LayerNorm_0": ("norm1", None), "Dense_0": ("fc1", None),
        "Dense_1": ("fc2", None), "LayerNorm_1": ("norm2", None)},
    "DeformableTransformerDecoderLayer": {
        "self_attn": ("self_attn", "MultiHeadDotProductAttention"),
        "cross_attn": ("cross_attn", "MSDeformAttn"),
        **{n: (n, None) for n in ("norm1", "norm2", "norm3", "linear1",
                                  "linear2")}},
    "MLP": {"Dense_*": ("layers.{k}", None)},
    "LayerNorm2d": {"LayerNorm_0": ("", None)},
    "MSDeformAttn": {n: (n, None) for n in (
        "sampling_offsets", "attention_weights", "value_proj", "output_proj")},
})


def _rtdetr_table(spec_args, dims):
    """RTDETRDecoder's flax children (JAX heads.py:185-262) -> the port's
    (reference head.py's names): `ndl` from the row's args, one input
    projection a level of `dims`."""
    ndl = int(spec_args[3]) if len(spec_args) > 3 else 6
    t = {"enc_output_0": ("enc_output.0", None),
         "enc_output_1": ("enc_output.1", None),
         "enc_score_head": ("enc_score_head", None),
         **{f"enc_bbox_head_{j}": (f"enc_bbox_head.layers.{j}", None)
            for j in range(3)},
         **{f"query_pos_head_{j}": (f"query_pos_head.layers.{j}", None)
            for j in range(2)}}
    for i in range(len(dims)):
        t[f"input_proj_{i}_conv"] = (f"input_proj.{i}.0", None)
        t[f"input_proj_{i}_bn"] = (f"input_proj.{i}.1", None)
    for i in range(ndl):
        t[f"decoder_layer_{i}"] = (f"decoder.{i}",
                                   "DeformableTransformerDecoderLayer")
        t[f"dec_score_head_{i}"] = (f"dec_score_head.{i}", None)
        for j in range(3):
            t[f"dec_bbox_head_{i}_{j}"] = (f"dec_bbox_head.{i}.layers.{j}",
                                           None)
    return t


def _asff_order(spec_name, level, dims):
    """The port names of an ASFF module's AddConv_0, AddConv_1, ... (the
    JAX construction order; torch_import.py:96-121 at equal widths)."""
    if spec_name == "AsffDoubLevel":
        return (["stride_level_1", "weight_level_0", "weight_level_1", "expand"]
                if level == 0 else
                ["compress_level_0", "weight_level_0", "weight_level_1", "expand"])
    if level == 2:
        return ["compress_level_0", "compress_level_1", "weight_level_0",
                "weight_level_1", "weight_level_2", "expand"]
    align = ([f"align_level_{1 - level}"]
             if dims and dims[1 - level] != dims[level] else [])
    return align + ["stride_level_2", "weight_level_0", "weight_level_1",
                    "weight_level_2", "expand"]


def _table(kind, spec_args=(), dims=()):
    if kind == "HGBlock":
        # the graph's rows: n plain Convs (JAX's _build_module drops lightconv)
        n = int(spec_args[3])
        return {"Conv_*": ("m.{k}", "Conv"), f"Conv_{n}": ("sc", "Conv"),
                f"Conv_{n + 1}": ("ec", "Conv")}
    if kind == "RTDETRDecoder":
        return _rtdetr_table(spec_args, dims)
    if kind in ("AsffTribeLevel", "AsffDoubLevel"):
        level = int(spec_args[0]) if spec_args else 0
        order = _asff_order(kind, level, dims)
        return {"Conv2d_0": ("weight_levels", "Conv2d"),
                **{f"AddConv_{k}": (n, "AddConv") for k, n in enumerate(order)}}
    return _TABLES.get(kind)


_PATTERN = re.compile(r"(.*)_(\d*)\*(?:\+(\d+))?$")


def _pattern(key):
    """(prefix, a, b) of a table key `<Class>_<a>*+<b>`, which matches the
    flax children <Class>_{a*k+b} (a = 1, b = 0 where left out), or None
    for an exact name."""
    m = _PATTERN.match(key)
    return m and (m.group(1), int(m.group(2) or 1), int(m.group(3) or 0))


def _child(table, name):
    """(port name, kind) of the flax child `name` in `table`: its exact
    entry, else the pattern entry that its index solves for k >= 0."""
    table = table or {}
    if name in table:
        return table[name]
    prefix, _, j = name.rpartition("_")
    if j.isdigit():
        for key, (sub, kind) in table.items():
            pat = _pattern(key)
            if pat and pat[0] == prefix and int(j) >= pat[2] \
                    and (int(j) - pat[2]) % pat[1] == 0:
                return sub.format(k=(int(j) - pat[2]) // pat[1]), kind
    raise KeyError(name)


def _torch_base(flax_path: str, spec_name: str, spec_args=(), dims=()) -> str:
    """Map a flax sub-path inside `mods_{i}` to the torch submodule name;
    `dims` are the row's input widths (AsffTribeLevel's align convs)."""
    parts = flax_path.split("/") if flax_path else []
    if spec_name in ("Segment", "Pose") and parts:
        if parts[0] == "detect":
            return _torch_base("/".join(parts[1:]), "Detect")
        if parts[0] == "Proto_0":
            return "proto." + _torch_base("/".join(parts[1:]), "Proto")
        m = re.match(r"cv4_(\d+)_(\d+)$", parts[0])
        if m and int(m.group(2)) < 2:
            return f"cv4.{m.group(1)}.{m.group(2)}.{_PAIR[parts[1]][0]}"
        if m:
            return f"cv4.{m.group(1)}.{m.group(2)}"
    elif spec_name in ("Detect", "AsffDetect") and parts:
        m = re.match(r"(cv[23])_(\d+)(_(\d+))?$", parts[0])
        if m and spec_name == "AsffDetect" and not m.group(3):
            return f"{m.group(1)}.{m.group(2)}.0"
        if m and spec_name == "Detect" and m.group(3):
            branch, i, j = m.group(1), int(m.group(2)), int(m.group(4))
            if j < 2:
                return f"{branch}.{i}.{j}.{_PAIR[parts[1]][0]}"
            return f"{branch}.{i}.{j}"
    elif spec_name == "lowlight_recovery" and parts:
        top = parts[1] if parts[0] == "ExtractParameters2_0" else parts[0]
        if top.startswith("Conv_"):
            return f"extractor.conv_layers.{int(top.split('_')[1])}.conv_block.0"
        if top in ("Dense_0", "Dense_1"):
            return {"Dense_0": "extractor.fc1", "Dense_1": "extractor.fc2"}[top]
    else:
        table, out = _table(spec_name, spec_args, dims), []
        try:
            for p in parts:
                sub, kind = _child(table, p)
                out += [sub] if sub else []
                table = _table(kind) if kind else {}
            if table is not None:
                return ".".join(out)
        except KeyError:
            pass
    raise NotImplementedError(
        f"no torch mapping for '{flax_path}' in module '{spec_name}'")


def _flax_base(sub: str, spec_name: str, spec_args=(), dims=()) -> list:
    """The inverse of `_torch_base`: the port's submodule name inside
    `model.{i}` -> the flax path parts inside `mods_{i}`."""
    parts = sub.split(".") if sub else []
    out = None
    if spec_name in ("Segment", "Pose"):
        if parts[0] in ("cv2", "cv3"):
            out = ["detect"] + _flax_base(sub, "Detect")
        elif parts[0] == "proto":
            out = ["Proto_0"] + _flax_walk(parts[1:], _table("Proto"))
        else:
            out = ["_".join(parts[:3])] + ([{"conv": "Conv_0",
                                             "bn": "BatchNorm_0"}[parts[3]]]
                                           if len(parts) > 3 else [])
    elif spec_name == "Detect":
        out = ["_".join(parts[:3])] + ([{"conv": "Conv_0", "bn": "BatchNorm_0"}[
            parts[3]]] if len(parts) > 3 else [])
    elif spec_name == "AsffDetect":
        out = ["_".join(parts[:2])]
    elif spec_name == "lowlight_recovery":
        if parts[1] == "conv_layers":
            out = ["ExtractParameters2_0", f"Conv_{parts[2]}"]
        else:
            out = ["ExtractParameters2_0",
                   {"fc1": "Dense_0", "fc2": "Dense_1"}[parts[1]]]
    else:
        out = _flax_walk(parts, _table(spec_name, spec_args, dims))
    if out is None or _torch_base("/".join(out), spec_name, spec_args,
                                  dims) != sub:
        raise NotImplementedError(
            f"no flax mapping for '{sub}' in module '{spec_name}'")
    return out


def _flax_walk(parts, table):
    """Flax path of the port name `parts` under a module of `table`: at
    each level the entry whose port name is the longest prefix of the rest
    (an entry `<Class>_*` takes the index from the name); a module whose
    table maps its inner conv to "" takes that child at the end."""
    out = []
    while table is not None:
        best = None
        for fname, (tname, kind) in table.items():
            tp = tname.split(".") if tname else []
            if len(tp) > len(parts) or (best and len(tp) <= len(best[2])):
                continue
            k = [p for t, p in zip(tp, parts) if t == "{k}"]
            if all(t == p or (t == "{k}" and p.isdigit())
                   for t, p in zip(tp, parts)) and (tp or not parts or kind):
                pat = _pattern(fname)
                if k and pat:
                    fname = f"{pat[0]}_{pat[1] * int(k[0]) + pat[2]}"
                best = (fname, kind, tp)
        if best is None:
            return out if not parts else None
        out.append(best[0])
        parts = parts[len(best[2]):]
        table = _table(best[1]) if best[1] else None
    return out if not parts else None


def _row_of(model, key):
    """(spec, flax top name, the rest of the key) of a port state-dict key
    `model.{i}[.{k}].<rest>` (k: the module of a chained row)."""
    _, i, rest = key.split(".", 2)
    spec = model.specs[int(i)]
    if chained(spec):
        k, rest = rest.split(".", 1)
        return spec, f"mods_{i}_{k}", rest
    return spec, f"mods_{i}", rest


def state_dict_to_jax(state_dict, model) -> dict:
    """The port's state_dict (or any dict keyed like it: the EMA, an
    optimizer buffer) -> {"params", "batch_stats"} flax trees of float32
    numpy arrays, as the JAX package holds them."""
    dims = layer_inputs(model.specs)
    perm = _fc1_permutation()
    out = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        arr = arr.astype(np.float32)
        spec, top, rest = _row_of(model, key)
        sub, _, leaf = rest.rpartition(".")
        path = [top] + _flax_base(sub, spec.name, spec.args, dims[spec.i])
        parent = model.get_submodule(key.rsplit(".", 2)[0])
        attention = (parent if isinstance(parent, MultiHeadAttention)
                     else None)
        if leaf in ("running_mean", "running_var"):
            section, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias" and attention and path[-1] != "out":
            section, name = "params", "bias"      # (heads, depth)
            arr = arr.reshape(attention.num_heads, -1)
        elif leaf in ("bias", "sru_weight", "sru_bias", "pos"):
            section, name = "params", leaf
        elif arr.ndim == 4 and path[-1].startswith("ConvTranspose"):
            section, name = "params", "kernel"
            arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
        elif arr.ndim == 4:
            section, name = "params", "kernel"
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif attention and leaf == "weight":
            # flax's DenseGeneral kernels: (c, heads, depth), out's (heads,
            # depth, c)
            section, name = "params", "kernel"
            heads = attention.num_heads
            arr = (arr.T.reshape(heads, -1, arr.shape[0])
                   if path[-1] == "out"
                   else arr.T.reshape(arr.shape[1], heads, -1))
        elif arr.ndim == 2:
            section, name = "params", "kernel"
            arr = np.transpose(arr, (1, 0))
            if sub == "extractor.fc1":
                arr = arr[perm, :]
        else:
            section, name = "params", "scale"
        node = out[section]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _leaf_from_jax(section, keys, arr, base):
    """(the port's leaf name, its array) of the flax leaf at `keys` under a
    row (`base`: the port name of its module), or None for a leaf the port
    does not hold."""
    leaf, parent = keys[-1], (keys[-2] if len(keys) > 1 else "")
    if section == "batch_stats":
        return (f"running_{leaf}", arr) if leaf in ("mean", "var") else None
    if leaf in ("sru_weight", "sru_bias", "pos"):
        return leaf, arr
    if leaf == "kernel" and parent.startswith("ConvTranspose"):
        return "weight", np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    if leaf == "kernel" and arr.ndim == 4:
        return "weight", np.transpose(arr, (3, 2, 0, 1))
    if leaf == "kernel" and arr.ndim == 3:       # attention's DenseGeneral
        return "weight", (arr.reshape(-1, arr.shape[-1]) if parent == "out"
                          else arr.reshape(arr.shape[0], -1)).T
    if leaf == "bias" and arr.ndim == 2:         # its (heads, depth) bias
        return "bias", arr.reshape(-1)
    if leaf == "kernel":
        if base.endswith("extractor.fc1"):
            arr = arr[np.argsort(_fc1_permutation()), :]
        return "weight", np.transpose(arr, (1, 0))
    return {"scale": "weight", "bias": "bias"}.get(leaf), arr


def module_state_from_jax(variables, kind, args=(), dims=()) -> dict:
    """The state dict of ONE port module of `kind` (a row's module name;
    `args`, `dims`: its spec's args and input widths) from its flax
    {"params", "batch_stats"} (CPU f32 tensors)."""
    sd = {}
    for section in ("params", "batch_stats"):
        for keys, arr in _leaves(variables.get(section, {})):
            base = _torch_base("/".join(keys[:-1]), kind, args, dims)
            leaf = _leaf_from_jax(section, keys, arr, base)
            if leaf and leaf[0]:
                sd[".".join(p for p in (base, leaf[0]) if p)] = leaf[1]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def state_dict_from_jax(variables, model) -> dict:
    """{"params", "batch_stats"} flax trees -> the port's state_dict (CPU f32
    tensors). `model` is the port's DetectionModel of the same architecture."""
    dims = layer_inputs(model.specs)
    bs = variables.get("batch_stats", {})
    sd = {}
    for top in sorted(set(variables["params"]) | set(bs)):
        _, i, *k = top.split("_")
        spec = model.specs[int(i)]
        prefix = ".".join(["model", i] + k)
        row = {"params": variables["params"].get(top, {}),
               "batch_stats": bs.get(top, {})}
        for name, t in module_state_from_jax(row, spec.name, spec.args,
                                             dims[spec.i]).items():
            sd[f"{prefix}.{name}"] = t
    return sd


OPT_FIELDS = ("step", "micro", "acc", "buf", "buf2")


def opt_state_from_jax(opt_state, model):
    """The JAX tree-path optimizer state (engine/optim.py `OptState`: step,
    micro, and the acc / buf / buf2 trees shaped like `params`; or the
    `opt` section of a checkpoint, whose keys are '.step', '.micro', ...)
    -> the port's `engine.optim.OptState`, keyed by the port's parameter
    names. The trees map as `state_dict_from_jax` maps the params: every
    step of that map (transposes, the fc1 row permutation) is linear."""
    if isinstance(opt_state, Mapping):
        get = lambda f: opt_state["." + f]
    else:
        get = lambda f: getattr(opt_state, f)
    tree = lambda t: state_dict_from_jax({"params": t, "batch_stats": {}},
                                         model)
    return OptState(step=int(get("step")), micro=int(get("micro")),
                    acc=tree(get("acc")), buf=tree(get("buf")),
                    buf2=tree(get("buf2")))


def opt_state_to_jax(opt_state, model) -> dict:
    """The inverse of `opt_state_from_jax`: the JAX `OptState` as the nested
    dict its checkpoint section holds ('.step' and '.micro' int32 scalars,
    '.acc', '.buf', '.buf2' flax trees)."""
    out = {".step": np.asarray(opt_state.step, np.int32),
           ".micro": np.asarray(opt_state.micro, np.int32)}
    for f in OPT_FIELDS[2:]:
        out["." + f] = state_dict_to_jax(getattr(opt_state, f), model)["params"]
    return out


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded random init: conv, transposed conv and linear weights ~ N(0,
    1/fan_in), biases 0,
    BN, GroupBatchnorm2d, SCConv's SRU and LayerNorm scale at identity
    (ones, as JAX has them), a TransformerBlock's position table ~ N(0,
    0.02) (flax's init of it), the Detect, AsffDetect, Segment and Pose
    biases of reference head.py:95-102 (Segment's coefficient and proto
    biases and Pose's keypoint biases 0, as flax initialises them), and
    RT-DETR's (JAX heads.py:183-262, transformer.py:194-237): the score
    heads' bias_cls, the box MLPs' last layer 0, the deformable
    attention's offsets and weights kernels 0, its offsets' ring bias and
    its projections Xavier-uniform.
    Draws on the CPU from one torch.Generator, so a seed gives the same
    weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            # fan-in: a transposed conv's weight is (I, O, kh, kw)
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
            std = 1.0 / math.sqrt(fan_in)
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, GroupBatchnorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, SCConv):
            mod.sru_weight.fill_(1.0)
            mod.sru_bias.zero_()
        elif isinstance(mod, TransformerBlock):
            mod.pos.copy_(torch.randn(mod.pos.shape, generator=gen) * 0.02)
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, Detect):
            mod.bias_init()
        elif isinstance(mod, RTDETRDecoder):
            for head in [mod.enc_score_head, *mod.dec_score_head]:
                head.bias.fill_(mod.bias_cls)
            for mlp in [mod.enc_bbox_head, *mod.dec_bbox_head]:
                mlp.layers[-1].weight.zero_()
                mlp.layers[-1].bias.zero_()
        elif isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(mod.offset_bias())
            mod.attention_weights.weight.zero_()
            for lin in (mod.value_proj, mod.output_proj):
                bound = math.sqrt(6.0 / sum(lin.weight.shape))
                lin.weight.copy_(torch.rand(lin.weight.shape, generator=gen)
                                 * (2 * bound) - bound)
