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
share the prefix `Conv`. Where `torch_import.py` names a module (Conv, C2f,
SPPF, Detect, AsffDetect, AsffTribeLevel at equal widths, AsffDoubLevel,
layer 0) the port takes its names; for the rest, the table (flax child ->
port child; a conv's or BN's flax child holds its params on the port
module itself):

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
  Proto            Conv_0, ConvTranspose_0, Conv_1, Conv_2 -> cv1,
                   upsample, cv2, cv3

Kernels: a conv's OIHW weight is flax's HWIO kernel transposed. Proto's
transposed conv is not: torch stores it (I, O, kh, kw) and applies it as
the gradient of a conv, with the kernel mirrored, where flax's
ConvTranspose applies its (kh, kw, I, O) kernel unmirrored; so its kernel
is transposed AND flipped in both spatial axes, both ways
(torch_import.py:196-203, 258-264).

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
from ..nn.graph import C2F_FAMILY, layer_inputs
from ..nn.heads import Detect
from ..nn.layers import BatchNorm, GroupBatchnorm2d, SCConv


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
    if kind in ("AsffTribeLevel", "AsffDoubLevel"):
        level = int(spec_args[0]) if spec_args else 0
        order = _asff_order(kind, level, dims)
        return {"Conv2d_0": ("weight_levels", "Conv2d"),
                **{f"AddConv_{k}": (n, "AddConv") for k, n in enumerate(order)}}
    return _TABLES.get(kind)


def _child(table, name):
    table = table or {}
    if name in table:
        return table[name]
    prefix, _, k = name.rpartition("_")
    sub, kind = table.get(prefix + "_*", (None, None))
    if sub is None or not k.isdigit():
        raise KeyError(name)
    return sub.format(k=k), kind


def _torch_base(flax_path: str, spec_name: str, spec_args=(), dims=()) -> str:
    """Map a flax sub-path inside `mods_{i}` to the torch submodule name;
    `dims` are the row's input widths (AsffTribeLevel's align convs)."""
    parts = flax_path.split("/") if flax_path else []
    if spec_name == "Segment" and parts:
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
    if spec_name == "Segment":
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
                   for t, p in zip(tp, parts)) and (tp or not parts):
                best = (fname.replace("*", k[0]) if k else fname, kind, tp)
        if best is None:
            return out if not parts else None
        out.append(best[0])
        parts = parts[len(best[2]):]
        table = _table(best[1]) if best[1] else None
    return out if not parts else None


def state_dict_to_jax(state_dict, model) -> dict:
    """The port's state_dict (or any dict keyed like it: the EMA, an
    optimizer buffer) -> {"params", "batch_stats"} flax trees of float32
    numpy arrays, as the JAX package holds them."""
    specs_by_idx = {s.i: s for s in model.specs}
    dims = layer_inputs(model.specs)
    perm = _fc1_permutation()
    out = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        arr = arr.astype(np.float32)
        _, i, rest = key.split(".", 2)
        sub, _, leaf = rest.rpartition(".")
        spec = specs_by_idx[int(i)]
        path = [f"mods_{i}"] + _flax_base(sub, spec.name, spec.args,
                                          dims[int(i)])
        if leaf in ("running_mean", "running_var"):
            section, name = "batch_stats", leaf[len("running_"):]
        elif leaf in ("bias", "sru_weight", "sru_bias"):
            section, name = "params", leaf
        elif arr.ndim == 4 and path[-1].startswith("ConvTranspose"):
            section, name = "params", "kernel"
            arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
        elif arr.ndim == 4:
            section, name = "params", "kernel"
            arr = np.transpose(arr, (2, 3, 1, 0))
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


def state_dict_from_jax(variables, model) -> dict:
    """{"params", "batch_stats"} flax trees -> the port's state_dict (CPU f32
    tensors). `model` is the port's DetectionModel of the same architecture."""
    specs_by_idx = {s.i: s for s in model.specs}
    dims = layer_inputs(model.specs)
    inv_perm = np.argsort(_fc1_permutation())
    sd = {}
    for section in ("params", "batch_stats"):
        for keys, arr in _leaves(variables[section]):
            spec = specs_by_idx[int(keys[0].split("_")[1])]
            leaf = keys[-1]
            base = _torch_base("/".join(keys[1:-1]), spec.name, spec.args,
                               dims[spec.i])
            tkey = f"model.{spec.i}" + (f".{base}" if base else "")
            if section == "params":
                if leaf in ("sru_weight", "sru_bias"):
                    sd[f"{tkey}.{leaf}"] = arr
                elif leaf == "kernel" and keys[-2].startswith("ConvTranspose"):
                    sd[f"{tkey}.weight"] = np.transpose(arr[::-1, ::-1],
                                                        (2, 3, 0, 1))
                elif leaf == "kernel" and arr.ndim == 4:
                    sd[f"{tkey}.weight"] = np.transpose(arr, (3, 2, 0, 1))
                elif leaf == "kernel":
                    if tkey.endswith("extractor.fc1"):
                        arr = arr[inv_perm, :]
                    sd[f"{tkey}.weight"] = np.transpose(arr, (1, 0))
                elif leaf == "scale":
                    sd[f"{tkey}.weight"] = arr
                elif leaf == "bias":
                    sd[f"{tkey}.bias"] = arr
            elif leaf in ("mean", "var"):
                sd[f"{tkey}.running_{leaf}"] = arr
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


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
    BN, GroupBatchnorm2d and SCConv's SRU scale at identity (ones, as JAX
    has them), the Detect, AsffDetect and Segment biases of reference
    head.py:95-102 (Segment's coefficient and proto biases 0, as flax
    initialises them).
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
    for mod in model.modules():
        if isinstance(mod, Detect):
            mod.bias_init()
