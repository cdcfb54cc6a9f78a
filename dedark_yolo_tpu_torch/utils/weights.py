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
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..engine.optim import OptState
from ..nn.heads import Detect
from ..nn.layers import BatchNorm


def _fc1_permutation(c=32, h=8, w=8):
    """Maps the NHWC-flatten index (flax) to the NCHW-flatten index (torch)."""
    idx = np.zeros(c * h * w, dtype=np.int64)
    for hh in range(h):
        for ww in range(w):
            for cc in range(c):
                idx[hh * (w * c) + ww * c + cc] = cc * (h * w) + hh * w + ww
    return idx


def _torch_base(flax_path: str, spec_name: str, spec_args=()) -> str:
    """Map a flax sub-path inside `mods_{i}` to the torch submodule name."""
    parts = flax_path.split("/") if flax_path else []

    def conv_pair(sub):
        return {"Conv_0": f"{sub}.conv", "BatchNorm_0": f"{sub}.bn"}

    if spec_name == "Conv":
        return {"Conv_0": "conv", "BatchNorm_0": "bn"}[parts[0]]
    if spec_name == "SPPF":
        sub = {"Conv_0": "cv1", "Conv_1": "cv2"}[parts[0]]
        return conv_pair(sub)[parts[1]]
    if spec_name == "C2f":
        top = parts[0]
        if top.startswith("Bottleneck_"):
            k = int(top.split("_")[1])
            inner = {"Conv_0": "cv1", "Conv_1": "cv2"}[parts[1]]
            return conv_pair(f"m.{k}.{inner}")[parts[2]]
        sub = {"Conv_0": "cv1", "Conv_1": "cv2"}[top]
        return conv_pair(sub)[parts[1]]
    if spec_name == "AsffTribeLevel":
        level = int(spec_args[0]) if spec_args else 0
        top = parts[0]
        if top.startswith("Conv2d_"):
            return "weight_levels"
        order = (["stride_level_2", "weight_level_0", "weight_level_1",
                  "weight_level_2", "expand"] if level in (0, 1) else
                 ["compress_level_0", "compress_level_1", "weight_level_0",
                  "weight_level_1", "weight_level_2", "expand"])
        sub = order[int(top.split("_")[1])]
        return {"Conv_0": f"{sub}.conv",
                "BatchNorm_0": f"{sub}.batch_norm"}[parts[1]]
    if spec_name == "Detect":
        m = re.match(r"(cv[23])_(\d+)_(\d+)$", parts[0])
        if m:
            branch, i, j = m.group(1), int(m.group(2)), int(m.group(3))
            if j < 2:
                return conv_pair(f"{branch}.{i}.{j}")[parts[1]]
            return f"{branch}.{i}.{j}"
    if spec_name == "lowlight_recovery":
        top = parts[1] if parts[0] == "ExtractParameters2_0" else parts[0]
        if top.startswith("Conv_"):
            return f"extractor.conv_layers.{int(top.split('_')[1])}.conv_block.0"
        if top in ("Dense_0", "Dense_1"):
            return {"Dense_0": "extractor.fc1", "Dense_1": "extractor.fc2"}[top]
    raise NotImplementedError(
        f"no torch mapping for '{flax_path}' in module '{spec_name}'")


_PAIR = {"conv": "Conv_0", "bn": "BatchNorm_0"}
_CV = {"cv1": "Conv_0", "cv2": "Conv_1"}


def _flax_base(sub: str, spec_name: str, spec_args=()) -> list:
    """The inverse of `_torch_base`: the port's submodule name inside
    `model.{i}` -> the flax path parts inside `mods_{i}`."""
    parts = sub.split(".")
    out = None
    if spec_name == "Conv":
        out = [_PAIR[parts[0]]]
    elif spec_name == "SPPF":
        out = [_CV[parts[0]], _PAIR[parts[1]]]
    elif spec_name == "C2f":
        if parts[0] == "m":
            out = [f"Bottleneck_{parts[1]}", _CV[parts[2]], _PAIR[parts[3]]]
        else:
            out = [_CV[parts[0]], _PAIR[parts[1]]]
    elif spec_name == "AsffTribeLevel":
        if parts[0] == "weight_levels":
            out = ["Conv2d_0", "Conv_0"]
        else:
            level = int(spec_args[0]) if spec_args else 0
            order = (["stride_level_2", "weight_level_0", "weight_level_1",
                      "weight_level_2", "expand"] if level in (0, 1) else
                     ["compress_level_0", "compress_level_1", "weight_level_0",
                      "weight_level_1", "weight_level_2", "expand"])
            out = [f"AddConv_{order.index(parts[0])}",
                   {"conv": "Conv_0", "batch_norm": "BatchNorm_0"}[parts[1]]]
    elif spec_name == "Detect":
        out = ["_".join(parts[:3])] + ([_PAIR[parts[3]]] if len(parts) > 3 else [])
    elif spec_name == "lowlight_recovery":
        if parts[1] == "conv_layers":
            out = ["ExtractParameters2_0", f"Conv_{parts[2]}"]
        else:
            out = ["ExtractParameters2_0",
                   {"fc1": "Dense_0", "fc2": "Dense_1"}[parts[1]]]
    if out is None or _torch_base("/".join(out), spec_name, spec_args) != sub:
        raise NotImplementedError(
            f"no flax mapping for '{sub}' in module '{spec_name}'")
    return out


def state_dict_to_jax(state_dict, model) -> dict:
    """The port's state_dict (or any dict keyed like it: the EMA, an
    optimizer buffer) -> {"params", "batch_stats"} flax trees of float32
    numpy arrays, as the JAX package holds them."""
    specs_by_idx = {s.i: s for s in model.specs}
    perm = _fc1_permutation()
    out = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        arr = arr.astype(np.float32)
        _, i, rest = key.split(".", 2)
        sub, leaf = rest.rsplit(".", 1)
        spec = specs_by_idx[int(i)]
        path = [f"mods_{i}"] + _flax_base(sub, spec.name, spec.args)
        if leaf in ("running_mean", "running_var"):
            section, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            section, name = "params", "bias"
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
    inv_perm = np.argsort(_fc1_permutation())
    sd = {}
    for section in ("params", "batch_stats"):
        for keys, arr in _leaves(variables[section]):
            spec = specs_by_idx[int(keys[0].split("_")[1])]
            leaf = keys[-1]
            tkey = f"model.{spec.i}." + _torch_base("/".join(keys[1:-1]),
                                                     spec.name, spec.args)
            if section == "params":
                if leaf == "kernel" and arr.ndim == 4:
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
    """Seeded random init: conv/linear weights ~ N(0, 1/fan_in), biases 0,
    BN at identity, the Detect biases of reference head.py:95-102.
    Draws on the CPU from one torch.Generator, so a seed gives the same
    weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            std = 1.0 / math.sqrt(w[0].numel())
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for mod in model.modules():
        if isinstance(mod, Detect):
            mod.bias_init()
