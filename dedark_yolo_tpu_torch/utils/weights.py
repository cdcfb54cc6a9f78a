"""Weights: the seeded init, and the JAX param trees -> the port's state_dict.

`state_dict_from_jax` is a copy, without jax, of the JAX package's
`utils/torch_import.py` (`_torch_base` :62-166 and `export_state_dict`
:237-278) for the modules the port has. It takes the flax
{"params", "batch_stats"} trees as nested dicts of arrays and returns the
reference-named, NCHW/OIHW state_dict that `DetectionModel.load_state_dict`
takes; `opt_state_from_jax` maps an optimizer state the same way.
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


def opt_state_from_jax(opt_state, model):
    """The JAX tree-path optimizer state (engine/optim.py `OptState`: step,
    micro, and the acc / buf / buf2 trees shaped like `params`) -> the
    port's `engine.optim.OptState`, keyed by the port's parameter names.
    The trees map as `state_dict_from_jax` maps the params: every step of
    that map (transposes, the fc1 row permutation) is linear."""
    tree = lambda t: state_dict_from_jax({"params": t, "batch_stats": {}},
                                         model)
    return OptState(step=int(opt_state.step), micro=int(opt_state.micro),
                    acc=tree(opt_state.acc), buf=tree(opt_state.buf),
                    buf2=tree(opt_state.buf2))


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
