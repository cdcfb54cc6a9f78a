"""The JAX package's checkpoint container, read and written (JAX
utils/checkpoint.py).

A checkpoint is an npz of flat `'section/mods_i/.../leaf'` arrays (sections
`params`, `batch_stats`, `ema`, `ema_bs`, `opt`) plus a `__meta__` json
string (epoch, best_fitness, updates, train_args, model_yaml, date,
version, has). `section_tree` rebuilds one section as the nested dict that
`utils.weights.state_dict_from_jax` takes; `save_checkpoint` writes nested
dicts (from `utils.weights.state_dict_to_jax` / `opt_state_to_jax`) in the
same layout, so that either package restores what the other wrote.
"""

from __future__ import annotations

import json
from collections.abc import Mapping
from datetime import datetime
from pathlib import Path

import numpy as np

SECTIONS = ("params", "batch_stats", "ema", "ema_bs", "opt")


def load_checkpoint(path):
    """Returns (meta dict, flat dict of arrays keyed 'section/path...')."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, flat


def has_section(flat, section):
    return any(k.startswith(section + "/") for k in flat)


def section_tree(flat, section):
    """The arrays of `section` as a nested dict keyed by the path parts,
    e.g. {'mods_0': {'Conv_0': {'kernel': array}}}."""
    tree = {}
    prefix = section + "/"
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    if not tree:
        raise KeyError(f"checkpoint has no '{section}' section")
    return tree


def _flatten(tree, prefix, out):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def save_checkpoint(path, *, params=None, batch_stats=None, ema_params=None,
                    ema_batch_stats=None, opt_state=None, epoch=0,
                    best_fitness=0.0, updates=0, train_args=None,
                    model_yaml=None):
    """Write the sections given (nested dicts of arrays) and the meta json,
    the keys and arrays the JAX package's `save_checkpoint` writes;
    uncompressed (np.savez) where JAX compresses, by design (compressing
    made a short train() on an H100 several times slower); both packages
    read both."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    trees = {"params": params, "batch_stats": batch_stats, "ema": ema_params,
             "ema_bs": ema_batch_stats, "opt": opt_state}
    flat = {}
    for name in SECTIONS:
        if trees[name] is not None:
            _flatten(trees[name], name, flat)
    meta = {
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        "updates": int(updates),
        "train_args": dict(train_args or {}),
        "model_yaml": model_yaml,
        "date": datetime.now().isoformat(),
        "version": "0.1.0",
        "has": [name for name in SECTIONS if trees[name] is not None],
    }
    # default=str: a Path among the train args is written as its string
    np.savez(path, __meta__=json.dumps(meta, default=str), **flat)
    return path


def transfer_tree(src_tree, dst_tree):
    """Entries of `src_tree` copied into `dst_tree` (flat dicts of tensors keyed
    alike, e.g. state_dicts) wherever the key exists in both and the shapes
    agree; returns (merged, n_transferred, n_total) (JAX
    utils/checkpoint.py:67-90, the reference's intersect_dicts): a new nc
    keeps every backbone and neck weight and re-initialises only the head
    entries whose shape changed."""
    out, n = {}, 0
    for k, d in dst_tree.items():
        s = src_tree.get(k)
        if s is not None and tuple(s.shape) == tuple(d.shape):
            out[k] = s.detach().to(device=d.device, dtype=d.dtype).clone()
            n += 1
        else:
            out[k] = d
    return out, n, len(dst_tree)
