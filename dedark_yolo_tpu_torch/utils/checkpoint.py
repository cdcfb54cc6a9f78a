"""Reading the JAX package's checkpoints (JAX utils/checkpoint.py:56-61).

A checkpoint is an npz of flat `'section/mods_i/.../leaf'` arrays (sections
`params`, `batch_stats`, `ema`, `ema_bs`, `opt`) plus a `__meta__` json
string (epoch, train_args, model_yaml, ...). `section_tree` rebuilds one
section as the nested dict that `utils.weights.state_dict_from_jax` takes.
Writing is not ported yet (it comes with the trainer's loop).
"""

from __future__ import annotations

import json

import numpy as np


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
