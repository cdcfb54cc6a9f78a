"""Callback bus of the trainer (JAX utils/callbacks.py:1-98): the hook
points of the reference (ultralytics/utils/callbacks/base.py:146-212) and
the JSONL metrics stream.

Each hook is a list of functions called with the trainer. The JSONL stream
appends one line an epoch ({"epoch", "ts", and every metric}) to
`save_dir/metrics.jsonl`. Not ported: the TensorBoard writer and the cloud
trackers (wandb, mlflow, clearml, comet, dvc, neptune) that the JAX package
registers when their clients import.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

HOOKS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
    "on_train_epoch_start", "on_train_batch_start", "optimizer_step",
    "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "on_params_update",
    "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end",
    "on_predict_batch_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


def get_default_callbacks():
    return defaultdict(list, {h: [] for h in HOOKS})


def jsonl_fit_epoch_end(trainer):
    """One line of the epoch's metrics under save_dir/metrics.jsonl."""
    rec = {"epoch": trainer.epoch, "ts": time.time()}
    for k, v in (trainer.metrics or {}).items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            pass
    try:
        with open(trainer.save_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def add_integration_callbacks(trainer):
    """Attach the JSONL metrics stream to the trainer's callbacks."""
    trainer.callbacks["on_fit_epoch_end"].append(jsonl_fit_epoch_end)
    return trainer.callbacks
