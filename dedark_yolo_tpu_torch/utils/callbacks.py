"""Callback bus of the trainer (JAX utils/callbacks.py:1-98): the hook
points of the reference (ultralytics/utils/callbacks/base.py:146-212) and
the JSONL metrics stream.

Each hook is a list of functions called with the trainer. The JSONL stream
appends one line an epoch ({"epoch", "ts", and every metric}) to
`save_dir/metrics.jsonl`. The TensorBoard writer (JAX :61-80): with
`plots`, a `SummaryWriter(save_dir / "tb")` from train start to train end,
one scalar per metric per epoch; where `torch.utils.tensorboard` does not
import (it needs the `tensorboard` package) there is none, as in the JAX
package. Not ported: the cloud trackers (wandb, mlflow, clearml, comet,
dvc, neptune) that the JAX package registers when their clients import.
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
    """One line of the epoch's metrics under save_dir/metrics.jsonl (rank
    0 of a mesh only)."""
    if not getattr(trainer, "is_main", True):
        return
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


class TensorBoardWriter:
    """The trainer's TensorBoard callbacks; the import is tried at train
    start, and only with `plots`."""

    def __init__(self):
        self.writer = None

    def on_train_start(self, trainer):
        if not (getattr(trainer.args, "plots", False)
                and getattr(trainer, "is_main", True)):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:       # no tensorboard package: no writer
            return
        self.writer = SummaryWriter(log_dir=str(trainer.save_dir / "tb"))

    def on_fit_epoch_end(self, trainer):
        if self.writer is None:
            return
        for k, v in (trainer.metrics or {}).items():
            try:
                self.writer.add_scalar(k, float(v), trainer.epoch)
            except (TypeError, ValueError):
                pass

    def on_train_end(self, trainer):
        if self.writer is not None:
            self.writer.close()
            self.writer = None


def add_integration_callbacks(instance):
    """Attach the JSONL metrics stream and the TensorBoard writer to the
    callbacks of `instance`, a trainer."""
    instance.callbacks["on_fit_epoch_end"].append(jsonl_fit_epoch_end)
    tb = TensorBoardWriter()
    for event in ("on_train_start", "on_fit_epoch_end", "on_train_end"):
        instance.callbacks[event].append(getattr(tb, event))
    return instance.callbacks
