"""The train step and epoch loop (JAX engine/trainer.py): `BaseTrainer`,
the task-neutral step and loop, and `DetectionTrainer`, the detect task's
hooks on it (JAX trainer.py:73-942 and :943-1045). The classify task's
trainer is `engine/classify.py::ClassificationTrainer`.

A task supplies, as JAX's task trainers do: `task`, `loss_names`,
`metric_keys` and `batch_keys` (the loader's arrays a step moves to the
device); `check_data` (the dataset dict), `preflight` (imgsz), `get_model`
(the architecture at the data's nc, seeded); `build_train_dataset` /
`build_train_loader`; `loss(batch)` -> (total, items); `get_validator`;
`dummy_batch` (autobatch); `close_augment` (close_mosaic);
`plot_train_start`, `plot_train_batch` (the label and batch plots). The
base resolves `max_boxes=0` from the train dataset's label counts for every
task but classify (`_resolve_max_boxes`, JAX trainer.py:218-246). The
segment task's trainer is `engine/segment.py::SegmentationTrainer`.

The step (`step`): `build_optimizer` (:268-312, the 'auto' choice, the lr
schedule and the warmup ramps of lr, bias lr and momentum, accumulation to
`nbs`, decay scaled by batch * accumulate / nbs), the loss of
`make_loss_fn` (:976-1030) and the tree-path `train_step` (:356-372):
forward, backward, `opt_update`, then the EMA on the calls that applied an
update.

The loss: u8 / 255, then `img ** dark_param` (lowlight_FLAG), then the
dark-channel priors of the degraded image when prior_mode is 'computed'
(and dedark_FLAG), then the graph in train mode (its BN running stats move
every call), then the v8 loss with the recovery MSE of the degraded image
against the clean one (which has no gradient in the parameters). With
`amp=True` the forward runs in bf16 as the JAX package runs it
(trainer.py:986-1021; no autocast, no loss scaling): every f32 parameter is
cast to bf16 for the forward (`torch.func.functional_call` on the casts, so
the f32 masters get f32 gradients through them), the BN running stats stay
f32, the image is u8 / 255 in bf16 and is degraded and its priors taken in
bf16, and the raw maps go to the loss in f32, beside the recovery MSE of
the two bf16 images taken in f32. The optimizer and the EMA stay f32.

The loop (`train`, :375-733): a warm start from `init_state` or a
`pretrained` .npz (by name and shape), the shuffled, augmented loader of
`data["train"]`, `step` on every batch (under `matmul_precision`, as val
runs: 'default' lets cuDNN and CUDA matmuls use TF32), close_mosaic,
validation of the
EMA weights every `val_period` epochs (on a second module, so the training
weights are never touched), results.csv, EarlyStopping, the callbacks,
last.npz / best.npz / epoch{N}.npz in the JAX package's container written
by one background thread (latest wins per file), resume from last.npz, and
a SIGTERM/SIGINT handler that checkpoints and stops after the epoch. The
inherited orderings of the JAX loop are kept (ROADMAP C6): on_fit_epoch_end
fires before the stop decision and the checkpoint; on_model_save fires on
every epoch with `save`, written or not; with val=False every epoch counts
as improved and refreshes best.npz.

The loop's options of JAX A10b: `loader_mp` makes the items in forked
processes (`data/loader.py`; the pool is closed at the end of `train`, on
its way out after a signal or an error, and re-forked after close_mosaic
so the workers see the change, which the JAX package's pool misses);
`profile` runs the first epoch's micro-step 2 under `torch.profiler` (CPU
and CUDA activities, synchronised before it stops) and writes a Chrome
trace under `save_dir/profile/` (JAX trainer.py:575-592); `batch < 0`
fits the batch to the card with `utils/autobatch.py` (two trial steps'
peak memory; on the CPU it raises). With `plots` (JAX trainer.py:463-476,
566-574, 726-731): `labels.jpg` and `labels_correlogram.jpg` at train
start, `train_batch{0,1,2}.jpg` of the first epoch's first three batches,
`results.png` of results.csv at the end, and val's curves and confusion
matrix; where matplotlib is missing one log line says so and only the
OpenCV mosaics are drawn, and a plot that fails is logged and never ends
the run. Not ported: the device mesh and multi-process training.

    trainer = DetectionTrainer(model, {"batch": 16}, nb=100)  # model: nn.graph.DetectionModel
    total, items = trainer.step(batch, step_index)
    metrics = DetectionTrainer(model, {"data": data, "epochs": 3}).train()

The detect `batch` is the loader's dict: 'img' (B, S, S, 3) uint8, 'cls'
(B, M), 'bboxes' (B, M, 4) normalised xywh, 'mask_gt' (B, M); numpy or
torch.
"""

from __future__ import annotations

import copy
import csv
import math
import signal
import time
from concurrent.futures import CancelledError, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..cfg import AUGMENT_KEYS, get_cfg, yaml_save
from ..data.augment import TrainTransforms
from ..data.dataset import YOLODataset, check_det_dataset
from ..data.loader import DataLoader
from ..losses.detection import detection_loss
from ..ops.dark_channel import dark_channel_priors
from ..ops.degrade import lowlight_degrade
from ..utils import LOGGER, increment_dir
from ..utils.autobatch import autobatch
from ..utils.callbacks import add_integration_callbacks, get_default_callbacks
from ..utils.checkpoint import (has_section, load_checkpoint, save_checkpoint,
                                section_tree, transfer_tree)
from ..utils.checks import check_imgsz
from ..utils.ema import ema_init, ema_update
from ..utils.plotting import (matplotlib_available, plot_images, plot_labels,
                              plot_results)
from ..utils.weights import (init_weights, opt_state_from_jax,
                             opt_state_to_jax, state_dict_from_jax,
                             state_dict_to_jax)
from .optim import OptState, init_opt_state, label_params, opt_update
from .predictor import matmul_precision, resolve_device
from .validator import DetectionValidator


class EarlyStopping:
    """Fitness-plateau stopper (reference torch_utils.py:478-518)."""

    def __init__(self, patience=50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch, fitness):
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


class BaseTrainer:
    """The task-neutral step and loop; a task trainer supplies the hooks
    (see the module docstring)."""

    task = "detect"
    loss_names: tuple = ()
    metric_keys: tuple = ()
    batch_keys: tuple = ()

    def __init__(self, model, overrides=None, nb=1, device=None):
        """model: the port's DetectionModel of this task; overrides:
        config keys (cfg.DEFAULT_CFG); nb: batches an epoch, which sets the
        schedule (`train` sets it from its loader); device None means the
        `device` key, and None there cuda, which raises without a CUDA
        device."""
        self.args = get_cfg(overrides)
        self.device = resolve_device(device if device is not None
                                     else self.args.device)
        self.model = model.to(self.device)
        self.build_optimizer(nb)
        self.init_train_state()
        self.callbacks = get_default_callbacks()
        add_integration_callbacks(self)
        self.save_dir = self._get_save_dir()
        self.wdir = self.save_dir / "weights"
        self.csv = self.save_dir / "results.csv"
        self.best_fitness = 0.0
        self.epoch = 0
        self.metrics = {}
        self.data = None
        self.init_state = None     # a state_dict to warm-start from
        self.transferred = None    # (n, total) after a warm start
        self.epoch_stats = []      # per epoch: seconds of train, val, ckpt
        self.train_dl = self.profile_trace = self.autobatch_info = None
        self._validator = self._val_model = None
        self._interrupted = False
        self._ckpt_pool, self._ckpt_futures = None, {}

    def init_train_state(self):
        """Optimizer state and EMA from the model's current weights."""
        self.params = dict(self.model.named_parameters())
        self.labels = label_params(self.params)
        self.opt_state = init_opt_state(self.params)
        self.ema = ema_init(self.model.state_dict())
        self.ema_updates = 0

    def run_callbacks(self, event):
        for cb in self.callbacks.get(event, []):
            cb(self)

    def _get_save_dir(self):
        a = self.args
        project = Path(a.project or f"runs/{self.task}")
        return increment_dir(project / (a.name or "train"),
                             a.exist_ok or a.resume)

    def build_optimizer(self, nb):
        """The optimizer's name, lr0 and momentum, the per-step lr and
        momentum (`lr_at`, `momentum_at`), `accumulate` and the scaled
        decay (JAX trainer.py:268-312)."""
        a = self.args
        epochs = max(int(a.epochs), 1)
        if a.optimizer == "auto":
            use_adamw = nb * epochs < 10000
            lr0 = (round(0.002 * 5 / (4 + self.model.nc), 6) if use_adamw
                   else a.lr0)
            momentum = 0.9 if use_adamw else a.momentum
            opt_name = "adamw" if use_adamw else "sgd"
        else:
            opt_name = "adamw" if a.optimizer.lower() in (
                "adamw", "adam", "nadam", "radam") else "sgd"
            lr0, momentum = a.lr0, a.momentum
        self.opt_name, self.lr0, self.momentum = opt_name, lr0, momentum
        if a.cos_lr:
            self.lf = lambda e: ((1 - math.cos(e * math.pi / epochs)) / 2
                                 * (a.lrf - 1) + 1)
        else:
            self.lf = lambda e: max(1 - e / epochs, 0) * (1.0 - a.lrf) + a.lrf
        self.nb = nb
        self.nw = (max(round(a.warmup_epochs * nb), 100)
                   if a.warmup_epochs > 0 else -1)
        self.accumulate = max(round(a.nbs / a.batch), 1)
        self.weight_decay = (float(a.weight_decay) * a.batch * self.accumulate
                             / a.nbs)

    def lr_at(self, step, group="weight"):
        """lr of `group` at global batch `step`: lr0 * lf(epoch), ramped
        linearly from 0 (bias: warmup_bias_lr) over the warmup steps."""
        base = self.lr0 * self.lf(int(step / self.nb))
        if self.nw > 0 and step < self.nw:
            start = self.args.warmup_bias_lr if group == "bias" else 0.0
            return float(np.interp(step, [0, self.nw], [start, base]))
        return float(base)

    def momentum_at(self, step):
        if self.nw > 0 and step < self.nw:
            return float(np.interp(step, [0, self.nw],
                                   [self.args.warmup_momentum, self.momentum]))
        return float(self.momentum)

    # ------------------------------------------------------------ task hooks
    @staticmethod
    def check_data(data):
        """The dataset dict of `data` (JAX trainer.py:163-164)."""
        raise NotImplementedError

    def preflight(self):
        """Arg fixups before the run (JAX trainer.py:166-169)."""

    @classmethod
    def get_model(cls, cfg, nc, seed=0):
        """The architecture dict `cfg` at `nc` classes, built on the CPU
        with `seed`ed weights (JAX trainer.py:198-207)."""
        from ..nn.graph import DetectionModel
        with torch.device("meta"):
            net = DetectionModel(cfg, nc=nc)
        if net.task != cls.task:
            raise ValueError(f"{cls.__name__} trains {cls.task} models; this "
                             f"architecture is a {net.task} model")
        net = net.to_empty(device="cpu")
        init_weights(net, seed)
        return net

    def build_train_dataset(self):
        raise NotImplementedError

    def build_train_loader(self):
        """A loader: len(), set_epoch(e), close(), iteration -> batch."""
        raise NotImplementedError

    def loss(self, batch):
        """(total, items) of one device batch, the graph in train mode;
        items match `loss_names`."""
        raise NotImplementedError

    def get_validator(self, save_dir=None, data=None):
        raise NotImplementedError

    def dummy_batch(self, b):
        """A zero batch of b images at the run's shapes (autobatch)."""
        raise NotImplementedError

    def close_augment(self):
        """Fired at epochs - close_mosaic (JAX trainer.py:261-262)."""

    def _resolve_max_boxes(self):
        """max_boxes=0 -> the densest composite the augmentation can make:
        the top-k label counts summed, k = 4 with mosaic (x2 with mixup, x2
        again with copy_paste), rounded up to a multiple of 8 in [8, 1024]
        (JAX trainer.py:218-246). A dataset's `labels` are its images' label
        rows (detect) or instance lists (segment); classify has none."""
        a = self.args
        if int(a.max_boxes) > 0 or self.task == "classify":
            return
        counts = sorted((len(lb) for lb in self.build_train_dataset().labels),
                        reverse=True)
        k = 4 if a.mosaic > 0 else 1
        if a.mixup > 0:
            k *= 2
        top = sum(counts[:k]) if counts else 1
        if a.copy_paste > 0:
            top *= 2
        a.max_boxes = int(np.clip(math.ceil(max(top, 1) / 8) * 8, 8, 1024))
        LOGGER.info(f"auto max_boxes: {a.max_boxes} "
                    f"(top-{k} label sum {top}, {len(counts)} images)")


    def plot_train_start(self):
        """Plots of the dataset at train start (plots=True)."""

    def plot_train_batch(self, batch, path):
        """A plot of one of the first epoch's first three batches."""

    def to_device(self, batch):
        """The batch's `batch_keys` arrays on the trainer's device; from the
        host through pinned memory, without waiting."""
        out = {}
        for k in self.batch_keys:
            t = torch.as_tensor(batch[k])
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def step(self, batch, step_index):
        """One micro-step at global batch `step_index`: forward and backward
        in train mode, `opt_update` (an update every `accumulate` calls),
        the EMA of parameters and BN stats after an applied update. Returns
        the detached total and the loss items stacked (detect's (3,)); the
        model is left in eval mode."""
        batch = self.to_device(batch)
        names = list(self.params)
        self.model.train()
        try:
            total, items = self.loss(batch)
            grads = torch.autograd.grad(
                total, [self.params[n] for n in names], allow_unused=True)
        finally:
            self.model.eval()
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        applied = opt_update(
            self.params, grads, self.opt_state, self.labels,
            kind=self.opt_name, lr_bias=self.lr_at(step_index, "bias"),
            lr=self.lr_at(step_index), momentum=self.momentum_at(step_index),
            weight_decay=self.weight_decay, accumulate=self.accumulate)
        if applied:
            self.ema_updates = ema_update(self.ema, self.model.state_dict(),
                                          self.ema_updates)
        return total.detach(), torch.stack(list(items))

    # ------------------------------------------------------------------ loop
    def _autobatch(self):
        """The batch for batch < 0 (JAX trainer.py:735-747): each trial is
        the loss and its gradients on a zero batch, as JAX measures
        `jax.grad` of the loss; the BN running stats are put back after."""
        def measure(b):
            stats = {k: v.clone() for k, v in self.model.named_buffers()}
            batch = self.to_device(self.dummy_batch(b))
            self.model.train()
            try:
                total, _ = self.loss(batch)
                torch.autograd.grad(total, list(self.params.values()),
                                    allow_unused=True)
            finally:
                self.model.eval()
                with torch.no_grad():
                    for k, v in self.model.named_buffers():
                        v.copy_(stats[k])

        b, self.autobatch_info = autobatch(measure, self.device)
        return b

    def _profile_start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _profile_stop(self, prof, step):
        """Wait for the traced step's device work (JAX's
        block_until_ready), then write the Chrome trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.save_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        self.profile_trace = out / f"step{step}.pt.trace.json"
        prof.export_chrome_trace(str(self.profile_trace))

    def _warm_start(self):
        """Weights by name and shape from `init_state` (the facade's
        state_dict) or, without one, a `pretrained` .npz (its EMA with
        ema_bs, else params with batch_stats); skipped on resume (JAX
        trainer.py:111-153)."""
        a = self.args
        if a.resume:
            return
        src = self.init_state
        if src is None and isinstance(a.pretrained, (str, Path)) and a.pretrained:
            _, flat = load_checkpoint(a.pretrained)
            sec = "ema" if has_section(flat, "ema") else "params"
            bs = ("ema_bs" if sec == "ema" and has_section(flat, "ema_bs")
                  else "batch_stats")
            src = state_dict_from_jax({"params": section_tree(flat, sec),
                                       "batch_stats": section_tree(flat, bs)},
                                      self.model)
        if src is None:
            return
        merged, n, total = transfer_tree(src, self.model.state_dict())
        self.model.load_state_dict(merged)
        self.transferred = (n, total)
        LOGGER.info(f"transferred {n}/{total} items from pretrained weights")

    def _resume(self):
        """Weights, EMA, optimizer state, update count and best fitness
        from last.npz; returns the epoch to start from (JAX
        trainer.py:909-941)."""
        ckpt = self.wdir / "last.npz"
        if not ckpt.is_file():
            LOGGER.info("no checkpoint to resume from; starting fresh")
            return 0
        meta, flat = load_checkpoint(ckpt)
        to_dev = lambda sd: {k: v.to(self.device) for k, v in sd.items()}
        self.model.load_state_dict(state_dict_from_jax(
            {"params": section_tree(flat, "params"),
             "batch_stats": section_tree(flat, "batch_stats")}, self.model))
        self.ema = to_dev(state_dict_from_jax(
            {"params": section_tree(flat, "ema"),
             "batch_stats": section_tree(
                 flat, "ema_bs" if has_section(flat, "ema_bs")
                 else "batch_stats")}, self.model))
        if has_section(flat, "opt"):
            st = opt_state_from_jax(section_tree(flat, "opt"), self.model)
            self.opt_state = OptState(step=st.step, micro=st.micro,
                                      acc=to_dev(st.acc), buf=to_dev(st.buf),
                                      buf2=to_dev(st.buf2))
        self.ema_updates = int(meta["updates"])
        self.best_fitness = float(meta["best_fitness"])
        start = int(meta["epoch"]) + 1
        LOGGER.info(f"resumed from {ckpt} at epoch {start}")
        return start

    def _ema_model(self):
        """A second module holding the EMA weights, for val."""
        if self._val_model is None:
            self._val_model = copy.deepcopy(self.model)
        self._val_model.load_state_dict(self.ema)
        return self._val_model.eval()

    def _validate(self, state=None):
        if self._validator is None:
            self._validator = self.get_validator(save_dir=self.save_dir,
                                                 data=self.data)
            self._validator.note_no_matplotlib = False   # train said it
        model = self._ema_model()
        if state is not None:
            model.load_state_dict(state)
        return self._validator(model=model)

    def _on_signal(self, signum, frame):
        if self._interrupted:
            # a second signal aborts at once
            for s, h in self._prev_handlers.items():
                signal.signal(s, h)
            raise KeyboardInterrupt
        self._interrupted = True
        LOGGER.info(f"signal {signum}: will checkpoint and stop after this "
                    "epoch (resume with resume=True); repeat to abort")

    def train(self):
        """The epoch loop on `data`; returns the last validation's results
        (those of best.npz when it is not the last epoch's)."""
        a = self.args
        if not a.data:
            raise ValueError("training needs `data` (a dataset yaml or dict)")
        self.data = self.check_data(a.data)
        self.preflight()
        self.run_callbacks("on_pretrain_routine_start")
        self.wdir.mkdir(parents=True, exist_ok=True)
        yaml_save(self.save_dir / "args.yaml", dict(vars(a)))

        self._warm_start()
        self._resolve_max_boxes()
        if a.batch < 0:
            a.batch = self._autobatch()
        train_dl = self.train_dl = self.build_train_loader()
        nb = len(train_dl)
        if nb == 0:
            raise ValueError("empty train loader (batch larger than the dataset?)")
        if a.plots:
            self.plot_train_start()
        self.build_optimizer(nb)
        self.init_train_state()
        start_epoch = self._resume() if a.resume else 0
        stopper = EarlyStopping(a.patience)
        stopper.best_fitness = self.best_fitness
        n_params = sum(p.numel() for p in self.params.values())
        LOGGER.info(f"{self.opt_name} optimizer, lr0={self.lr0}, "
                    f"accumulate={self.accumulate}, params={n_params:,}")
        self.run_callbacks("on_train_start")

        t_train = time.time()
        self._interrupted = False
        self._prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        except ValueError:
            self._prev_handlers = {}   # not the main thread: unguarded
        step = start_epoch * nb       # resume continues the schedule
        epoch = start_epoch
        try:
            for epoch in range(start_epoch, a.epochs):
                self.epoch = epoch
                self.run_callbacks("on_train_epoch_start")
                train_dl.set_epoch(epoch)
                if a.close_mosaic and epoch >= a.epochs - a.close_mosaic:
                    self.close_augment()
                t0 = time.time()
                wait = 0.0
                items_log = []
                batches = iter(train_dl)
                while True:
                    tw = time.perf_counter()
                    batch = next(batches, None)
                    wait += time.perf_counter() - tw
                    if batch is None:
                        break
                    self.run_callbacks("on_train_batch_start")
                    if a.plots and epoch == start_epoch and len(items_log) < 3:
                        self.plot_train_batch(batch, self.save_dir / (
                            f"train_batch{len(items_log)}.jpg"))
                    prof = (self._profile_start() if a.profile
                            and epoch == start_epoch and len(items_log) == 2
                            else None)
                    with matmul_precision(a.matmul_precision):
                        items_log.append(self.step(batch, step)[1])
                    if prof is not None:
                        self._profile_stop(prof, step)
                    step += 1
                    self.run_callbacks("on_train_batch_end")
                mloss = torch.stack(items_log).mean(0).cpu().numpy()
                epoch_time = time.time() - t0
                self.run_callbacks("on_train_epoch_end")
                lr_now = self.lr_at(step)

                fitness, metrics = 0.0, {}
                val_this_epoch = ((epoch + 1) % max(1, a.val_period) == 0
                                  or epoch == a.epochs - 1)
                t_val = time.time()
                if a.val and val_this_epoch:
                    metrics = self._validate()
                    fitness = float(metrics.get("fitness", 0.0))
                t_val = time.time() - t_val
                self.metrics = metrics
                self._save_csv(epoch, mloss, metrics, lr_now)

                # best and EarlyStopping advance on epochs with a real
                # fitness: every epoch without val, else validated ones
                track = (not a.val) or val_this_epoch
                improved = track and fitness >= self.best_fitness
                if improved:
                    self.best_fitness = fitness
                self.run_callbacks("on_fit_epoch_end")
                stop = False
                if track and stopper(epoch, fitness):
                    LOGGER.info(f"EarlyStopping at epoch {epoch + 1} "
                                f"(no improvement for {a.patience} epochs)")
                    stop = True
                if self._interrupted:
                    LOGGER.info("interrupted: checkpointing and stopping "
                                f"after epoch {epoch + 1}")
                    stop = True
                t_ckpt = time.time()
                if a.save:
                    write_last = ((epoch + 1) % max(1, a.ckpt_period) == 0
                                  or stop or epoch == a.epochs - 1)
                    self._save_ckpt(epoch, improved, write_last)
                    self.run_callbacks("on_model_save")
                t_ckpt = time.time() - t_ckpt
                self.epoch_stats.append({
                    "epoch": epoch, "batches": len(items_log),
                    "train_s": epoch_time, "loader_wait_s": wait,
                    "val_s": t_val, "ckpt_s": t_ckpt})
                loss_str = " ".join(f"{n} {v:.4f}"
                                    for n, v in zip(self.loss_names, mloss))
                LOGGER.info(
                    f"epoch {epoch + 1}/{a.epochs} {loss_str} lr {lr_now:.5f} "
                    f"fitness {fitness:.4f} (train {epoch_time:.1f}s val "
                    f"{t_val:.1f}s ckpt {t_ckpt:.1f}s)")
                if stop:
                    break
        finally:
            # flush the writer before the handlers go back: a signal during
            # the flush must not tear last.npz
            train_dl.close()
            self._ckpt_drain()
            for sig, h in self._prev_handlers.items():
                signal.signal(sig, h)
        LOGGER.info(f"training done in {(time.time() - t_train) / 3600:.3f}h; "
                    f"results in {self.save_dir}")
        best = self.wdir / "best.npz"
        if a.val and best.is_file() and self._validator is not None:
            meta, flat = load_checkpoint(best)
            if meta["epoch"] != epoch:   # else this epoch's val ran already
                LOGGER.info(f"validating best.npz (epoch {meta['epoch'] + 1})")
                self.metrics = self._validate(state_dict_from_jax(
                    {"params": section_tree(flat, "ema"),
                     "batch_stats": section_tree(flat, "ema_bs")}, self.model))
        if a.plots:
            self._plot(plot_results, self.csv)
        self.run_callbacks("on_train_end")
        return self.metrics

    @staticmethod
    def _plot(fn, *args, **kwargs):
        """fn(*args, **kwargs); a failure is logged, never raised: a plot
        never ends a run."""
        try:
            fn(*args, **kwargs)
        except Exception as e:
            LOGGER.info(f"{fn.__name__} failed: {e!r}")

    # --------------------------------------------------------------- persist
    def _save_csv(self, epoch, mloss, metrics, lr):
        keys = (["epoch"] + [f"train/{n}_loss" for n in self.loss_names]
                + list(self.metric_keys) + ["lr"])
        vals = ([epoch] + list(mloss.tolist())
                + [metrics.get(k, 0.0) for k in self.metric_keys] + [lr])
        write_header = not self.csv.exists()
        with open(self.csv, "a", newline="") as f:
            w = csv.writer(f)
            if write_header:
                w.writerow(keys)
            w.writerow(vals)

    def _save_ckpt(self, epoch, improved, write_last=True):
        """Queue last.npz (with the optimizer state), best.npz and
        epoch{N}.npz as due. The state is copied on the device here; the
        copy to the host, the map to flax trees and the write (np.savez,
        uncompressed by design; JAX compresses, both read both) run on the
        writer thread."""
        a = self.args
        epoch_due = a.save_period > 0 and (epoch + 1) % a.save_period == 0
        if not (write_last or improved or epoch_due):
            return
        snap = lambda sd: {k: v.detach().clone() for k, v in sd.items()}
        common = {"model": snap(self.model.state_dict()),
                  "ema": snap(self.ema), "epoch": epoch,
                  "best_fitness": self.best_fitness,
                  "updates": self.ema_updates,
                  "train_args": dict(vars(a)), "model_yaml": self.model.yaml}
        opt = None
        if write_last:
            st = self.opt_state
            opt = OptState(step=st.step, micro=st.micro, acc=snap(st.acc),
                           buf=snap(st.buf), buf2=snap(st.buf2))
            self._ckpt_async(self.wdir / "last.npz", common, opt)
        if improved:
            self._ckpt_async(self.wdir / "best.npz", common)
        if epoch_due:
            self._ckpt_async(self.wdir / f"epoch{epoch}.npz", common)

    def _write_ckpt(self, path, common, opt=None):
        model = self.model
        cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
        state = state_dict_to_jax(cpu(common["model"]), model)
        ema = state_dict_to_jax(cpu(common["ema"]), model)
        if opt is not None:
            opt = opt_state_to_jax(OptState(
                step=opt.step, micro=opt.micro, acc=cpu(opt.acc),
                buf=cpu(opt.buf), buf2=cpu(opt.buf2)), model)
        return save_checkpoint(
            path, params=state["params"], batch_stats=state["batch_stats"],
            ema_params=ema["params"], ema_batch_stats=ema["batch_stats"],
            opt_state=opt, epoch=common["epoch"],
            best_fitness=common["best_fitness"], updates=common["updates"],
            train_args=common["train_args"], model_yaml=common["model_yaml"])

    def _ckpt_async(self, path, common, opt=None):
        """Queue one write on the background writer. At most one queued
        write a path: a newer one cancels a stale one not yet started
        (latest wins); a write that failed raises on the next call."""
        if self._ckpt_pool is None:
            self._ckpt_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        key = str(path)
        prev = self._ckpt_futures.get(key)
        if prev is not None and not prev.cancel() and prev.done():
            prev.result()
        self._ckpt_futures[key] = self._ckpt_pool.submit(
            self._write_ckpt, path, common, opt)

    def _ckpt_drain(self):
        """Wait for every queued write; re-raise a writer's error."""
        for f in self._ckpt_futures.values():
            try:
                f.result()
            except CancelledError:
                pass   # superseded by a newer write of the same path
        self._ckpt_futures = {}
        if self._ckpt_pool is not None:
            self._ckpt_pool.shutdown()
            self._ckpt_pool = None


class DetectionTrainer(BaseTrainer):
    """The detect task's hooks (JAX trainer.py:943-1045): the YOLO dataset
    and its augmented loader, the v8 loss of the (degraded) image with the
    recovery MSE, bf16 under `amp`, mAP validation."""

    task = "detect"
    loss_names = ("box", "cls", "dfl")
    metric_keys = ("metrics/precision(B)", "metrics/recall(B)",
                   "metrics/mAP50(B)", "metrics/mAP50-95(B)")
    batch_keys = ("img", "cls", "bboxes", "mask_gt")
    check_data = staticmethod(check_det_dataset)

    def preflight(self):
        a = self.args
        a.imgsz = check_imgsz(a.imgsz, stride=32)

    def close_augment(self):
        """close_mosaic: the last epochs letterbox instead of mosaicking
        (forked workers are closed, so the next epoch forks them anew)."""
        self.train_tf.mosaic_enabled = False
        if getattr(self, "train_dl", None) is not None:
            self.train_dl.close()

    def get_validator(self, save_dir=None, data=None):
        """The validator an epoch's val runs (JAX trainer.py:1032-1036): this
        trainer's config with conf 0.001, on the trainer's device."""
        args = get_cfg({**vars(self.args), "conf": 0.001,
                        "device": str(self.device)})
        return DetectionValidator(args=args, save_dir=save_dir, data=data)

    def loss(self, batch):
        """(total, LossItems) of one device batch, the graph in train mode."""
        a = self.args
        amp = bool(a.amp)
        clean = batch["img"].to(torch.bfloat16 if amp else torch.float32) / 255.0
        dedark_A = IcA = None
        if a.lowlight_FLAG:
            img = lowlight_degrade(clean, a.dark_param)
            if a.dedark_FLAG and a.prior_mode == "computed":
                dedark_A, IcA = dark_channel_priors(img)
        else:
            img = clean
        if amp:
            bf16 = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                    for n, p in self.params.items()}
            raw = torch.func.functional_call(self.model, bf16,
                                             (img, dedark_A, IcA))
            raw = [r.float() for r in raw]
        else:
            raw = self.model(img, dedark_A, IcA)
        lbatch = {"cls": batch["cls"], "bboxes": batch["bboxes"],
                  "mask_gt": batch["mask_gt"],
                  "recovery_loss": ((img.float() - clean.float()) ** 2).mean()}
        hyp = {"box": a.box, "cls": a.cls, "dfl": a.dfl, "lrl": a.lrl}
        return detection_loss(raw, lbatch, nc=self.model.nc,
                              strides=self.model.strides, hyp=hyp)

    def build_train_dataset(self):
        if getattr(self, "train_ds", None) is None:
            a = self.args
            self.train_ds = YOLODataset(self.data["train"], imgsz=a.imgsz,
                                        nc=self.data["nc"], cache=a.cache,
                                        fraction=a.fraction,
                                        single_cls=a.single_cls)
        return self.train_ds

    def build_train_loader(self):
        a = self.args
        hyp = {k: getattr(a, k) for k in AUGMENT_KEYS}
        self.train_tf = TrainTransforms(hyp, imgsz=a.imgsz)
        return DataLoader(self.build_train_dataset(), self.train_tf, a.batch,
                          max_boxes=a.max_boxes, workers=a.workers,
                          shuffle=True, seed=a.seed, drop_last=True,
                          use_processes=bool(a.loader_mp))

    def dummy_batch(self, b):
        """A zero batch of b images at the run's shapes (autobatch)."""
        a = self.args
        return {"img": np.zeros((b, a.imgsz, a.imgsz, 3), np.uint8),
                "bboxes": np.zeros((b, a.max_boxes, 4), np.float32),
                "cls": np.zeros((b, a.max_boxes), np.float32),
                "mask_gt": np.zeros((b, a.max_boxes), np.float32)}

    def plot_train_start(self):
        if not matplotlib_available():
            LOGGER.info("plots: matplotlib is not installed; train draws "
                        "only the batch mosaics (OpenCV)")
        lbs = [lb for lb in self.train_ds.labels if len(lb)]
        if lbs:
            cat = np.concatenate(lbs, 0)
            self._plot(plot_labels, cat[:, 1:5], cat[:, 0],
                       names=self.data.get("names"), save_dir=self.save_dir)

    def plot_train_batch(self, batch, path):
        self._plot(plot_images, batch, path, names=self.data.get("names"))
