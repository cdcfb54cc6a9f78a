"""DetectionTrainer: one train step of the detect task (JAX engine/trainer.py).

What the JAX trainer's step needs and nothing of its epoch loop, data or
checkpoints (ROADMAP A10): `build_optimizer` (:268-312, the 'auto' choice,
the lr schedule and the warmup ramps of lr, bias lr and momentum,
accumulation to `nbs`, decay scaled by batch * accumulate / nbs), the loss
of `make_loss_fn` (:976-1030) and the tree-path `train_step` (:356-372):
forward, backward, `opt_update`, then the EMA on the calls that applied an
update. `get_validator` gives the validator an epoch's val would run.

The loss: u8 / 255, then `img ** dark_param` (lowlight_FLAG), then the
dark-channel priors of the degraded image when prior_mode is 'computed'
(and dedark_FLAG), then the graph in train mode (its BN running stats move
every call), then the v8 loss with the recovery MSE of the degraded image
against the clean one (which has no gradient in the parameters). f32 only:
`amp=True` raises.

    trainer = DetectionTrainer(model, {"batch": 16}, nb=100)  # model: nn.graph.DetectionModel
    total, items = trainer.step(batch, step_index)

`batch` is the JAX loader's dict: 'img' (B, S, S, 3) uint8, 'cls' (B, M),
'bboxes' (B, M, 4) normalised xywh, 'mask_gt' (B, M); numpy or torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cfg import get_cfg
from ..losses.detection import detection_loss
from ..ops.dark_channel import dark_channel_priors
from ..ops.degrade import lowlight_degrade
from ..utils.ema import ema_init, ema_update
from .optim import init_opt_state, label_params, opt_update
from .predictor import resolve_device
from .validator import DetectionValidator

BATCH_KEYS = ("img", "cls", "bboxes", "mask_gt")


class DetectionTrainer:
    def __init__(self, model, overrides=None, nb=1, device=None):
        """model: the port's DetectionModel; overrides: config keys
        (cfg.DEFAULT_CFG); nb: batches an epoch, which sets the schedule;
        device None means cuda and raises without it."""
        self.args = get_cfg(overrides)
        if self.args.amp:
            raise NotImplementedError(
                "amp=True (bf16 training) is not ported yet; train in f32")
        self.device = resolve_device(device if device is not None
                                     else self.args.device)
        self.model = model.to(self.device)
        self.build_optimizer(nb)
        self.params = dict(self.model.named_parameters())
        self.labels = label_params(self.params)
        self.opt_state = init_opt_state(self.params)
        self.ema = ema_init(self.model.state_dict())
        self.ema_updates = 0

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

    def get_validator(self, save_dir=None, data=None):
        """The validator an epoch's val runs (JAX trainer.py:1032-1036): this
        trainer's config with conf 0.001, on the trainer's device."""
        args = get_cfg({**vars(self.args), "conf": 0.001,
                        "device": str(self.device)})
        return DetectionValidator(args=args, save_dir=save_dir, data=data)

    def to_device(self, batch):
        """The batch's four arrays on the trainer's device; from the host
        through pinned memory, without waiting."""
        out = {}
        for k in BATCH_KEYS:
            t = torch.as_tensor(batch[k])
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def loss(self, batch):
        """(total, LossItems) of one device batch, the graph in train mode."""
        a = self.args
        clean = batch["img"].float() / 255.0
        dedark_A = IcA = None
        if a.lowlight_FLAG:
            img = lowlight_degrade(clean, a.dark_param)
            if a.dedark_FLAG and a.prior_mode == "computed":
                dedark_A, IcA = dark_channel_priors(img)
        else:
            img = clean
        raw = self.model(img, dedark_A, IcA)
        lbatch = {"cls": batch["cls"], "bboxes": batch["bboxes"],
                  "mask_gt": batch["mask_gt"],
                  "recovery_loss": ((img - clean) ** 2).mean()}
        hyp = {"box": a.box, "cls": a.cls, "dfl": a.dfl, "lrl": a.lrl}
        return detection_loss(raw, lbatch, nc=self.model.nc,
                              strides=self.model.strides, hyp=hyp)

    def step(self, batch, step_index):
        """One micro-step at global batch `step_index`: forward and backward
        in train mode, `opt_update` (an update every `accumulate` calls),
        the EMA of parameters and BN stats after an applied update. Returns
        the detached total and the (3,) loss items; the model is left in
        eval mode."""
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
