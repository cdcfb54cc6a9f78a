"""YOLO facade (JAX engine/model.py): build a model or load a checkpoint,
then train, predict or validate.

    YOLO("yolov8l.yaml", nc=3)   # the architecture, seeded random weights
    YOLO("best.npz")             # a checkpoint of either package (its EMA weights)
    YOLO(["a.npz", "b.npz"])     # an ensemble of checkpoints of one architecture
    YOLO("model.pt2")            # an exported artifact: predict and val only

The model lives on `device` (None means cuda, and raises without a CUDA
device); `train`, `predict`, `val` and `track` run on their own `device`
key, cuda by default. The rest of the JAX facade (model.py:272-514):
`track` (the predictor's stream through a host tracker, `trackers/`),
`benchmark` (precision x batch, `engine/benchmarks.py`), `__call__`,
`names`, `transforms`, `to`, `load`, `reset_weights`, `fuse`,
`add_callback` / `clear_callback`, `tune` and `info`, `export`
(`engine/exporter.py`) and `benchmark(formats=...)`. An exported `.pt2`
runs predict and val through AutoBackend (JAX model.py:40-50, 160-190):
the artifact's imgsz and batch win and val runs square; train and export
need live weights and raise. `train`, `val` and `predict` dispatch on the
model's task (JAX model.py:132-139, 181-214, 230-262): a classify model
(`yolov8{n,s,m,l,x}-cls.yaml`, its checkpoint or its `.pt2`) trains,
validates and predicts through `engine/classify.py`, a segment model
(`yolov8{n,s,m,l,x}-seg.yaml`, its checkpoint or its `.pt2`) through
`engine/segment.py`; `track` takes detect models only (segment tracking is
ROADMAP A12e-b).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..cfg import DEFAULT_CFG, get_cfg, model_yaml_load
from ..nn.enhance import LowlightRecovery
from ..nn.graph import DetectionModel
from ..utils import LOGGER, increment_dir
from ..utils.checkpoint import (has_section, load_checkpoint, section_tree,
                                transfer_tree)
from ..utils.patches import require
from ..utils.weights import init_weights, state_dict_from_jax
from .autobackend import refuse_jax_artifact
from .classify import (ClassificationPredictor, ClassificationTrainer,
                       ClassificationValidator)
from .predictor import DetectionPredictor, resolve_device
from .segment import (SegmentationPredictor, SegmentationTrainer,
                      SegmentationValidator)
from .trainer import DetectionTrainer
from .validator import DetectionValidator

# a model task's trainer, validator and predictor; a predictor of another
# task takes no ensemble members
TASK_CLASSES = {
    "detect": (DetectionTrainer, DetectionValidator, DetectionPredictor),
    "segment": (SegmentationTrainer, SegmentationValidator,
                SegmentationPredictor),
    "classify": (ClassificationTrainer, ClassificationValidator,
                 ClassificationPredictor)}

# train_args a checkpoint carries into predict and val (JAX model.py:90-92)
CARRIED_ARGS = ("imgsz", "data", "single_cls", "contrast_mode")


class YOLO:
    def __init__(self, model="yolov8l.yaml", nc=None, device=None, seed=0):
        """model: an architecture (a built-in name such as 'yolov8l.yaml' or
        a yaml file) with `seed`ed weights, a JAX `.npz` checkpoint, or a
        list of checkpoints of one architecture (an ensemble)."""
        self.device = resolve_device(device)
        self.overrides = {}
        self.predictor = self.validator = self.trainer = self.metrics = None
        self._user_callbacks = {}
        self.ckpt_path = None      # the .npz this facade was loaded from
        self.members = []          # an ensemble's other members' state dicts
        self._backend_spec = self._backend = None   # an artifact, its AutoBackend
        if isinstance(model, (list, tuple)):
            self._load_ensemble([str(m) for m in model])
            return
        model = str(model)
        if model.endswith(".npz"):
            self._load(model)
            return
        if model.endswith(".pt2"):
            self._backend_spec, self.model = model, None
            return
        refuse_jax_artifact(model)
        self.model_yaml = model_yaml_load(model)
        self._build(nc)
        init_weights(self.model, seed)

    def _build(self, nc=None):
        with torch.device("meta"):
            net = DetectionModel(self.model_yaml, nc=nc)
        self.model = net.to_empty(device=self.device).eval()

    def _load(self, path):
        """The checkpoint's architecture with its EMA weights (`ema`, with
        `ema_bs` or else `batch_stats`), or its raw `params` when it has no
        EMA; its train_args' imgsz, data, single_cls and contrast_mode
        become the defaults of predict and val, its names the model's (JAX
        model.py:62-94)."""
        meta, flat = load_checkpoint(path)
        self.ckpt_path = path
        train_args = meta.get("train_args") or {}
        self.model_yaml = meta["model_yaml"]
        self._build()
        section = "ema" if has_section(flat, "ema") else "params"
        bs = ("ema_bs" if section == "ema" and has_section(flat, "ema_bs")
              else "batch_stats")
        variables = {"params": section_tree(flat, section),
                     "batch_stats": section_tree(flat, bs)}
        self.model.load_state_dict(state_dict_from_jax(variables, self.model),
                                   strict=True)
        self.overrides = {k: train_args[k] for k in CARRIED_ARGS
                          if k in train_args}
        names = train_args.get("names")
        if isinstance(names, (list, tuple)):
            names = dict(enumerate(names))
        if names:
            # json turned the integer keys into strings
            self.model.names = {int(k): v for k, v in names.items()}

    def _load_ensemble(self, paths):
        """The first checkpoint as the model, the others' weights (kept on
        the CPU, moved to the predict device once a predictor) as the
        members whose candidates join before NMS (JAX model.py:31-36,
        96-108). Every member must have the first one's architecture: one
        module runs them all."""
        self._load(paths[0])
        for p in paths[1:]:
            other = YOLO(p, device="cpu")
            if other.model_yaml != self.model_yaml:
                raise ValueError(
                    f"ensemble member {p} has another architecture than "
                    f"{paths[0]}; the members share one module")
            self.members.append(other.state_dict())
        if self.members:
            LOGGER.info(f"ensembled {len(paths)} checkpoints (candidates "
                        "joined before NMS)")

    def state_dict(self):
        return self.model.state_dict()

    def load_state_dict(self, state_dict, strict=True):
        return self.model.load_state_dict(state_dict, strict=strict)

    def _args(self, kwargs):
        """Config of a predict or val call: the checkpoint's carried
        train_args under the call's kwargs. contrast_mode changes layer 0's
        filter math, not the params (JAX model.py _sync_model_opts rebuilds
        the graph for it)."""
        args = get_cfg({**self.overrides, **kwargs})
        for m in self.model.modules() if self.model is not None else ():
            if isinstance(m, LowlightRecovery):
                m.contrast_mode = args.contrast_mode
        return args

    def _make_backend(self, args):
        """The artifact's AutoBackend on the args' device (kept while the
        device stays); its fixed imgsz and batch become the args', and val
        runs square (JAX model.py:160-172)."""
        from .autobackend import AutoBackend
        device = resolve_device(args.device)
        if self._backend is None or self._backend.device != device:
            self._backend = AutoBackend(self._backend_spec, device=device)
        self.device = device
        args.imgsz, args.batch = self._backend.imgsz, self._backend.batch
        args.rect = False
        return self._backend

    def _live(self, what):
        if self._backend_spec is not None:
            raise ValueError(f"{what} needs live weights; this YOLO wraps the "
                             f"exported artifact {self._backend_spec}")

    @property
    def task(self):
        """The model's task: the live model's, or an artifact's sidecar's
        (detect where it has none)."""
        if self._backend_spec is None:
            return self.model.task
        side = Path(str(self._backend_spec) + ".json")
        return (json.loads(side.read_text()).get("task", "detect")
                if side.is_file() else "detect")

    def predict(self, source, stream=False, **kwargs):
        """Detections for every image of `source` (see
        `predictor.load_source`): a list of Results, or with stream=True a
        generator of them.

        kwargs are predict config keys (cfg.DEFAULT_CFG); device None means
        cuda, and the model moves to the predict device. `save` is off
        unless given (the JAX facade inherits save=True from its defaults;
        the CLI passes it): saving draws and encodes through OpenCV, which
        the card's host lacks. With `project`, files go to
        project/name (name default 'predict', incremented unless exist_ok),
        else to runs/detect/predict*. A classify model gives a Results
        with `probs` an image (`ClassificationPredictor`; nothing saved).
        """
        args = self._args({"save": False, **kwargs})
        model = (self._make_backend(args) if self._backend_spec
                 else self.model)
        save_dir = None
        if args.project:
            save_dir = increment_dir(Path(args.project) / (args.name or
                                                             "predict"),
                                     args.exist_ok)
        predictor_cls = TASK_CLASSES[model.task][2]
        if predictor_cls is DetectionPredictor:
            self.predictor = DetectionPredictor(args=args, model=model,
                                                names=model.names,
                                                save_dir=save_dir,
                                                members=self.members)
        else:
            if self.members:
                LOGGER.warning(f"a {model.task} model predicts with the "
                               "first ensemble member only")
            self.predictor = predictor_cls(args=args, model=model,
                                           names=model.names,
                                           save_dir=save_dir)
        self.device = self.predictor.device
        return self.predictor(source, stream=stream)

    def track(self, source, stream=False, persist=False, **kwargs):
        """Multi-object tracking over a video or image-sequence source (JAX
        model.py:276-340): detection runs batched on the device through
        the predictor's stream, association on the host a frame at a time
        (`trackers/`); each Results' boxes carry the track id in a 7th
        column. conf defaults to 0.1 (ByteTrack needs the low-score
        candidates). persist=True keeps the tracker of the previous call
        (ids continue) and across a source's files (a directory of frames
        or `.npy` arrays is one sequence); else a fresh tracker of the
        `tracker` config (botsort.yaml by default) starts. Saving runs
        after the ids are stamped: `save` writes annotated frames (a
        video's as one <stem>_track.mp4, through OpenCV), save_txt label
        files with the id, save_crop crops. A model of another task than
        detect raises (segment tracking is ROADMAP A12e-b)."""
        from ..trackers import make_tracker, track_results
        if self.task != "detect":
            raise NotImplementedError(
                f"tracking a {self.task} model is not ported (ROADMAP "
                "A12e-b)")
        kwargs.setdefault("conf", 0.1)
        if not (persist and getattr(self, "_tracker", None) is not None):
            self._tracker = make_tracker(kwargs.pop("tracker", None)
                                         or DEFAULT_CFG["tracker"])
        kwargs.pop("tracker", None)
        save = bool(kwargs.pop("save", False))
        save_txt = bool(kwargs.pop("save_txt", False))
        save_crop = bool(kwargs.pop("save_crop", False))
        save_conf = bool(kwargs.get("save_conf", False))
        inner = track_results(
            self.predict(source, stream=True, save=False, save_txt=False,
                         save_crop=False, **kwargs),
            self._tracker, persist_between_sources=persist)

        def gen():
            writers = {}
            try:
                for k, res in enumerate(inner):
                    if save or save_txt or save_crop:
                        sd = Path(self.predictor.save_dir)
                        p = Path(res.path)
                        stem = f"{p.stem or 'frame'}_{k:05d}"
                        meta = getattr(res, "source_meta", None)
                        if save and meta is not None:
                            # a video's frames: one annotated mp4 a source
                            cv2 = require("cv2", "saving a tracked video")
                            w = writers.get(res.path)
                            if w is None:
                                sd.mkdir(parents=True, exist_ok=True)
                                h, wd = res.orig_shape
                                w = writers[res.path] = cv2.VideoWriter(
                                    str(sd / f"{p.stem}_track.mp4"),
                                    cv2.VideoWriter_fourcc(*"mp4v"),
                                    max(float(meta[1]), 1.0), (wd, h))
                            w.write(res.plot()[..., ::-1])
                        elif save:
                            res.save(sd / f"{stem}.jpg")
                        if save_txt:
                            res.save_txt(sd / "labels" / f"{stem}.txt",
                                         save_conf=save_conf)
                        if save_crop:
                            res.save_crop(sd / "crops",
                                          file_name=p.stem or "frame")
                    yield res
            finally:
                for w in writers.values():
                    w.release()

        g = gen()
        return g if stream else list(g)

    def benchmark(self, **kwargs):
        """fp32 and bf16 rows of images/s at each batch size on the card
        (`engine/benchmarks.py`; JAX model.py:361-374), with `data` an mAP
        row. With formats= (True for the default set, or a list), every
        export format's row instead (`benchmarks.benchmark_formats`, JAX
        model.py:361-374)."""
        from .benchmarks import benchmark, benchmark_formats
        overrides = {**self.overrides, **kwargs}
        overrides.pop("model", None)
        formats = overrides.pop("formats", None)
        if formats:
            if isinstance(formats, (list, tuple)):
                overrides["formats"] = tuple(formats)
            return benchmark_formats(self, **overrides)
        overrides.pop("export_dir", None)       # formats= only
        self._live("benchmark")
        return benchmark(self, **overrides)

    def export(self, **kwargs):
        """Write the model in `format` (default pt2; `engine/exporter.py`)
        at `imgsz` and `batch` on `device` (None means cuda); returns the
        artifact's path. The carried `data` is dropped unless passed (JAX
        model.py:349-359)."""
        from .exporter import Exporter
        self._live("export")
        args = self._args(kwargs)
        args.data = kwargs.get("data")
        self.device = resolve_device(args.device)
        return Exporter(args)(self.model)

    def add_callback(self, event, fn):
        """Run fn(trainer) at `event` (utils.callbacks.HOOKS) of the next
        `train` calls."""
        self._user_callbacks.setdefault(event, []).append(fn)

    def train(self, **kwargs):
        """Train on `data` (a dataset yaml path or dict; for classify a
        folder tree's root); returns the final validation's results (JAX
        model.py:130-160): DetectionTrainer, SegmentationTrainer for a
        segment model, ClassificationTrainer for a classify model.

        kwargs are config keys; device None means cuda. The run trains a
        fresh module of this architecture with data's nc, warm-started by
        name and shape (never on `resume`): from the weights this facade
        holds when it was loaded from an .npz (they win over `pretrained`,
        as in JAX), else from a `pretrained` .npz when one is named, else
        from the facade's seeded weights. Afterwards the facade holds
        best.npz (its EMA weights) when the run wrote one."""
        self._live("train")
        args = self._args(kwargs)
        trainer_cls = TASK_CLASSES[self.model.task][0]
        data = trainer_cls.check_data(args.data) if args.data else None
        if data is None:
            raise ValueError("training needs `data` (a dataset yaml or dict)")
        net = trainer_cls.get_model(self.model_yaml, data["nc"], args.seed)
        for m in net.modules():
            if isinstance(m, LowlightRecovery):
                m.contrast_mode = args.contrast_mode
        trainer = trainer_cls(net, {**self.overrides, **kwargs})
        named = isinstance(args.pretrained, (str, Path)) and args.pretrained
        if not args.resume and (self.ckpt_path is not None or not named):
            trainer.init_state = self.model.state_dict()
        for event, fns in self._user_callbacks.items():
            trainer.callbacks[event].extend(fns)
        self.trainer = trainer
        metrics = trainer.train()
        best = trainer.wdir / "best.npz"
        if best.is_file():
            self.device = trainer.device
            self._load(str(best))
        self.metrics = metrics
        return metrics

    def val(self, **kwargs):
        """mAP of the model on `data` (a dataset yaml path or dict) at
        `split`, or a classify model's top-1 and top-5; returns the results
        dict, a segment model's box and mask mAP (JAX model.py:176-221).
        kwargs are config keys; conf None
        means 0.001, device None cuda. The model moves to the val
        device."""
        args = self._args(kwargs)
        model = self._make_backend(args) if self._backend_spec else self.model
        self.validator = TASK_CLASSES[model.task][1](args=args)
        self.device = self.validator.device
        self.metrics = self.validator(model=model)
        return self.metrics

    def __call__(self, source, **kwargs):
        """predict with conf 0.4 unless given (JAX model.py:272-274)."""
        kwargs.setdefault("conf", 0.4)
        return self.predict(source, **kwargs)

    @property
    def names(self):
        if self._backend_spec:
            return self._make_backend(get_cfg({"device": str(self.device)})).names
        return self.model.names

    @property
    def transforms(self):
        """None: the predictor letterboxes, no checkpoint carries a
        transform (JAX model.py:394-397)."""
        return None

    def to(self, device):
        """Move the model to `device`; predict, val and train then default
        to it."""
        self.device = resolve_device(device)
        self.model.to(self.device)
        self.overrides["device"] = str(self.device)
        return self

    def load(self, weights):
        """Weights of a checkpoint moved into this architecture by name and
        shape (JAX model.py:274-288, the reference's intersect_dicts): head
        entries of another nc keep their current values."""
        other = YOLO(str(weights), device="cpu")
        merged, n, total = transfer_tree(other.state_dict(),
                                         self.model.state_dict())
        self.model.load_state_dict(merged)
        LOGGER.info(f"transferred {n}/{total} items from {weights}")
        return self

    def reset_weights(self):
        """A fresh seeded init of the same graph, unlike the construction's
        and unlike every earlier reset's (JAX model.py:290-306 folds a
        per-call counter into its key)."""
        self._reset_count = getattr(self, "_reset_count", 0) + 1
        init_weights(self.model, 0x5EED + self._reset_count)
        return self

    def fuse(self):
        """A logged no-op: eval BN stays a separate op and no ported graph
        has RepConv blocks (`RepC3` is ROADMAP A12), as JAX model.py:217-235
        does for graphs without them."""
        if any(s.name == "RepC3" for s in self.model.specs):
            raise NotImplementedError("RepConv fusion is not ported (A12)")
        LOGGER.info("fuse(): no RepConv blocks; nothing to fuse")
        return self

    def clear_callback(self, event):
        self._user_callbacks[event] = []

    def tune(self, data=None, **kwargs):
        """Evolve search over `train` on this architecture (JAX
        model.py:336-349, `utils.tuner.run_tune`); returns (best_cfg,
        results sorted by fitness)."""
        from ..utils.tuner import run_tune
        overrides = {**self.overrides, **kwargs}
        model = overrides.pop("model", None) or self.ckpt_path \
            or self.model_yaml["yaml_file"]
        data = data or overrides.pop("data", None)
        overrides.pop("data", None)
        if not data:
            raise ValueError("tune() needs data=<dataset file or dict>")
        return run_tune(model, data, **overrides)

    def info(self):
        """(layers, parameters), the JAX facade's `num_params` count (BN
        running stats are not parameters)."""
        n = sum(p.numel() for p in self.model.parameters())
        LOGGER.info(f"model: {len(self.model.specs)} layers, {n:,} parameters")
        return len(self.model.specs), n
