"""The classify task: dataset, trainer, validator and predictor (JAX
engine/classify.py; reference models/yolo/classify/).

The dataset is an imagenet-style folder tree, root/{train,val[,test]}/
<class name>/<images>, scanned as JAX scans it (`check_cls_dataset`,
`ClassificationDataset`). An item is the image resized to imgsz x imgsz by
`data/imgops.resize_linear` (cv2.INTER_LINEAR without OpenCV), flipped
left-right in training when the item's rng draws < 0.5 (JAX :65-74), as
RGB uint8, and its class id. The port reads an image the detect dataset's
way (`data/dataset.py`): with cache='disk' a `.npy` sidecar of the BGR
array beside it, written on first read where none exists, stands in for
the file, so a machine without an image decoder trains and validates; JAX
always decodes. Both read the same pixels.

`ClassificationTrainer` is the `BaseTrainer` loop with JAX's loss
(:112-131): the u8 image / 255 in f32 through the model in train mode,
cross-entropy against the one-hot class (with `label_smoothing`), summed
and divided by `nbs`. There is no degrade and no layer 0, and `amp` is
ignored, as in JAX. `ClassificationValidator` reports top-1, top-5 and
fitness = (top1 + top5) / 2 over fixed batches, the last one padded with
its first image (JAX :152-199). `ClassificationPredictor` gives a Results
with `Probs` an image, the frames resized as the dataset resizes them.
Both take the live model (`DetectionModel.eval_outputs`, softmax of the
logits) or an `AutoBackend` (`forward(img)[0]`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..cfg import get_cfg
from ..data import imgops
from ..data.dataset import IMG_FORMATS, save_sidecar
from ..data.loader import DataLoader
from ..utils import LOGGER, increment_dir
from ..utils.patches import imread
from .predictor import PinnedUpload, load_source, resolve_device
from .trainer import BaseTrainer
from .validator import DeviceGroups


def check_cls_dataset(root):
    """The dataset dict of a folder tree (reference data/utils.py
    check_cls_dataset): path, the splits present, names from the train
    split's (else val's) class folders in sorted order, nc. A dict is
    returned as it is."""
    if isinstance(root, dict):
        return root
    root = Path(root)
    out = {"path": str(root)}
    for split in ("train", "val", "test"):
        if (root / split).is_dir():
            out[split] = str(root / split)
    if "train" not in out and "val" not in out:
        raise FileNotFoundError(f"no train or val split under {root}")
    train = Path(out.get("train") or out["val"])
    names = sorted(p.name for p in train.iterdir() if p.is_dir())
    out["names"] = {i: n for i, n in enumerate(names)}
    out["nc"] = len(names)
    return out


class ClassificationDataset:
    """(image, class id) items of one split; `cache='disk'` reads and writes
    `.npy` sidecars of the decoded BGR images."""

    def __init__(self, split_dir, imgsz=224, names=None, cache=False):
        self.imgsz = imgsz
        self._disk = cache == "disk"
        split_dir = Path(split_dir)
        classes = names or {i: p.name for i, p in enumerate(
            sorted(q for q in split_dir.iterdir() if q.is_dir()))}
        name_to_id = {v: int(k) for k, v in classes.items()}
        self.samples = []
        for cls_dir in sorted(split_dir.iterdir()):
            if not cls_dir.is_dir() or cls_dir.name not in name_to_id:
                continue
            cid = name_to_id[cls_dir.name]
            for f in sorted(cls_dir.rglob("*")):
                if f.suffix.lower() in IMG_FORMATS:
                    self.samples.append((str(f), cid))
        if not self.samples:
            raise FileNotFoundError(f"no classification images in {split_dir}")

    def __len__(self):
        return len(self.samples)

    def _read(self, path):
        sidecar = Path(path).with_suffix(".npy")
        if self._disk and sidecar.is_file():
            return np.load(sidecar)
        img = imread(path)
        if img is None:
            raise FileNotFoundError(f"image not found: {path}")
        if self._disk:
            save_sidecar(sidecar, img)
        return img

    def load(self, i, train=False, rng=None):
        """Item i: (imgsz x imgsz RGB uint8, class id)."""
        path, cid = self.samples[i]
        img = imgops.resize_linear(self._read(path), (self.imgsz, self.imgsz))
        if train and rng and rng.random() < 0.5:
            img = np.fliplr(img)
        return np.ascontiguousarray(img[..., ::-1]), cid


def train_item(dataset, i, rng):
    """The loader's transform of a train item (picklable for the process
    workers)."""
    return dataset.load(i, train=True, rng=rng)


def collate_classify(items):
    """[(img HWC uint8, class id)] -> {'img' (B, S, S, 3), 'cls' (B,)}."""
    return {"img": np.stack([p[0] for p in items]),
            "cls": np.asarray([p[1] for p in items], np.int32)}


class ClassificationTrainer(BaseTrainer):
    task = "classify"
    loss_names = ("loss",)
    metric_keys = ("metrics/accuracy_top1", "metrics/accuracy_top5")
    batch_keys = ("img", "cls")
    default_model = "yolov8-cls.yaml"

    def check_data(self, path):
        return check_cls_dataset(path)

    def preflight(self):
        # a plain square resize: no stride rounding
        if not isinstance(self.args.imgsz, int):
            self.args.imgsz = 224

    def build_train_dataset(self):
        if getattr(self, "train_ds", None) is None:
            a = self.args
            self.train_ds = ClassificationDataset(
                self.data["train"], a.imgsz, self.data["names"], a.cache)
        return self.train_ds

    def build_train_loader(self):
        a = self.args
        return DataLoader(self.build_train_dataset(), train_item, a.batch,
                          workers=a.workers, shuffle=True, seed=a.seed,
                          drop_last=True, use_processes=bool(a.loader_mp),
                          collate_fn=collate_classify, **self.shard_kw())

    def loss(self, batch):
        """(total, (loss,)): the summed cross-entropy of the logits over
        nbs (reference v8ClassificationLoss), with label smoothing."""
        a = self.args
        logits = self.model_forward(batch["img"].to(torch.float32) / 255.0)
        nc = self.model.nc
        onehot = F.one_hot(batch["cls"].long(), nc).to(logits.dtype)
        smoothing = float(a.label_smoothing or 0.0)
        if smoothing:
            onehot = onehot * (1 - smoothing) + smoothing / nc
        ce = -(torch.log_softmax(logits, -1) * onehot).sum(-1)
        total = ce.sum() / float(a.nbs)
        return total, (total.detach(),)

    def get_validator(self, save_dir=None, data=None):
        args = get_cfg(overrides={**vars(self.args), "device": str(self.device)})
        return ClassificationValidator(args=args, save_dir=save_dir, data=data)

    def dummy_batch(self, b):
        a = self.args
        return {"img": np.zeros((b, a.imgsz, a.imgsz, 3), np.uint8),
                "cls": np.zeros((b,), np.int32)}


def _probs_fn(model, device):
    """uint8 (B, S, S, 3) RGB -> probs (B, nc) on the device: an
    AutoBackend's first output, or the live model's eval_outputs of the
    image / 255 in f32."""
    from ..nn.graph import DetectionModel
    from .autobackend import AutoBackend
    if isinstance(model, AutoBackend):
        return lambda u8: model.forward(u8)[0]
    if not isinstance(model, DetectionModel) or model.task != "classify":
        raise ValueError("the classify validator and predictor take a "
                         "classify model or its AutoBackend")
    model.to(device).eval()

    def fwd(u8):
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
            return model.eval_outputs(x.to(torch.float32) / 255.0)[0]
    return fwd


class ClassificationValidator:
    """Top-1 and top-5 accuracy over the val split (reference
    ClassifyMetrics)."""

    def __init__(self, args=None, save_dir=None, data=None):
        self.args = args if args is not None else get_cfg()
        self.device = resolve_device(self.args.device)
        self.save_dir = (Path(save_dir) if save_dir else increment_dir(
            Path("runs/classify/val"), self.args.exist_ok))
        self.data = data

    def __call__(self, model=None, mesh=None):
        """Top-1 and top-5 accuracy of `model`. Over a mesh of this
        process's devices a batch that divides splits in groups, one a
        device (`validator.DeviceGroups`); a group mesh is taken and the
        val runs whole on this validator's own device, as JAX's classify
        validator runs (JAX classify.py:154)."""
        from .autobackend import AutoBackend
        a = self.args
        data = self.data or check_cls_dataset(a.data)
        imgsz = a.imgsz if isinstance(a.imgsz, int) else 224
        split = a.split if a.split in data else ("val" if "val" in data
                                                 else "train")
        ds = ClassificationDataset(data[split], imgsz, data["names"], a.cache)
        batch = max(int(a.batch), 1)
        if isinstance(model, AutoBackend):
            batch = model.batch
        local = (mesh is not None and mesh.world == 1
                 and len(mesh.devices) > 1
                 and not isinstance(model, AutoBackend))
        fwd = (_mesh_probs_fn(model, mesh) if local
               else _probs_fn(model, self.device))
        k5 = min(5, getattr(model, "nc", None) or len(data["names"]))
        correct1 = correct5 = total = 0
        for bi in range(-(-len(ds) // batch)):
            idxs = range(bi * batch, min((bi + 1) * batch, len(ds)))
            pairs = [ds.load(i) for i in idxs]
            while len(pairs) < batch:    # the fixed batch shape
                pairs.append(pairs[0])
            probs = fwd(np.stack([p[0] for p in pairs]))
            probs = probs.float().cpu().numpy()[:len(idxs)]
            y = np.asarray([p[1] for p in pairs])[:len(idxs)]
            topk = np.argsort(-probs, axis=-1, kind="stable")[:, :k5]
            correct1 += int((topk[:, 0] == y).sum())
            correct5 += int(sum(y[i] in topk[i] for i in range(len(y))))
            total += len(y)
        top1 = correct1 / max(total, 1)
        top5 = correct5 / max(total, 1)
        LOGGER.info(f"classify val: {total} images top1 {top1:.3f} "
                    f"top5 {top5:.3f}")
        return {"metrics/accuracy_top1": top1, "metrics/accuracy_top5": top5,
                "fitness": (top1 + top5) / 2}


def _mesh_probs_fn(model, mesh):
    """`_probs_fn` over a mesh of this process's devices: a batch that the
    mesh's size divides runs in groups, one a device
    (`validator.DeviceGroups`), the probs joined on its first device."""
    _probs_fn(model, mesh.device)          # the checks, on the first device
    groups = DeviceGroups(model, mesh, mesh.device, PinnedUpload(mesh.device))

    def probs(m, dev):
        return {"p": m.eval_outputs(dev["img"].float() / 255.0)[0]}

    @torch.inference_mode()
    def fwd(u8):
        return groups({"img": u8}, 0, len(u8), ("img",), probs)["p"]
    return fwd


class ClassificationPredictor:
    """Batched classify inference -> a Results with Probs an image
    (reference models/yolo/classify/predict.py). A partial last batch is
    padded with its first frame to the fixed batch."""

    def __init__(self, args=None, model=None, names=None, save_dir=None,
                 members=None):
        """`members` (JAX's parameter) must be empty: a classify predict
        runs the model alone, as JAX's does."""
        if members:
            raise ValueError("ClassificationPredictor takes no ensemble members")
        self.args = args if args is not None else get_cfg()
        self.device = resolve_device(self.args.device)
        self.model = model
        self.names = names or (model.names if model is not None else {})
        self.save_dir = (Path(save_dir) if save_dir else increment_dir(
            Path("runs/classify/predict"), self.args.exist_ok))
        self._fwd = None

    def __call__(self, source, stream=False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source):
        from .autobackend import AutoBackend
        from .results import Results
        a = self.args
        imgsz = a.imgsz if isinstance(a.imgsz, int) else 224
        if self._fwd is None:
            self._fwd = _probs_fn(self.model, self.device)
        batch = (self.model.batch if isinstance(self.model, AutoBackend)
                 else max(int(a.batch), 1))
        buf = []

        def flush():
            imgs = [imgops.resize_linear(img, (imgsz, imgsz))[..., ::-1]
                    for _, img, _ in buf]
            while len(imgs) < batch:
                imgs.append(imgs[0])
            probs = self._fwd(np.stack(imgs)).float().cpu().numpy()
            out = [Results(orig_img=np.ascontiguousarray(img[..., ::-1]),
                           path=path, names=self.names, probs=probs[i])
                   for i, (path, img, _) in enumerate(buf)]
            buf.clear()
            return out

        for path, img, meta in load_source(source, a.vid_stride):
            buf.append((path, img, meta))
            if len(buf) == batch:
                yield from flush()
        if buf:
            yield from flush()
