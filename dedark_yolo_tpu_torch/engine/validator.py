"""DetectionValidator: f32 validation with device-side NMS and host-side mAP
(JAX engine/validator.py).

Counterpart of the reference BaseValidator/DetectionValidator
(ultralytics/engine/validator.py:93-207, models/yolo/detect/val.py):
  - the image is always f32, whatever `half` says (validator.py:102-111);
  - NMS with multi_label=True and conf from args (None means 0.001);
  - per image, the TP matrix at 10 IoU thresholds in NATIVE image space:
    predictions letterbox-inverted with `scale_boxes`, ground truth from
    the original normalised labels times the original shape
    (detect/val.py:72-116, 221-258);
  - DetMetrics, the ConfusionMatrix (with `plots`), per-image speed:
    `inference` the dispatch and the readback wait, `postprocess` the host
    matching, and `preprocess` the time the loop waited for the loader
    (the JAX validator leaves it at 0);
  - with `plots`, the PR/F1/P/R curves and `confusion_matrix.png` under
    `save_dir` (JAX validator.py:386-391). Where matplotlib is missing the
    first call says so in one log line and draws nothing; a confusion
    matrix plot that fails is logged and does not fail the val.

A batch's device work is the predictor's (`predictor.detect_step`: forward,
decode, NMS; on CUDA the enhance kernel in layer 0 and the `nms` kernel),
uploaded from pinned buffers, and is dispatched depth-2
(`utils.pipeline.pipelined`): batch i+1 is loaded and submitted before
batch i is read back and matched on the host. With `save_hybrid` the
labels, scaled into the letterbox frame with score 1, join the candidates
before NMS (autolabelling, detect/val.py:38-39; scaled, not normalised as
upstream, so they merge). `with_loss` adds the v8 loss of the eval outputs.
An RT-DETR model's queries are NMS-free (`predictor.query_dets`: each
query's best class, the max_det best queries, no suppression, no `nms`
launch; save_hybrid's labels are not joined, as in JAX) and its loss items
the last layer's matching loss of the eval queries.

The dataset is read with `cache=args.cache` (the JAX validator reads
without a cache): with 'disk', `.npy` sidecars stand in for the images, so
a machine without an image decoder can validate.

An exported artifact (model=AutoBackend, JAX validator.py:71-80) runs its
own enhance chain, forward and decode at its fixed batch (the last batch
padded to it, `predictor.backend_step`); NMS, with save_hybrid's
candidates, runs here as for the live model.

Under a mesh of several ranks (`parallel.Mesh`, JAX validator.py:233-241,
:337-341) every rank of the group calls the validator and reads the same
batches; each runs its rows of a batch on its own device (an even split
when the rank count divides the batch, else the whole batch on rank 0, as
JAX shards a batch only when it divides), rank 0 gathers every image's
stats in image order, computes the metrics and sends the results to every
rank, so they equal one process's. The loss (`with_loss`) and an exported
artifact are not run under a mesh (they raise).

Over a mesh of this process's devices (`make_mesh(devices=[...])`, rank
0's per-epoch val in data x spatial training, JAX validator.py:337-343) a
batch whose size the mesh's divides splits into equal groups, one a device
in the mesh's order, each run by the model's copy on its device
(`DeviceGroups`); another batch runs whole on the first device. The
outputs join on the first device, so the metrics are the plain val's.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..cfg import get_cfg
from ..data.augment import ValTransforms
from ..data.dataset import YOLODataset, check_det_dataset
from ..data.loader import DataLoader
from ..losses.detection import detection_loss
from ..losses.rtdetr import _layer_loss
from ..nn.graph import DetectionModel, require_detect
from ..ops.boxes import scale_boxes, xywh2xyxy, xyxy2xywh
from ..parallel.mesh import Mesh, broadcast_object, gather_in_order, rank_rows
from ..parallel.spatial import replicas
from ..utils import LOGGER, increment_dir
from ..utils.checks import check_imgsz
from ..utils.metrics import ConfusionMatrix, DetMetrics, match_predictions
from ..utils.pipeline import pipelined
from ..utils.plotting import matplotlib_available, plot_confusion_matrix
from .autobackend import AutoBackend
from .predictor import PinnedUpload, backend_step, detect_step, resolve_device

LABEL_KEYS = ("cls", "bboxes", "mask_gt")


def resolve_val_max_boxes(args, ds):
    """max_boxes=0 -> the densest val image's label count, rounded up to a
    multiple of 8, in [8, 1024]. Val applies no compositing augmentation,
    so no image holds more."""
    if int(args.max_boxes) > 0:
        return
    dens = max((len(lb) for lb in ds.labels), default=1)
    args.max_boxes = int(min(max(-(-max(dens, 1) // 8) * 8, 8), 1024))
    LOGGER.info(f"auto max_boxes (val): {args.max_boxes}")


def rect_shape(h, w, imgsz):
    """The rect-val bucket (h, w) of an image of shape (h, w): the long side
    imgsz, the short side rounded up to a multiple of 32."""
    ar = h / max(w, 1)
    if ar >= 1:
        return imgsz, max(math.ceil(imgsz / ar / 32) * 32, 32)
    return max(math.ceil(imgsz * ar / 32) * 32, 32), imgsz


def hybrid_candidates(dev, nc):
    """save_hybrid: the labels of a device batch as NMS candidates in the
    letterbox frame: xywh pixels (B, M, 4) and one-hot scores (B, M, nc),
    zero on padding rows."""
    h, w = dev["img"].shape[1:3]
    bx, by, bw, bh = dev["bboxes"].unbind(-1)
    boxes = torch.stack([bx * w, by * h, bw * w, bh * h], -1)
    classes = torch.arange(nc, device=boxes.device)
    one_hot = (dev["cls"].long()[..., None] == classes).float()
    return boxes, one_hot * dev["mask_gt"][..., None]


def query_loss_items(raw, dev, nc):
    """RT-DETR's val loss items (JAX validator.py:157-172): the last
    layer's matching loss of the eval queries (normalized boxes, the
    scores' logits recovered from the sigmoid), not a train-mode forward,
    whose BN would use the batch's statistics."""
    p = raw[..., 4:].clamp(1e-7, 1.0 - 1e-7)
    return torch.stack(_layer_loss(
        raw[..., :4], torch.log(p) - torch.log1p(-p), dev["bboxes"],
        dev["cls"], dev["mask_gt"].to(raw.dtype), nc))


def check_val_mesh(mesh, refused=False):
    """Whether `mesh` spans several ranks (a validator's group path); a mesh
    over this process's devices is taken too (`DeviceGroups`); a mesh of
    another kind, or one with the `refused` options, raises."""
    if mesh is None:
        return False
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"a mesh of type {type(mesh).__name__} is not ported: validate "
            "over a dedark_yolo_tpu_torch.parallel.Mesh")
    if mesh.size > 1 and refused:
        raise NotImplementedError("the loss and exported artifacts are not "
                                  "validated over a mesh of several ranks "
                                  "or devices")
    return mesh.world > 1


class DeviceGroups:
    """The devices a validator runs a batch's rows on: over a mesh of this
    process's devices each device with the model's copy on it
    (`parallel/spatial.py::replicas`) and its own upload; else `device`
    with the model and `upload` as they are."""

    def __init__(self, model, mesh, device, upload):
        local = mesh is not None and mesh.world == 1 and len(mesh.devices) > 1
        self.devices = list(mesh.devices) if local else [device]
        self.models = (replicas(model, self.devices) if local
                       else {device: model})
        self.uploads = ({d: PinnedUpload(d) for d in dict.fromkeys(
            self.devices)} if local else {device: upload})

    def __call__(self, batch, lo, hi, keys, fn):
        """fn(model, {key: its rows on the device}) -> a dict of tensors,
        for rows [lo, hi) of `batch`: in equal groups, one a device, when
        the devices divide the rows, else whole on the first; the dicts
        joined along dim 0 on the first device."""
        n, k = hi - lo, len(self.devices)
        cuts = ([(self.devices[0], lo, hi)] if k == 1 or n % k else
                [(d, lo + i * (n // k), lo + (i + 1) * (n // k))
                 for i, d in enumerate(self.devices)])
        outs = [fn(self.models[d], self.uploads[d](
            {key: batch[key][a:b] for key in keys})) for d, a, b in cuts]
        if len(outs) == 1:
            return outs[0]
        dev0 = self.devices[0]
        return {key: torch.cat([o[key].to(dev0) for o in outs])
                for key in outs[0]}


def speed_of(t_pre, t_inf, t_post, n_images):
    """The speed dict: ms an image of loading, inference and matching."""
    n = max(n_images, 1)
    return {"preprocess": t_pre / n * 1000, "inference": t_inf / n * 1000,
            "loss": 0.0, "postprocess": t_post / n * 1000}


class DetectionValidator:
    def __init__(self, args=None, save_dir=None, data=None):
        self.args = args if args is not None else get_cfg()
        if self.args.conf is None:
            self.args.conf = 0.001  # val default (reference cfg: 0.001 for val)
        self.save_dir = (Path(save_dir) if save_dir else
                         increment_dir(Path("runs/detect/val"),
                                       self.args.exist_ok))
        self.data = data
        self.device = resolve_device(self.args.device)
        self.upload = PinnedUpload(self.device)
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0,
                      "postprocess": 0.0}
        self.note_no_matplotlib = True   # until the first call with plots

    def loaders(self, ds):
        """One loader over the dataset in order, or with `rect` one per
        aspect bucket, in sorted bucket order."""
        a = self.args
        kw = dict(max_boxes=a.max_boxes, shuffle=False, workers=a.workers,
                  drop_last=False)
        if not a.rect:
            return [DataLoader(ds, ValTransforms(imgsz=a.imgsz), a.batch, **kw)]
        buckets = {}
        for i, (h, w) in enumerate(ds.image_shapes()):
            buckets.setdefault(rect_shape(h, w, a.imgsz), []).append(i)
        return [DataLoader(ds, ValTransforms(imgsz=shape), a.batch,
                           indices=idxs, **kw)
                for shape, idxs in sorted(buckets.items())]

    def __call__(self, model=None, mesh=None, with_loss=False):
        """Validate `model` (the port's DetectionModel, which moves to the
        validator's device, or an AutoBackend on it) on `data[split]`;
        returns the results dict."""
        a = self.args
        backend = isinstance(model, AutoBackend)
        if not (backend or isinstance(model, DetectionModel)):
            raise TypeError("validate a DetectionModel or an AutoBackend, "
                            f"not {type(model).__name__}")
        require_detect(model, "DetectionValidator")
        if backend and (with_loss or a.rect):
            raise ValueError("an exported artifact gives no raw maps for "
                             "the loss and has one square shape (rect)")
        multi = check_val_mesh(mesh, backend or with_loss)
        device = (mesh.device if mesh is not None and mesh.size > 1
                  else self.device)
        upload = self.upload if device == self.device else PinnedUpload(device)
        a.imgsz = check_imgsz(a.imgsz, stride=32)
        data = self.data or check_det_dataset(a.data)
        names = data["names"]
        nc = data["nc"]
        ds = YOLODataset(data[a.split], imgsz=a.imgsz, nc=nc,
                         single_cls=a.single_cls, cache=a.cache)
        resolve_val_max_boxes(a, ds)
        loaders = self.loaders(ds)
        if not backend:
            model.to(device).eval()
        groups = DeviceGroups(model, mesh, device, upload)
        hyp = {"box": a.box, "cls": a.cls, "dfl": a.dfl, "lrl": a.lrl}
        keys = ("img",) + (LABEL_KEYS if a.save_hybrid or with_loss else ())

        if a.plots and self.note_no_matplotlib:
            self.note_no_matplotlib = False
            if not matplotlib_available():
                LOGGER.info("plots: matplotlib is not installed; val draws "
                            "no curve and no confusion matrix")
        metrics = DetMetrics(save_dir=self.save_dir, plot=a.plots, names=names)
        cm = ConfusionMatrix(nc=nc)
        stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        loss_accum = np.zeros(3)
        n_batches = n_images = 0
        t_pre = t_inf = t_post = 0.0
        jdict = []           # COCO-style detections (detect/val.py:221-258)
        txt_written = set()  # stems written this pass: the first write truncates
        orig_shapes = ds.image_shapes()
        records = []         # under a mesh: (image position, its record)

        def take(rec):
            for k in stats:
                stats[k].append(rec[k])
            if a.plots:
                cm.process_batch(*rec["cm"])
            jdict.extend(rec["json"])

        def gen_batches():
            nonlocal t_pre
            pos = 0                  # the batch's first image in val order
            for dl in loaders:
                order = dl._indices()  # the batches chunk this order
                cursor = 0
                batches = iter(dl)
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    t_pre += time.perf_counter() - t0
                    if batch is None:
                        break
                    bsz = batch["img"].shape[0]
                    yield batch, order[cursor:cursor + bsz], pos
                    cursor += bsz
                    pos += bsz

        def run(model, dev):
            extra = hybrid_candidates(dev, model.nc) if a.save_hybrid else None
            if backend:
                dets, counts = backend_step(model, dev["img"], a,
                                            multi_label=True, extra=extra)
            else:
                raw, dets, counts = detect_step(
                    model, dev["img"].float() / 255.0,       # f32 forced
                    a, multi_label=True, extra=extra)
            out = {"dets": dets, "counts": counts}
            if with_loss and model.is_rtdetr:
                out["loss_items"] = query_loss_items(raw, dev, model.nc)
            elif with_loss:
                _, items = detection_loss(
                    raw, {k: dev[k] for k in LABEL_KEYS}, nc=model.nc,
                    strides=model.strides, hyp=hyp)
                out["loss_items"] = torch.stack(list(items))
            return out

        @torch.inference_mode()
        def dispatch(item):
            nonlocal t_inf
            batch, ds_idxs, pos = item
            lo, hi = rank_rows(batch["img"].shape[0], mesh if multi else None)
            if hi == lo:                 # none of this batch's rows
                return None, batch, ds_idxs, pos, lo, hi
            t0 = time.perf_counter()
            out = groups(batch, lo, hi, keys, run)
            t_inf += time.perf_counter() - t0
            return out, batch, ds_idxs, pos, lo, hi


        def process(out, batch, ds_idxs, pos, lo, hi):
            nonlocal loss_accum, n_batches, n_images, t_inf, t_post
            if out is None:
                return
            t0 = time.perf_counter()
            dets = out["dets"].cpu().numpy()   # waits for the batch
            counts = out["counts"].cpu().numpy()
            t_inf += time.perf_counter() - t0
            if with_loss:
                loss_accum += out["loss_items"].cpu().numpy()
            n_batches += 1

            t1 = time.perf_counter()
            bh, bw = batch["img"].shape[1], batch["img"].shape[2]
            for i in range(lo, hi):
                n_images += 1
                idx = ds_idxs[i]
                h0, w0 = int(orig_shapes[idx][0]), int(orig_shapes[idx][1])
                k = int(counts[i - lo])
                det = dets[i - lo, :k].copy()  # (k, 6) xyxy conf cls (letterbox)
                if k:
                    det[:, :4] = scale_boxes(
                        (bh, bw), torch.from_numpy(det[:, :4]), (h0, w0)).numpy()
                lb = ds.labels[idx]
                gt_cls = lb[:, 0].copy().astype(np.float32)
                if a.single_cls:
                    gt_cls[:] = 0
                if len(lb):
                    gt_xywh = lb[:, 1:5] * np.asarray([w0, h0, w0, h0],
                                                      np.float32)
                    gt_xyxy = xywh2xyxy(torch.from_numpy(gt_xywh)).numpy()
                else:
                    gt_xyxy = np.zeros((0, 4), np.float32)
                tp = match_predictions(det[:, :4], det[:, 5], gt_xyxy, gt_cls)
                rec = {"tp": tp, "conf": det[:, 4], "pred_cls": det[:, 5],
                       "target_cls": gt_cls, "cm": (det, gt_xyxy, gt_cls),
                       "json": []}
                stem = Path(ds.im_files[idx]).stem
                if a.save_txt and len(det):
                    # normalised-xywh label lines (detect/val.py:212-219
                    # save_one_txt, which writes no file for an image with
                    # no detections)
                    txt_dir = self.save_dir / "labels"
                    txt_dir.mkdir(parents=True, exist_ok=True)
                    gn = np.asarray([w0, h0, w0, h0], np.float32)
                    mode = "a" if stem in txt_written else "w"
                    txt_written.add(stem)
                    xywh = xyxy2xywh(torch.from_numpy(det[:, :4])).numpy() / gn
                    with open(txt_dir / f"{stem}.txt", mode) as f:
                        for d, (cx, cy, bw_, bh_) in zip(det, xywh):
                            vals = [int(d[5]), cx, cy, bw_, bh_]
                            if a.save_conf:
                                vals.append(d[4])
                            f.write(" ".join(f"{v:g}" for v in vals) + "\n")
                if a.save_json:
                    # native-space xywh, filename-derived id (detect/val.py:
                    # 221-236 pred_to_json)
                    image_id = int(stem) if stem.isnumeric() else stem
                    for d in det:
                        rec["json"].append({
                            "image_id": image_id,
                            "category_id": int(d[5]),
                            "bbox": [round(float(d[0]), 3),
                                     round(float(d[1]), 3),
                                     round(float(d[2] - d[0]), 3),
                                     round(float(d[3] - d[1]), 3)],
                            "score": round(float(d[4]), 5)})
                if multi:
                    records.append((pos + i, rec))
                else:
                    take(rec)
            t_post += time.perf_counter() - t1

        pipelined(gen_batches(), dispatch, lambda rec: process(*rec))

        if multi:      # rank 0 takes every image's record in image order
            merged = gather_in_order(mesh, records)
            if merged is None:
                self.speed = speed_of(t_pre, t_inf, t_post, n_images)
                return broadcast_object(mesh, None)
            for rec in merged:
                take(rec)
            n_images = len(merged)
        if n_images == 0:
            return broadcast_object(mesh, {}) if multi else {}
        tp = np.concatenate(stats["tp"]) if stats["tp"] else np.zeros((0, 10), bool)
        conf = np.concatenate(stats["conf"])
        pred_cls = np.concatenate(stats["pred_cls"])
        target_cls = np.concatenate(stats["target_cls"])
        if tp.shape[0] and target_cls.shape[0]:
            metrics.process(tp, conf, pred_cls, target_cls)
        self.speed = speed_of(t_pre, t_inf, t_post, n_images)
        metrics.speed = self.speed

        results = metrics.results_dict
        if with_loss and n_batches:
            items = loss_accum / n_batches
            results.update({"val/box_loss": items[0], "val/cls_loss": items[1],
                            "val/dfl_loss": items[2]})
        if a.save_json and jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            jpath = self.save_dir / "predictions.json"
            jpath.write_text(json.dumps(jdict))
            LOGGER.info(f"saved {len(jdict)} detections to {jpath}")

        mr = metrics.mean_results()
        LOGGER.info(f"val: {n_images} images  P {mr[0]:.3f}  R {mr[1]:.3f}  "
                    f"mAP50 {mr[2]:.3f}  mAP50-95 {mr[3]:.3f}  "
                    f"({self.speed['inference']:.1f}ms/img inference)")
        if a.verbose and len(metrics.ap_class_index):
            for i, c in enumerate(metrics.ap_class_index):
                p, r, ap50, ap = metrics.class_result(i)
                LOGGER.info(f"  {names.get(int(c), c):>16}  P {p:.3f}  R {r:.3f}  "
                            f"mAP50 {ap50:.3f}  mAP50-95 {ap:.3f}")
        if a.plots:
            try:
                plot_confusion_matrix(cm.matrix, names,
                                      self.save_dir / "confusion_matrix.png")
            except Exception as e:  # a plot never fails the val
                LOGGER.info(f"plot_confusion_matrix failed: {e!r}")
        self.confusion_matrix = cm
        self.metrics = metrics
        return broadcast_object(mesh, results) if multi else results
