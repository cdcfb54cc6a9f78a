"""The segment task: trainer, validator and predictor (JAX engine/segment.py;
reference models/yolo/segment/).

`SegmentationTrainer` is the `BaseTrainer` loop with JAX's segment hooks
(:33-100): the polygon dataset and its mosaic / CopyPaste / affine loader
(`data/segment.py`), the u8 image / 255 in f32 through the graph in train
mode (no degrade and no priors; `amp` is ignored, as JAX's segment loss
ignores it), `losses/segment.py` with max_fg = min(4 max_boxes, 128) and
`overlap_mask`, and box plus mask validation.

`SegmentationValidator` (:103-329) reports box mAP in native image space,
as the detect validator does, and mask mAP in proto space: each kept
detection's mask is sigmoid(coefficients @ protos) > 0.5 cropped to its
box, the coefficients found through the NMS anchor index (`return_idx`),
and matched to the ground-truth instances of the overlap raster (those of
the first max_boxes labels, the ones the raster holds) by mask IoU at the
ten thresholds. The masks, their areas and their intersections with the
ground truth are computed on the device, which sends back only the small
(instances, detections) counts; the IoU and the matching run on the host
in float64 as JAX's do. fitness is the sum of the box and mask fitnesses.
`save_json` writes COCO rows with the mask upsampled to the native image
(`imgops.resize_nearest`) as an uncompressed column-major RLE.

Under a mesh of several ranks (`mesh=`, JAX :125-131, :228) each rank
runs its rows of every batch and rank 0 gathers the images' stats in
image order, as `DetectionValidator` does (`engine/validator.py`).

`SegmentationPredictor` (:332-428) is the detect predictor's stream with
one device step of its own: NMS (multi_label False, `return_idx`), the
coefficients gathered, the einsum with the protos in f32, the sigmoid and
the box crop, all on the device; the batch's masks come back trimmed to
its most detections, and each image's are un-padded and upsampled to the
original image on the host (nearest of the binary mask, or with
`retina_masks` the bilinear upsample of the cropped probabilities, then >
0.5). augment runs single-scale with a warning, as JAX's does.

Each takes the live model or an `AutoBackend` of a segment artifact, whose
four outputs (boxes, scores, coefs, protos) go through the same post.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..cfg import get_cfg
from ..data import imgops
from ..data.dataset import check_det_dataset
from ..data.loader import DataLoader
from ..data.segment import SegmentDataset, SegTrainTransforms, collate_segment
from ..losses.segment import segmentation_loss
from ..nn.layers import sigmoid
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from ..parallel.mesh import broadcast_object, gather_in_order, rank_rows
from ..utils import LOGGER, increment_dir
from ..utils.checks import check_imgsz
from ..utils.metrics import DetMetrics, match_from_iou, match_predictions
from ..utils.pipeline import pipelined
from ..utils.plotting import matplotlib_available, plot_images, plot_labels
from .predictor import (DetectionPredictor, PinnedUpload, matmul_precision,
                        require_task, resolve_device, task_outputs)
from .trainer import BaseTrainer

SEG_AUGMENT_KEYS = ("mosaic", "copy_paste", "hsv_h", "hsv_s", "hsv_v",
                    "degrees", "translate", "scale", "shear", "perspective",
                    "fliplr", "photometric")


class SegmentationTrainer(BaseTrainer):
    task = "segment"
    loss_names = ("box", "seg", "cls", "dfl")
    metric_keys = ("metrics/mAP50(B)", "metrics/mAP50-95(B)",
                   "metrics/mAP50(M)", "metrics/mAP50-95(M)")
    batch_keys = ("img", "cls", "bboxes", "mask_gt", "masks")
    default_model = "yolov8-seg.yaml"

    def preflight(self):
        self.args.imgsz = check_imgsz(self.args.imgsz, stride=32)

    def build_train_dataset(self):
        if getattr(self, "train_ds", None) is None:
            a = self.args
            self.train_ds = SegmentDataset(self.data["train"], imgsz=a.imgsz,
                                           nc=self.data["nc"], cache=a.cache)
        return self.train_ds

    def build_train_loader(self):
        a = self.args
        self.train_tf = SegTrainTransforms(
            {k: getattr(a, k) for k in SEG_AUGMENT_KEYS}, imgsz=a.imgsz)
        max_boxes, ratio = a.max_boxes, a.mask_ratio
        return DataLoader(
            self.build_train_dataset(), self.train_tf, a.batch,
            max_boxes=max_boxes, workers=a.workers, shuffle=True, seed=a.seed,
            drop_last=True, use_processes=bool(a.loader_mp),
            collate_fn=lambda items: collate_segment(items, max_boxes, ratio),
            **self.shard_kw())

    def close_augment(self):
        """close_mosaic: letterboxed samples from now on (forked workers are
        closed, so the next epoch forks them anew)."""
        self.train_tf.mosaic_enabled = False
        if getattr(self, "train_dl", None) is not None:
            self.train_dl.close()

    def loss(self, batch):
        """(total, SegLossItems) of one device batch (JAX :69-84)."""
        a = self.args
        det, coefs, protos = self.model_forward(
            batch["img"].to(torch.float32) / 255.0)
        hyp = {"box": a.box, "cls": a.cls, "dfl": a.dfl}
        return segmentation_loss(
            det, coefs, protos, batch, nc=self.model.nc,
            strides=self.model.strides, hyp=hyp,
            max_fg=min(int(a.max_boxes) * 4, 128),
            overlap=bool(a.overlap_mask), group=self.group)

    def get_validator(self, save_dir=None, data=None):
        args = get_cfg(overrides={**vars(self.args), "conf": 0.001,
                        "device": str(self.device)})
        return SegmentationValidator(args=args, save_dir=save_dir, data=data)

    def dummy_batch(self, b):
        a = self.args
        mh = a.imgsz // a.mask_ratio
        return {"img": np.zeros((b, a.imgsz, a.imgsz, 3), np.uint8),
                "bboxes": np.zeros((b, a.max_boxes, 4), np.float32),
                "cls": np.zeros((b, a.max_boxes), np.float32),
                "mask_gt": np.zeros((b, a.max_boxes), np.float32),
                "masks": np.zeros((b, mh, mh), np.float32)}

    def plot_train_start(self):
        """labels.jpg of the polygons' boxes (normalised xywh)."""
        if not matplotlib_available():
            LOGGER.info("plots: matplotlib is not installed; train draws "
                        "only the batch mosaics (OpenCV)")
        rows = [(c, (p[:, 0].min() + p[:, 0].max()) / 2,
                 (p[:, 1].min() + p[:, 1].max()) / 2,
                 p[:, 0].max() - p[:, 0].min(), p[:, 1].max() - p[:, 1].min())
                for lb in self.train_ds.labels for c, p in lb]
        if rows:
            cat = np.asarray(rows, np.float32)
            self._plot(plot_labels, cat[:, 1:5], cat[:, 0],
                       names=self.data.get("names"), save_dir=self.save_dir)

    def plot_train_batch(self, batch, path):
        self._plot(plot_images, batch, path, names=self.data.get("names"))


def _inbox(dets, mh, mw, scale):
    """(B, D, mh, mw) bool: mask pixels inside each detection's xyxy box
    scaled to mask pixels (x1 <= x < x2, y1 <= y < y2)."""
    bx = dets[..., :4] * scale
    ys = torch.arange(mh, dtype=torch.float32, device=dets.device)
    xs = torch.arange(mw, dtype=torch.float32, device=dets.device)
    return ((xs[None, None, None, :] >= bx[..., 0, None, None])
            & (xs[None, None, None, :] < bx[..., 2, None, None])
            & (ys[None, None, :, None] >= bx[..., 1, None, None])
            & (ys[None, None, :, None] < bx[..., 3, None, None]))


def mask_logits(dets, aidx, coef_flat, protos):
    """(B, D, mh, mw) f32 mask logits of the kept detections: their
    coefficients (through the NMS anchor index; -1 rows read anchor 0)
    times the protos."""
    nm = coef_flat.shape[-1]
    sel = torch.gather(coef_flat, 1,
                       aidx.clamp(min=0).long()[..., None].expand(-1, -1, nm))
    return torch.einsum("bdn,bhwn->bdhw", sel.float(), protos.float())


class SegmentationValidator:
    """Box mAP and mask mAP of a segment model (reference SegmentMetrics)."""

    def __init__(self, args=None, save_dir=None, data=None):
        self.args = args if args is not None else get_cfg()
        if self.args.conf is None:
            self.args.conf = 0.001
        self.save_dir = (Path(save_dir) if save_dir else increment_dir(
            Path("runs/segment/val"), self.args.exist_ok))
        self.data = data
        self.device = resolve_device(self.args.device)
        self.upload = PinnedUpload(self.device)
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0,
                      "postprocess": 0.0}
        self.note_no_matplotlib = True

    def __call__(self, model=None, mesh=None):
        from .autobackend import AutoBackend
        from .validator import (DeviceGroups, check_val_mesh,
                                resolve_val_max_boxes, speed_of)
        require_task(model, "segment", "SegmentationValidator")
        a = self.args
        backend = isinstance(model, AutoBackend)
        multi = check_val_mesh(mesh, backend)
        device = (mesh.device if mesh is not None and mesh.size > 1
                  else self.device)
        upload = self.upload if device == self.device else PinnedUpload(device)
        a.imgsz = check_imgsz(a.imgsz, stride=32)
        data = self.data or check_det_dataset(a.data)
        ds = SegmentDataset(data[a.split], imgsz=a.imgsz, nc=data["nc"],
                            cache=a.cache)
        resolve_val_max_boxes(a, ds)
        if not backend:
            model.to(device).eval()
        groups = DeviceGroups(model, mesh, device, upload)
        orig_shapes = ds.image_shapes()
        save_json = bool(a.save_json)
        jdict = []
        bs = model.batch if backend else max(int(a.batch), 1)
        stats = {n: {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
                 for n in ("box", "mask")}
        n_images = 0
        t_pre = t_inf = t_post = 0.0

        records = []         # under a mesh: (dataset index, its record)

        def take(rec):
            for name, (tp, conf, pcls, tcls) in rec["stats"].items():
                stats[name]["tp"].append(tp)
                stats[name]["conf"].append(conf)
                stats[name]["pred_cls"].append(pcls)
                stats[name]["target_cls"].append(tcls)
            jdict.extend(rec["json"])

        def run(model, dev):
            boxes, scores, coef_flat, protos = task_outputs(model, dev["img"])
            dets, counts, aidx = non_max_suppression(
                boxes.float(), scores.float(), conf_thres=float(a.conf),
                iou_thres=float(a.iou), max_det=int(a.max_det),
                max_nms=int(a.max_nms), multi_label=True, return_idx=True)
            out = self._mask_counts(dets, aidx, coef_flat, protos,
                                    dev["masks"], a.imgsz, int(a.max_boxes),
                                    save_json)
            out.update(dets=dets, counts=counts)
            return out

        @torch.inference_mode()
        def dispatch(start):
            nonlocal t_pre, t_inf
            t0 = time.perf_counter()
            idxs = list(range(start, min(start + bs, len(ds))))
            items = [ds.load(i) for i in idxs]
            while len(items) < bs:
                items.append(items[0])
            batch = collate_segment(items, max_boxes=a.max_boxes,
                                    mask_ratio=a.mask_ratio)
            t1 = time.perf_counter()
            t_pre += t1 - t0
            lo, hi = rank_rows(bs, mesh if multi else None)
            if hi == lo:                 # none of this batch's rows
                return None, batch, idxs, lo, hi
            with matmul_precision(a.matmul_precision):
                out = groups(batch, lo, hi, ("img", "masks"), run)
            t_inf += time.perf_counter() - t1
            return out, batch, idxs, lo, hi

        def process(out, batch, idxs, lo, hi):
            nonlocal n_images, t_inf, t_post
            if out is None:
                return
            t0 = time.perf_counter()
            host = {k: v.cpu().numpy() for k, v in out.items()}
            t1 = time.perf_counter()
            t_inf += t1 - t0
            s = batch["img"].shape[1]
            cap = batch["cls"].shape[1]
            for idx in idxs[lo:hi]:
                i = idx - idxs[0] - lo       # the row in this rank's part
                n_images += 1
                h0, w0 = int(orig_shapes[idx][0]), int(orig_shapes[idx][1])
                k = int(host["counts"][i])
                det = host["dets"][i, :k]
                det_nat = det.copy()
                if k:
                    det_nat[:, :4] = scale_boxes(
                        (s, s), torch.from_numpy(det[:, :4].copy()),
                        (h0, w0)).numpy()
                gt_cls, gt_xyxy = [], []
                for c, poly_n in ds.labels[idx]:
                    p = poly_n * np.asarray([w0, h0], np.float32)
                    gt_cls.append(c)
                    gt_xyxy.append([p[:, 0].min(), p[:, 1].min(),
                                    p[:, 0].max(), p[:, 1].max()])
                gt_cls = np.asarray(gt_cls, np.float32)
                gt_xyxy = (np.asarray(gt_xyxy, np.float32) if gt_xyxy
                           else np.zeros((0, 4), np.float32))
                tp_box = match_predictions(det_nat[:, :4], det_nat[:, 5],
                                           gt_xyxy, gt_cls)
                gt_cls_m = gt_cls[:cap]
                tp_mask = self._mask_tp(det, gt_cls_m, host["inter"][i],
                                        host["gt_area"][i], host["pm_area"][i])
                rec = {"stats": {name: (tp, det[:, 4], det[:, 5], tcls)
                                 for name, tp, tcls in (
                                     ("box", tp_box, gt_cls),
                                     ("mask", tp_mask, gt_cls_m))},
                       "json": []}
                if save_json and k:
                    self._to_json(rec["json"], Path(ds.im_files[idx]).stem,
                                  det_nat, host["pm"][i, :k], s, h0, w0)
                if multi:
                    records.append((idx, rec))
                else:
                    take(rec)
            t_post += time.perf_counter() - t1

        pipelined(range(0, len(ds), bs), dispatch, lambda rec: process(*rec))
        if multi:      # rank 0 takes every image's record in image order
            merged = gather_in_order(mesh, records)
            if merged is None:
                self.speed = speed_of(t_pre, t_inf, t_post, n_images)
                return broadcast_object(mesh, None)
            for rec in merged:
                take(rec)
            n_images = len(merged)

        results, fitness = {}, 0.0
        for name, st in stats.items():
            if not st["tp"]:
                continue
            dm = DetMetrics(save_dir=self.save_dir, plot=False,
                            names=data["names"])
            tp = np.concatenate(st["tp"])
            tcls = np.concatenate(st["target_cls"])
            if tp.shape[0] and tcls.shape[0]:
                dm.process(tp, np.concatenate(st["conf"]),
                           np.concatenate(st["pred_cls"]), tcls)
            mr = dm.mean_results()
            tag = name[0].upper()
            results[f"metrics/mAP50({tag})"] = mr[2]
            results[f"metrics/mAP50-95({tag})"] = mr[3]
            fitness += 0.1 * mr[2] + 0.9 * mr[3]
        results["fitness"] = fitness
        if n_images:
            self.speed = speed_of(t_pre, t_inf, t_post, n_images)
        if save_json and jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            jpath = self.save_dir / "predictions.json"
            jpath.write_text(json.dumps(jdict))
            LOGGER.info(f"saved {len(jdict)} detections to {jpath}")
        LOGGER.info(f"segment val: {n_images} images "
                    + " ".join(f"{k}={v:.3f}" for k, v in results.items()))
        return broadcast_object(mesh, results) if multi else results

    @staticmethod
    def _mask_counts(dets, aidx, coef_flat, protos, gt_raster, imgsz, cap,
                     keep_masks):
        """On the device: each detection's mask (sigmoid(logits) > 0.5 in
        its box) and its area, the areas of the ground-truth instances g <
        cap (raster value g + 1) and every (instance, detection)
        intersection, as exact f32 counts; with `keep_masks` the masks too
        (save_json)."""
        mh, mw = protos.shape[1], protos.shape[2]
        pm = (sigmoid(mask_logits(dets, aidx, coef_flat, protos)) > 0.5) \
            & _inbox(dets, mh, mw, mh / imgsz)
        ids = torch.arange(1, cap + 1, device=gt_raster.device,
                           dtype=gt_raster.dtype)
        gt = (gt_raster[:, None] == ids[:, None, None]).flatten(2).float()
        pmf = pm.flatten(2).float()
        out = {"inter": torch.bmm(gt, pmf.transpose(1, 2)),
               "gt_area": gt.sum(-1), "pm_area": pmf.sum(-1)}
        if keep_masks:
            out["pm"] = pm
        return out

    @staticmethod
    def _mask_tp(det, gt_cls, inter, gt_area, pm_area,
                 iouv=np.linspace(0.5, 0.95, 10)):
        """The (k, 10) mask TP matrix of one image from its device counts
        (JAX :302-329): IoU = inter / (union + 1e-9) in float64, zero
        across classes, then the detect matching."""
        k, n_gt = len(det), len(gt_cls)
        if k == 0 or n_gt == 0:
            return np.zeros((k, len(iouv)), bool)
        inter = inter[:n_gt, :k].astype(np.float64)
        union = (gt_area[:n_gt, None].astype(np.float64)
                 + pm_area[None, :k] - inter) + 1e-9
        iou = inter / union
        iou *= (gt_cls[:, None] == det[None, :, 5])
        return match_from_iou(iou, iouv)

    @staticmethod
    def _to_json(jdict, stem, det_nat, pm, s, h0, w0):
        """COCO rows (JAX :247-283): native xywh boxes and the box-cropped
        proto-space mask un-padded, upsampled to the native image by
        nearest neighbour and run-length encoded column-major."""
        image_id = int(stem) if stem.isnumeric() else stem
        mh, mw = pm.shape[1], pm.shape[2]
        scale = mh / s
        gain = min(s / h0, s / w0)
        dw, dh = (s - w0 * gain) / 2 * scale, (s - h0 * gain) / 2 * scale
        y0, y1 = int(round(dh)), int(round(mh - dh)) or mh
        x0, x1 = int(round(dw)), int(round(mw - dw)) or mw
        for d, m in zip(det_nat, pm):
            crop = m[y0:y1, x0:x1].astype(np.uint8)
            native = imgops.resize_nearest(crop, (w0, h0)) > 0
            flat = native.flatten(order="F")
            change = np.nonzero(np.diff(flat))[0] + 1
            runs = np.diff(np.concatenate([[0], change, [flat.size]]))
            counts = ([0] if flat.size and flat[0] else []) + runs.tolist()
            jdict.append({
                "image_id": image_id,
                "category_id": int(d[5]),
                "bbox": [round(float(d[0]), 3), round(float(d[1]), 3),
                         round(float(d[2] - d[0]), 3),
                         round(float(d[3] - d[1]), 3)],
                "score": round(float(d[4]), 5),
                "segmentation": {"size": [h0, w0], "counts": counts}})


class SegmentationPredictor(DetectionPredictor):
    """Segment predict -> Results with Masks (reference segment/predict.py:
    10-40): the detect stream with the mask assembly on the device and the
    un-pad and upsample on the host."""

    task = "segment"

    def __init__(self, args=None, model=None, names=None, save_dir=None,
                 members=None):
        """As DetectionPredictor's; `members` (JAX's parameter) must be
        empty: a segment predict runs the model alone, as JAX's runs its
        first member alone."""
        if members:
            raise ValueError("SegmentationPredictor takes no ensemble members")
        args = args if args is not None else get_cfg()
        if args.augment:
            LOGGER.warning("segment has not supported augment inference yet "
                           "- using single-scale inference instead")
            args.augment = False
        if model is not None:
            require_task(model, "segment", "SegmentationPredictor")
        super().__init__(args=args, model=model, names=names,
                         save_dir=save_dir or increment_dir(
                             Path("runs/segment/predict"), args.exist_ok))
        self.capture, self.keep_enhanced = (), False

    @torch.inference_mode()
    def step(self, img_u8):
        """(B, S, S, 3) uint8 RGB on the host -> {"dets", "counts",
        "masks" (B, max_det, mh, mw) bool, or f32 probabilities with
        retina_masks}, on the device, not waited for (JAX :352-386)."""
        a = self.args
        img = self.upload({"img": img_u8})["img"]
        with matmul_precision(a.matmul_precision):
            if self.backend:
                boxes, scores, coef_flat, protos = task_outputs(self.model, img)
            else:
                x = img.to(torch.bfloat16 if a.half else torch.float32) / 255.0
                boxes, scores, coef_flat, protos = self.model.eval_outputs(x)
            dets, counts, aidx = non_max_suppression(
                boxes.float(), scores.float(), conf_thres=float(a.conf),
                iou_thres=float(a.iou), max_det=int(a.max_det),
                max_nms=int(a.max_nms), multi_label=False,
                agnostic=bool(a.agnostic_nms), return_idx=True)
            mh, mw = protos.shape[1], protos.shape[2]
            prob = torch.sigmoid(mask_logits(dets, aidx, coef_flat, protos))
            inbox = _inbox(dets, mh, mw, mh / img.shape[1])
            masks = prob * inbox if a.retina_masks else (prob > 0.5) & inbox
        return {"dets": dets, "counts": counts, "masks": masks}

    def readback(self, out, n):
        """The batch's outputs on the host, the masks trimmed to the batch's
        most detections."""
        host = super().readback({k: v for k, v in out.items()
                                 if k != "masks"}, n)
        kmax = int(host["counts"][:n].max()) if n else 0
        host["masks"] = out["masks"][:n, :kmax].cpu().numpy()
        return host

    def extra_fields(self, out, i, k, orig_shape, imgsz):
        """Image i's masks at its original size (JAX :408-428): the
        letterbox padding cut off the proto-space masks, then the nearest
        upsample of the binary mask, or with retina_masks the bilinear
        upsample of the probabilities > 0.5."""
        masks = out["masks"][i][:k]
        h0, w0 = orig_shape
        r = min(imgsz / h0, imgsz / w0)
        dw, dh = (imgsz - w0 * r) / 2, (imgsz - h0 * r) / 2
        mh, mw = masks.shape[-2:] if k else (1, 1)
        px = int(round(dw * mw / imgsz))
        py = int(round(dh * mh / imgsz))
        up = []
        for m in masks:
            crop = m[py:mh - py or None, px:mw - px or None]
            if self.args.retina_masks:
                up.append(imgops.resize_linear_f32(crop, (w0, h0)) > 0.5)
            else:
                up.append(imgops.resize_nearest(crop.astype(np.uint8),
                                                (w0, h0)) > 0)
        return {"masks": (np.stack(up) if up
                          else np.zeros((0, h0, w0), bool))}
