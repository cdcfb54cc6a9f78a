"""The pose task: trainer, validator and predictor (JAX engine/pose.py;
reference models/yolo/pose/).

`PoseTrainer` is the `BaseTrainer` loop with JAX's pose hooks (:48-120):
the keypoint dataset and its mosaic / affine loader (`data/pose.py`), the
u8 image / 255 in f32 through the graph in train mode (no degrade and no
priors; `amp` is ignored, as JAX's pose loss ignores it), `losses/
segment.py::pose_loss` with max_fg = min(4 max_boxes, 128), and box plus
pose validation.

`PoseValidator` (:123-298) reports box mAP and pose mAP, both in native
image space: the kept detections' boxes through `scale_boxes`, their
keypoints (gathered on the device through the NMS anchor index,
`return_idx`) through `scale_coords`, the ground truth from the labels at
the image's own size. A detection's pose TP row comes from the OKS of its
keypoints with each instance of its class (`kpt_oks`, sigmas OKS_SIGMA for
17 keypoints, else 1/nk; area the box's times 0.53) at the ten thresholds.
fitness is the sum of the box and pose fitnesses. `save_json` writes COCO
rows with the native keypoints.

`PosePredictor` (:301-360) is the detect predictor's stream with one
device step of its own: NMS (multi_label False, `return_idx`) and the kept
detections' keypoints gathered on the device; `extra_fields` inverts the
letterbox of each image's keypoints (clipped to the image). augment runs
single-scale with a warning, as JAX's does.

Each takes the live model or an `AutoBackend` of a pose artifact, whose
three outputs (boxes, scores, kpts) go through the same post.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..cfg import get_cfg
from ..data.dataset import check_det_dataset
from ..data.loader import DataLoader
from ..data.pose import PoseDataset, PoseTrainTransforms, collate_pose
from ..losses.segment import OKS_SIGMA, pose_loss
from ..ops.boxes import scale_boxes, scale_coords
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

POSE_AUGMENT_KEYS = ("mosaic", "hsv_h", "hsv_s", "hsv_v", "degrees",
                     "translate", "scale", "shear", "perspective",
                     "photometric")


def kpt_oks(gt_kpts, pred_kpts, area, sigmas):
    """Object keypoint similarity of (n_gt, nk, 3) and (n_pred, nk, 3)
    pixel keypoints -> (n_gt, n_pred), over the instance's visible
    keypoints (JAX :31-40, reference metrics.py kpt_iou)."""
    d = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 +
         (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)
    vis = gt_kpts[:, None, :, 2] > 0
    e = d / (2 * sigmas[None, None]) ** 2 / (area[:, None, None] + 1e-9) / 2
    oks = np.exp(-e) * vis
    return oks.sum(-1) / np.maximum(vis.sum(-1), 1)


def oks_sigmas(nk):
    """The OKS sigmas of nk keypoints: COCO's for 17, else 1 / nk each."""
    return (OKS_SIGMA.numpy() if nk == 17
            else np.ones(nk, np.float32) / nk)


def gather_keypoints(kpts, aidx):
    """(B, max_det, nk, kdim) f32 keypoints of the kept detections through
    the NMS anchor index (-1 rows read anchor 0), on the device."""
    nk, kdim = kpts.shape[-2:]
    return torch.gather(kpts.float(), 1, aidx.clamp(min=0).long()[
        ..., None, None].expand(-1, -1, nk, kdim))


def model_kpt_shape(model):
    """(nk, dims) of the model's Pose head (JAX engine/pose.py:42-45):
    `DetectionModel.kpt_shape`."""
    return model.kpt_shape


class PoseTrainer(BaseTrainer):
    task = "pose"
    loss_names = ("box", "pose", "kobj", "cls", "dfl")
    metric_keys = ("metrics/mAP50(B)", "metrics/mAP50-95(B)",
                   "metrics/mAP50(P)", "metrics/mAP50-95(P)")
    batch_keys = ("img", "cls", "bboxes", "mask_gt", "keypoints")
    default_model = "yolov8-pose.yaml"

    def preflight(self):
        self.args.imgsz = check_imgsz(self.args.imgsz, stride=32)

    def build_train_dataset(self):
        if getattr(self, "train_ds", None) is None:
            a = self.args
            self.train_ds = PoseDataset(
                self.data["train"], imgsz=a.imgsz, nc=self.data["nc"],
                kpt_shape=self.model.kpt_shape, cache=a.cache)
        return self.train_ds

    def build_train_loader(self):
        a = self.args
        nk = self.model.kpt_shape[0]
        self.train_tf = PoseTrainTransforms(
            {k: getattr(a, k) for k in POSE_AUGMENT_KEYS}, imgsz=a.imgsz)
        max_boxes = a.max_boxes
        return DataLoader(
            self.build_train_dataset(), self.train_tf, a.batch,
            max_boxes=max_boxes, workers=a.workers, shuffle=True, seed=a.seed,
            drop_last=True, use_processes=bool(a.loader_mp),
            collate_fn=lambda items: collate_pose(items, max_boxes, nk),
            **self.shard_kw())

    def close_augment(self):
        """close_mosaic: letterboxed samples from now on (forked workers are
        closed, so the next epoch forks them anew)."""
        self.train_tf.mosaic_enabled = False
        if getattr(self, "train_dl", None) is not None:
            self.train_dl.close()

    def loss(self, batch):
        """(total, PoseLossItems) of one device batch (JAX :93-106)."""
        a = self.args
        det, kpts = self.model_forward(batch["img"].to(torch.float32) / 255.0)
        hyp = {"box": a.box, "cls": a.cls, "dfl": a.dfl, "pose": a.pose,
               "kobj": a.kobj}
        return pose_loss(det, kpts, batch, nc=self.model.nc,
                         strides=self.model.strides, hyp=hyp,
                         kpt_shape=self.model.kpt_shape,
                         max_fg=min(int(a.max_boxes) * 4, 128),
                         group=self.group)

    def get_validator(self, save_dir=None, data=None):
        args = get_cfg(overrides={**vars(self.args), "conf": 0.001,
                        "device": str(self.device)})
        return PoseValidator(args=args, save_dir=save_dir, data=data,
                             kpt_shape=self.model.kpt_shape)

    def dummy_batch(self, b):
        a = self.args
        nk = self.model.kpt_shape[0]
        return {"img": np.zeros((b, a.imgsz, a.imgsz, 3), np.uint8),
                "bboxes": np.zeros((b, a.max_boxes, 4), np.float32),
                "cls": np.zeros((b, a.max_boxes), np.float32),
                "mask_gt": np.zeros((b, a.max_boxes), np.float32),
                "keypoints": np.zeros((b, a.max_boxes, nk, 3), np.float32)}

    def plot_train_start(self):
        """labels.jpg of the instances' boxes (normalised xywh)."""
        if not matplotlib_available():
            LOGGER.info("plots: matplotlib is not installed; train draws "
                        "only the batch mosaics (OpenCV)")
        rows = [(c, *box) for lb in self.train_ds.labels for c, box, _ in lb]
        if rows:
            cat = np.asarray(rows, np.float32)
            self._plot(plot_labels, cat[:, 1:5], cat[:, 0],
                       names=self.data.get("names"), save_dir=self.save_dir)

    def plot_train_batch(self, batch, path):
        self._plot(plot_images, batch, path, names=self.data.get("names"))


class PoseValidator:
    """Box mAP and pose (OKS) mAP of a pose model (reference PoseMetrics)."""

    def __init__(self, args=None, save_dir=None, data=None,
                 kpt_shape=(17, 3)):
        self.args = args if args is not None else get_cfg()
        if self.args.conf is None:
            self.args.conf = 0.001
        self.save_dir = (Path(save_dir) if save_dir else increment_dir(
            Path("runs/pose/val"), self.args.exist_ok))
        self.data = data
        self.kpt_shape = tuple(kpt_shape)
        self.device = resolve_device(self.args.device)
        self.upload = PinnedUpload(self.device)
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0,
                      "postprocess": 0.0}
        self.note_no_matplotlib = True

    def __call__(self, model=None, mesh=None):
        """Box and pose mAP of `model`; under a mesh of several ranks each
        rank runs its rows of every batch and rank 0 gathers the images'
        stats in image order (JAX :150-156, :266), as `DetectionValidator`
        does. A validator's kpt_shape that is not the model's raises."""
        from .autobackend import AutoBackend
        from .validator import (DeviceGroups, check_val_mesh,
                                resolve_val_max_boxes, speed_of)
        require_task(model, "pose", "PoseValidator")
        a = self.args
        backend = isinstance(model, AutoBackend)
        multi = check_val_mesh(mesh, backend)
        device = (mesh.device if mesh is not None and mesh.size > 1
                  else self.device)
        upload = self.upload if device == self.device else PinnedUpload(device)
        a.imgsz = check_imgsz(a.imgsz, stride=32)
        data = self.data or check_det_dataset(a.data)
        kpt_shape = self.kpt_shape
        if tuple(model.kpt_shape) != kpt_shape:
            raise ValueError(f"PoseValidator's kpt_shape {kpt_shape} is not "
                             f"the model's {tuple(model.kpt_shape)}")
        nk = kpt_shape[0]
        ds = PoseDataset(data[a.split], imgsz=a.imgsz, nc=data["nc"],
                         kpt_shape=kpt_shape, cache=a.cache)
        resolve_val_max_boxes(a, ds)
        if not backend:
            model.to(device).eval()
        groups = DeviceGroups(model, mesh, device, upload)
        sigmas = oks_sigmas(nk)
        orig_shapes = ds.image_shapes()
        save_json = bool(a.save_json)
        jdict = []
        bs = model.batch if backend else max(int(a.batch), 1)
        stats = {n: {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
                 for n in ("B", "P")}
        iouv = np.linspace(0.5, 0.95, 10)
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
            boxes, scores, kpts = task_outputs(model, dev["img"])
            dets, counts, aidx = non_max_suppression(
                boxes.float(), scores.float(), conf_thres=float(a.conf),
                iou_thres=float(a.iou), max_det=int(a.max_det),
                max_nms=int(a.max_nms), multi_label=True, return_idx=True)
            return {"dets": dets, "counts": counts,
                    "kpts": gather_keypoints(kpts, aidx)}

        @torch.inference_mode()
        def dispatch(start):
            nonlocal t_pre, t_inf
            t0 = time.perf_counter()
            idxs = list(range(start, min(start + bs, len(ds))))
            items = [ds.load(i) for i in idxs]
            while len(items) < bs:
                items.append(items[0])
            batch = collate_pose(items, max_boxes=a.max_boxes, nk=nk)
            t1 = time.perf_counter()
            t_pre += t1 - t0
            lo, hi = rank_rows(bs, mesh if multi else None)
            if hi == lo:                 # none of this batch's rows
                return None, batch, idxs, lo, hi
            with matmul_precision(a.matmul_precision):
                out = groups(batch, lo, hi, ("img",), run)
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
            for idx in idxs[lo:hi]:
                i = idx - idxs[0] - lo       # the row in this rank's part
                n_images += 1
                h0, w0 = int(orig_shapes[idx][0]), int(orig_shapes[idx][1])
                k = int(host["counts"][i])
                det = host["dets"][i, :k]
                det_nat = det.copy()
                pk_nat = np.zeros((k, nk, 3), np.float32)
                if k:
                    det_nat[:, :4] = scale_boxes(
                        (s, s), torch.from_numpy(det[:, :4].copy()),
                        (h0, w0)).numpy()
                    pk_nat = scale_coords(
                        (s, s), torch.from_numpy(host["kpts"][i, :k].copy()),
                        (h0, w0)).numpy()
                gt_cls, gt_xyxy, gt_k = [], [], []
                for c, box_n, kpt_n in ds.labels[idx]:
                    cx, cy, bw, bh = box_n * np.asarray([w0, h0, w0, h0],
                                                        np.float32)
                    gt_cls.append(c)
                    gt_xyxy.append([cx - bw / 2, cy - bh / 2,
                                    cx + bw / 2, cy + bh / 2])
                    gt_k.append(kpt_n * np.asarray([w0, h0, 1.0], np.float32))
                gt_cls = np.asarray(gt_cls, np.float32)
                gt_xyxy = (np.asarray(gt_xyxy, np.float32) if gt_xyxy
                           else np.zeros((0, 4), np.float32))
                gt_k = (np.stack(gt_k) if gt_k
                        else np.zeros((0, nk, 3), np.float32))
                tp_box = match_predictions(det_nat[:, :4], det_nat[:, 5],
                                           gt_xyxy, gt_cls)
                tp_pose = np.zeros((k, 10), bool)
                if k and len(gt_cls):
                    area = ((gt_xyxy[:, 2] - gt_xyxy[:, 0])
                            * (gt_xyxy[:, 3] - gt_xyxy[:, 1]) * 0.53)
                    oks = kpt_oks(gt_k, pk_nat, area, sigmas)   # (n_gt, k)
                    oks = oks * (gt_cls[:, None] == det_nat[None, :, 5])
                    tp_pose = match_from_iou(oks, iouv)
                rec = {"stats": {name: (tp, det[:, 4], det[:, 5], gt_cls)
                                 for name, tp in (("B", tp_box),
                                                  ("P", tp_pose))},
                       "json": []}
                if save_json and k:
                    self._to_json(rec["json"], Path(ds.im_files[idx]).stem,
                                  det_nat, pk_nat)
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
            dm = DetMetrics(save_dir=self.save_dir, plot=False,
                            names=data["names"])
            tp = (np.concatenate(st["tp"]) if st["tp"]
                  else np.zeros((0, 10), bool))
            tcls = (np.concatenate(st["target_cls"]) if st["target_cls"]
                    else np.zeros(0, np.float32))
            if tp.shape[0] and tcls.shape[0]:
                dm.process(tp, np.concatenate(st["conf"]),
                           np.concatenate(st["pred_cls"]), tcls)
            mr = dm.mean_results()
            results[f"metrics/mAP50({name})"] = mr[2]
            results[f"metrics/mAP50-95({name})"] = mr[3]
            fitness += 0.1 * mr[2] + 0.9 * mr[3]
        results["fitness"] = fitness
        if n_images:
            self.speed = speed_of(t_pre, t_inf, t_post, n_images)
        if save_json and jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            jpath = self.save_dir / "predictions.json"
            jpath.write_text(json.dumps(jdict))
            LOGGER.info(f"saved {len(jdict)} detections to {jpath}")
        LOGGER.info(f"pose val: {n_images} images "
                    + " ".join(f"{k}={v:.3f}" for k, v in results.items()))
        return broadcast_object(mesh, results) if multi else results

    @staticmethod
    def _to_json(jdict, stem, det_nat, pk_nat):
        """COCO rows (JAX :259-270): native xywh boxes and keypoints."""
        image_id = int(stem) if stem.isnumeric() else stem
        for d, kp in zip(det_nat, pk_nat):
            jdict.append({
                "image_id": image_id,
                "category_id": int(d[5]),
                "bbox": [round(float(d[0]), 3), round(float(d[1]), 3),
                         round(float(d[2] - d[0]), 3),
                         round(float(d[3] - d[1]), 3)],
                "score": round(float(d[4]), 5),
                "keypoints": [round(float(v), 3) for v in kp.flatten()]})


class PosePredictor(DetectionPredictor):
    """Pose predict -> Results with Keypoints (reference pose/predict.py):
    the detect stream with the keypoint gather on the device and the
    letterbox inverse on the host."""

    task = "pose"

    def __init__(self, args=None, model=None, names=None, save_dir=None,
                 members=None):
        """As DetectionPredictor's; `members` (JAX's parameter) must be
        empty: a pose predict runs the model alone, as JAX's runs its
        first member alone."""
        if members:
            raise ValueError("PosePredictor takes no ensemble members")
        args = args if args is not None else get_cfg()
        if args.augment:
            LOGGER.warning("pose has not supported augment inference yet - "
                           "using single-scale inference instead")
            args.augment = False
        if model is not None:
            require_task(model, "pose", "PosePredictor")
        super().__init__(args=args, model=model, names=names,
                         save_dir=save_dir or increment_dir(
                             Path("runs/pose/predict"), args.exist_ok))
        self.capture, self.keep_enhanced = (), False

    @torch.inference_mode()
    def step(self, img_u8):
        """(B, S, S, 3) uint8 RGB on the host -> {"dets", "counts", "kpts"
        (B, max_det, nk, kdim) f32 letterbox pixels}, on the device, not
        waited for (JAX :314-341)."""
        a = self.args
        img = self.upload({"img": img_u8})["img"]
        with matmul_precision(a.matmul_precision):
            if self.backend:
                boxes, scores, kpts = task_outputs(self.model, img)
            else:
                x = img.to(torch.bfloat16 if a.half else torch.float32) / 255.0
                boxes, scores, kpts = self.model.eval_outputs(x)
            dets, counts, aidx = non_max_suppression(
                boxes.float(), scores.float(), conf_thres=float(a.conf),
                iou_thres=float(a.iou), max_det=int(a.max_det),
                max_nms=int(a.max_nms), multi_label=False,
                agnostic=bool(a.agnostic_nms), return_idx=True)
        return {"dets": dets, "counts": counts,
                "kpts": gather_keypoints(kpts, aidx)}

    def extra_fields(self, out, i, k, orig_shape, imgsz):
        """Image i's keypoints in its original pixels (JAX :351-360): the
        letterbox inverted as `scale_boxes` inverts it, x and y clipped to
        the image."""
        kpts = np.asarray(out["kpts"][i][:k]).copy()
        h0, w0 = orig_shape
        r = min(imgsz / h0, imgsz / w0)
        dw, dh = (imgsz - w0 * r) / 2, (imgsz - h0 * r) / 2
        if k:
            kpts[..., 0] = np.clip((kpts[..., 0] - dw) / r, 0, w0)
            kpts[..., 1] = np.clip((kpts[..., 1] - dh) / r, 0, h0)
        return {"keypoints": kpts}
