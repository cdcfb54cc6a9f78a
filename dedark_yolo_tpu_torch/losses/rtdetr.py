"""RT-DETR's set-matching loss (JAX losses/rtdetr.py): a greedy one-to-one
assignment of queries to ground truths, then varifocal classification with
IoU targets, L1 and GIoU box losses, on every decoder layer and on the
encoder's selected proposals.

The reference fork has no RT-DETR loss (its `ultralytics.models.utils` is
missing); this is the JAX package's objective. The assignment is M rounds
of a masked argmin over each image's (nq, M) cost on the device, with no
host synchronisation (JAX's `fori_loop`).
"""

from __future__ import annotations

import torch

from ..ops.boxes import bbox_iou, xywh2xyxy
from ..parallel.mesh import global_sum
from .detection import LossItems, _bce_logits


def greedy_assign(cost, gt_mask):
    """One-to-one greedy assignment (JAX rtdetr.py:27-76): cost (B, nq, M),
    lower better; gt_mask (B, M) 1 for real rows -> (assign_q (B, M) long,
    the query of each gt, 0 where unmatched; matched (B, M), 1 where the
    gt took a fresh query: an image with more real gts than queries leaves
    the rest unmatched). Each round takes the cheapest pair of a fresh
    query and a fresh real gt; padded columns cost 1e9 and used rows and
    columns 1e12 more, so a used one never ties a padded one."""
    b, nq, m = cost.shape
    big, used_pen = 1e9, 1e12
    cost = cost.masked_fill(gt_mask[:, None, :] <= 0, big)
    used_q = cost.new_zeros(b, nq)
    used_g = cost.new_zeros(b, m)
    assign_q = torch.zeros(b, m, dtype=torch.long, device=cost.device)
    matched = cost.new_zeros(b, m)
    rows = torch.arange(b, device=cost.device)
    for _ in range(m):
        cc = cost + used_q[:, :, None] * used_pen + used_g[:, None, :] * used_pen
        flat = cc.reshape(b, nq * m)
        idx = flat.argmin(1)
        ok = (flat.gather(1, idx[:, None]).squeeze(1) < big).to(cost.dtype)
        q, g = idx // m, idx % m
        used_q[rows, q] = torch.maximum(used_q[rows, q], ok)
        used_g[rows, g] = torch.maximum(used_g[rows, g], ok)
        assign_q[rows, g] = torch.where(ok > 0, q, assign_q[rows, g])
        matched[rows, g] = torch.maximum(matched[rows, g], ok)
    return assign_q, matched


def _layer_loss(pred_boxes, pred_logits, gt_boxes, gt_cls, gt_mask, nc,
                alpha=0.75, gamma=2.0, group=None):
    """One layer's (giou * 2, vfl, l1 * 5) (JAX rtdetr.py:79-122):
    pred_boxes (B, nq, 4) normalized cxcywh, pred_logits (B, nq, nc),
    gt_boxes (B, M, 4) normalized cxcywh. The matching cost (detached) is
    -score at the gt's class + 5 * L1 + 2 * (1 - GIoU)."""
    b, nq, _ = pred_logits.shape
    m = gt_cls.shape[1]
    p = torch.sigmoid(pred_logits)
    gt_cls = gt_cls.long()
    p_at_cls = torch.gather(p, 2, gt_cls[:, None, :].expand(b, nq, m))
    l1 = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_boxes)[:, :, None, :],
                    xywh2xyxy(gt_boxes)[:, None, :, :], xywh=False,
                    GIoU=True).squeeze(-1)
    cost = (-p_at_cls + 5.0 * l1 + 2.0 * (1.0 - giou)).detach()
    assign_q, matched = greedy_assign(cost, gt_mask)
    gt_mask = gt_mask * matched
    num_gt = global_sum(group, gt_mask.sum()).clamp(min=1.0)

    pb = torch.gather(pred_boxes, 1, assign_q[..., None].expand(b, m, 4))
    loss_l1 = ((pb - gt_boxes).abs().sum(-1) * gt_mask).sum() / num_gt
    pxy, gxy = xywh2xyxy(pb), xywh2xyxy(gt_boxes)
    giou_m = bbox_iou(pxy, gxy, xywh=False, GIoU=True).squeeze(-1)
    loss_giou = ((1.0 - giou_m) * gt_mask).sum() / num_gt

    # varifocal: the matched pair's IoU at the gt's class, max over gts
    # that share a query (JAX's .at[].max), 0 elsewhere
    iou_m = bbox_iou(pxy, gxy, xywh=False).squeeze(-1).detach() * gt_mask
    tgt = p.new_zeros(b, nq * nc).scatter_reduce(
        1, assign_q * nc + gt_cls, iou_m.clamp(min=0.0), "amax",
        include_self=True).reshape(b, nq, nc)
    pos = (tgt > 0).to(p.dtype)
    w = alpha * p.pow(gamma) * (1.0 - pos) + tgt
    loss_cls = (_bce_logits(pred_logits, tgt) * w).sum() / num_gt
    return loss_giou * 2.0, loss_cls * 1.0, loss_l1 * 5.0


def rtdetr_loss(outputs: dict, batch: dict, nc: int, hyp: dict | None = None,
                group=None):
    """(total, LossItems) of RTDETRDecoder's train outputs (JAX
    rtdetr.py:125-165): the sum of every decoder layer's and the encoder
    proposals' losses times the batch size; the items are the last
    layer's (giou, vfl, l1) in the trainer's (box, cls, dfl) slots. The
    recovery MSE times lrl joins the total and the cls item, as in
    `detection_loss`. `group`: this rank's share of the global batch's
    loss, `num_gt` (JAX rtdetr.py:99) and the batch size summed over the
    group."""
    gt_boxes, gt_cls = batch["bboxes"], batch["cls"]
    gt_mask = batch["mask_gt"].to(outputs["dec_bboxes"].dtype)
    b = gt_boxes.shape[0]
    if group is not None:
        b = global_sum(group, gt_mask.new_tensor(float(b)))
    total, final = 0.0, None
    for boxes, logits in zip(outputs["dec_bboxes"], outputs["dec_logits"]):
        final = _layer_loss(boxes, logits, gt_boxes, gt_cls, gt_mask, nc,
                            group=group)
        total = total + final[0] + final[1] + final[2]
    g, c, l = _layer_loss(outputs["enc_bboxes"], outputs["enc_logits"],
                          gt_boxes, gt_cls, gt_mask, nc, group=group)
    total = (total + g + c + l) * b
    loss_box, loss_cls, loss_l1 = final
    rec = batch.get("recovery_loss")
    if rec is not None and hyp is not None:
        lrl = hyp.get("lrl", 0.0)
        total = total + lrl * rec.mean()
        loss_cls = loss_cls + lrl * rec.mean()
    return total, LossItems(loss_box.detach(), loss_cls.detach(),
                            loss_l1.detach())
