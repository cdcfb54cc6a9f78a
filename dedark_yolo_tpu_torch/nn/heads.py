"""YOLOv8 Detect, AsffDetect, Segment and Pose heads, RT-DETR's decoder
head, and the eval decodes (JAX nn/heads.py:28-315).

The head returns raw per-level maps in the JAX layout, (B, H, W, 4*reg_max +
nc); `decode_detections` turns them into xywh pixel boxes and sigmoid class
scores. DFL is a fixed arange, not a module, so it has no state_dict key.
Segment also returns per-level (B, H, W, nm) mask coefficients and the
(B, 2H0, 2W0, nm) prototypes of the first level, NHWC as in JAX; Pose the
per-level (B, H, W, nk * kdim) keypoint maps, which `decode_keypoints`
turns into pixel keypoints.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.nms import top_k
from ..utils import device_cache
from .layers import BatchNorm, BiasConv2d, Conv, Linear, Proto, sigmoid
from .transformer import (MLP, DeformableTransformerDecoderLayer, LayerNorm,
                          inverse_sigmoid)


class Detect(nn.Module):
    """Per-level box (4*reg_max ch) and cls (nc ch) branches.

    Branch widths c2 = max(16, ch0//4, 4*reg_max), c3 = max(ch0, min(nc, 100))
    (reference head.py:38).
    """

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          BiasConv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3),
                          BiasConv2d(c3, nc, 1)) for x in ch)

    def bias_init(self):
        """Box bias 1.0, cls bias log(5 / nc / (640/stride)^2) (head.py:95-102)."""
        for box, cls, s in zip(self.cv2, self.cv3, self.strides):
            box[-1].bias.data.fill_(1.0)
            cls[-1].bias.data.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, xs):
        return [torch.cat([b(x), c(x)], 1).permute(0, 2, 3, 1)
                for x, b, c in zip(xs, self.cv2, self.cv3)]


class AsffDetect(Detect):
    """Detect with one biased 1x1 a branch and level (reference
    head.py:105-174, JAX heads.py:65-85), `cv2.{i}.0` and `cv3.{i}.0`; the
    same raw-map layout, biases and decode as Detect."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 reg_max: int = 16):
        nn.Module.__init__(self)
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.cv2 = nn.ModuleList(
            nn.Sequential(BiasConv2d(x, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(BiasConv2d(x, nc, 1)) for x in ch)


class Segment(Detect):
    """Detect plus a mask-coefficient branch a level and Proto on the first
    level (reference head.py:177-200, JAX heads.py:90-116): `cv4.{i}` is two
    Convs to c4 = max(ch0 // 4, nm) and a biased 1x1 to nm coefficients;
    `proto` makes nm prototypes from npr channels at twice the first
    level's size. forward -> (detect maps, coefficient maps, protos), each
    NHWC."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 nm: int = 32, npr: int = 256, reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          BiasConv2d(c4, nm, 1)) for x in ch)

    def forward(self, xs):
        protos = self.proto(xs[0]).permute(0, 2, 3, 1)
        coefs = [c(x).permute(0, 2, 3, 1) for x, c in zip(xs, self.cv4)]
        return super().forward(xs), coefs, protos


class Pose(Detect):
    """Detect plus a keypoint branch a level (reference head.py:203-241, JAX
    heads.py:119-140): `cv4.{i}` is two Convs to c4 = max(ch0 // 4, nk *
    kdim) and a biased 1x1 to nk * kdim values an anchor. forward ->
    (detect maps, keypoint maps), each NHWC."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 kpt_shape=(17, 3), reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          BiasConv2d(c4, nk, 1)) for x in ch)

    def forward(self, xs):
        kpts = [c(x).permute(0, 2, 3, 1) for x, c in zip(xs, self.cv4)]
        return super().forward(xs), kpts


def decode_keypoints(kpt_maps, strides: Sequence[int], kpt_shape=(17, 3)):
    """Raw keypoint maps -> (B, N, nk, kdim) keypoints in pixels (JAX
    heads.py:275-291, reference head.py kpts_decode): xy = (2 * offset +
    anchor - 0.5) * stride, the visibility through a sigmoid."""
    feat_shapes = [(m.shape[1], m.shape[2]) for m in kpt_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                     device=kpt_maps[0].device)
    b = kpt_maps[0].shape[0]
    nk, kdim = kpt_shape
    x = torch.cat([m.reshape(b, -1, nk, kdim) for m in kpt_maps], 1)
    xy = (x[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) \
        * stride_t[None, :, None, :]
    if kdim == 3:
        return torch.cat([xy, sigmoid(x[..., 2:3])], -1)
    return xy


def flatten_raw(raw_maps):
    """Per-level (B, H, W, no) maps -> (B, sum(hw), no), reference anchor order."""
    b = raw_maps[0].shape[0]
    return torch.cat([m.reshape(b, -1, m.shape[-1]) for m in raw_maps], 1)


def decode_detections(raw_maps, nc: int, strides: Sequence[int],
                      reg_max: int = 16):
    """Raw maps -> (boxes_xywh_pixels (B, N, 4), class_scores (B, N, nc))."""
    if torch.is_tensor(raw_maps):
        raise ValueError("decode_detections takes a detect head's list of "
                         "per-level maps; a single tensor is a classify "
                         "model's logits (DetectionModel.decode)")
    feat_shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, 0.5,
                                     device=raw_maps[0].device)
    x = flatten_raw(raw_maps)
    box, cls = x[..., :4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_decode(box, reg_max)
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return dbox, sigmoid(cls)


@device_cache(maxsize=16)
def rtdetr_anchors(shapes, device, eps: float = 1e-2):
    """RT-DETR's static anchors of level maps of `shapes` ((h, w) each),
    one a pixel (JAX heads.py:204-217, reference head.py:360-377):
    inverse-sigmoid cxcywh, the centre at the pixel's centre normalised by
    its map's w and h, the size 0.05 * 2^level; +inf where a coordinate
    is not inside (eps, 1 - eps). Also that mask, (1, N, 1) bool. JAX
    normalises x by w and y by h where the reference swaps them (ROADMAP,
    known differences). Made on `device`, where an exported program makes
    them too (the card's log differs from the host's in the last bit).
    Callers must not write to the tensors."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full_like(xy, 0.05 * (2.0 ** i))
        anchors.append(torch.cat([xy, wh], -1).reshape(-1, 4))
    anchors = torch.cat(anchors, 0)[None]
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.where(valid, inverse_sigmoid(anchors),
                          torch.tensor(float("inf"), device=device))
    return anchors, valid


class RTDETRDecoder(nn.Module):
    """RT-DETR's decoder head (JAX heads.py:144-273, reference head.py:
    263-457): each level projected to hd by a 1x1 conv and a plain BN
    (flax's BatchNorm: momentum 0.9, eps 1e-5); an encoder head scores and
    boxes every pixel of the joined levels (masked to the valid anchors);
    the nq best by class score are the queries, refined through ndl
    deformable decoder layers with a shared query-position MLP. Eval
    returns (B, nq, 4 + nc): the eval_idx layer's normalized cxcywh boxes
    and its sigmoid scores, NMS-free. Train returns the set-matching
    loss's dict: `dec_bboxes`, `dec_logits` (ndl, B, nq, .) and
    `enc_bboxes`, `enc_logits` (B, nq, .) of the selected queries; the
    queries' boxes and contents are detached before layer 0, each layer's
    refined boxes before the next. The contrastive denoising branch is
    not in the JAX package either."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 hd: int = 256, nq: int = 300, ndp: int = 4, nh: int = 8,
                 ndl: int = 6, d_ffn: int = 1024, eval_idx: int = -1):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.strides = tuple(strides)
        self.eval_idx = eval_idx if eval_idx >= 0 else ndl + eval_idx
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False),
                          BatchNorm(hd, eps=1e-5, momentum=0.1)) for c in ch)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd))
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.decoder = nn.ModuleList(
            DeformableTransformerDecoderLayer(hd, nh, d_ffn, len(ch), ndp)
            for _ in range(ndl))
        self.dec_score_head = nn.ModuleList(Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3)
                                           for _ in range(ndl))

    @property
    def bias_cls(self) -> float:
        """The score heads' initial bias (JAX heads.py:183)."""
        return float(-math.log((1 - 0.01) / 0.01)) / 80 * self.nc

    def forward(self, xs):
        feats = [p(x) for p, x in zip(self.input_proj, xs)]
        b = feats[0].shape[0]
        seq = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)
        anchors, valid = rtdetr_anchors(
            tuple((f.shape[2], f.shape[3]) for f in feats), seq.device)

        features = self.enc_output(seq * valid.to(seq.dtype))
        enc_scores = self.enc_score_head(features)
        enc_bboxes = self.enc_bbox_head(features) + anchors

        nq = min(self.nq, seq.shape[1])
        topk = top_k(enc_scores.amax(-1), nq)[1]
        pick = lambda t: torch.gather(
            t, 1, topk[..., None].expand(-1, -1, t.shape[-1]))
        refer, embed = pick(enc_bboxes), pick(features)
        if self.training:
            refer, embed = refer.detach(), embed.detach()
        refer = sigmoid(refer)

        dec_bboxes, dec_logits = [], []
        output = embed
        last = self.ndl - 1 if self.training else self.eval_idx
        for i in range(last + 1):
            qp = self.query_pos_head(refer)
            output = self.decoder[i](output, refer, feats, query_pos=qp)
            refined = sigmoid(self.dec_bbox_head[i](output)
                              + inverse_sigmoid(refer))
            dec_bboxes.append(refined)
            if self.training or i == last:
                dec_logits.append(self.dec_score_head[i](output))
            refer = refined.detach() if self.training else refined
        if self.training:
            return {"dec_bboxes": torch.stack(dec_bboxes),
                    "dec_logits": torch.stack(dec_logits),
                    "enc_bboxes": pick(sigmoid(enc_bboxes)),
                    "enc_logits": pick(enc_scores)}
        return torch.cat([dec_bboxes[-1], sigmoid(dec_logits[-1])], -1)
