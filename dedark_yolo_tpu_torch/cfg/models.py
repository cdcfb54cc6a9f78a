"""Model architectures as Python data (copies of the JAX package's model yamls).

The same `[from, repeats, module, args]` rows as the JAX package's detect
architectures under `cfg/models/` (the flagship `yolov8.yaml`, stock
`yolov8ori.yaml` and the fork's variants `yolov8-*.yaml`), its
classifier `yolov8-cls.yaml` (its own scales), its instance
segmentation graph `yolov8-seg.yaml` and its keypoint graphs
`yolov8-pose.yaml` and `yolov8-pose-p6.yaml`, and the RT-DETR hybrid
`yolov8-rtdetr.yaml`, kept as dicts so
the port needs no YAML parser to build its models; each keeps its yaml's own
`nc`, which `nc=` overrides. Keyed by the unified file name that
`model_yaml_load` resolves a scaled name such as `yolov8l.yaml` or
`yolov8n-p6.yaml` to.
"""

from __future__ import annotations

_SCALES = {
    # [depth, width, max_channels]
    "n": [0.33, 0.25, 1024],
    "s": [0.33, 0.50, 1024],
    "m": [0.67, 0.75, 768],
    "l": [1.00, 1.00, 512],
    "x": [1.00, 1.25, 512],
}

_BACKBONE = [
    [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 3, "C2f", [128, True]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 6, "C2f", [256, True]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 6, "C2f", [512, True]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 3, "C2f", [1024, True]],
    [-1, 1, "SPPF", [1024, 5]],
]

# Dedark-YOLO flagship: lowlight_recovery (layer 0) + YOLOv8 backbone/FPN +
# 3x AsffTribeLevel fusion + Detect head.
YOLOV8 = {
    "nc": 80,
    "scales": _SCALES,
    "backbone": [[-1, 1, "lowlight_recovery", [3]]] + _BACKBONE,
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],   # 11
        [[-1, 7], 1, "Concat", [1]],                      # 12 cat backbone P4
        [-1, 3, "C2f", [512]],                            # 13
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],   # 14
        [[-1, 5], 1, "Concat", [1]],                      # 15 cat backbone P3
        [-1, 3, "C2f", [256]],                            # 16 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],                     # 17
        [[-1, 13], 1, "Concat", [1]],                     # 18 cat head P4
        [-1, 3, "C2f", [512]],                            # 19 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],                     # 20
        [[-1, 10], 1, "Concat", [1]],                     # 21 cat head P5
        [-1, 3, "C2f", [1024]],                           # 22 (P5/32-large)
        [[22, 19, 16], 1, "AsffTribeLevel", [0]],         # 23
        [[22, 19, 16], 1, "AsffTribeLevel", [1]],         # 24
        [[22, 19, 16], 1, "AsffTribeLevel", [2]],         # 25
        [[25, 24, 23], 1, "Detect", ["nc"]],              # 26 Detect(P3, P4, P5)
    ],
}

# Stock YOLOv8 detection graph (no enhancement, no ASFF).
YOLOV8ORI = {
    "nc": 80,
    "scales": _SCALES,
    "backbone": _BACKBONE,
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C2f", [512]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C2f", [256]],                            # 15 out: P3/8
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "C2f", [512]],                            # 18 out: P4/16
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 3, "C2f", [1024]],                           # 21 out: P5/32
        [[15, 18, 21], 1, "Detect", ["nc"]],
    ],
}

_UP = [-1, 1, "nn.Upsample", ["None", 2, "nearest"]]
# YOLOv8's top-down and bottom-up FPN over a backbone without layer 0: P3/8,
# P4/16 and P5/32 out at rows 15, 18 and 21
_FPN = YOLOV8ORI["head"][:-1]


def _blocks(rows, c2f):
    """Rows with every C2f replaced by the block `c2f`."""
    return [[f, n, c2f if m == "C2f" else m, a] for f, n, m, a in rows]


def _variant(nc, backbone, head):
    return {"nc": nc, "scales": _SCALES, "backbone": backbone, "head": head}


_RFB = [[15, 1, "RFBblock", [256]],                  # 22
        [18, 1, "RFBblock", [512]],                  # 23
        [21, 1, "RFBblock", [512]]]                  # 24
_FASTER_BACKBONE = _blocks(_BACKBONE, "FasterC2f_N")

# YOLOv8 image classification: the detect backbone without SPPF, then the
# Classify head (a 1x1 Conv to 1280, the mean over H and W, the logits);
# max_channels 1024 at every scale (the JAX yaml's)
YOLOV8_CLS = {
    "nc": 1000,
    "scales": {"n": [0.33, 0.25, 1024], "s": [0.33, 0.50, 1024],
               "m": [0.67, 0.75, 1024], "l": [1.00, 1.00, 1024],
               "x": [1.00, 1.25, 1024]},
    "backbone": _BACKBONE[:9],
    "head": [[-1, 1, "Classify", ["nc"]]],
}

# YOLOv8 instance segmentation: the stock graph with the Segment head
# (nm 32 mask coefficients a level, npr 256 proto channels scaled by width)
YOLOV8_SEG = {
    "nc": 80,
    "scales": _SCALES,
    "backbone": _BACKBONE,
    "head": _FPN + [[[15, 18, 21], 1, "Segment", ["nc", 32, 256]]],
}

# YOLOv8 keypoint estimation: the stock graph with the Pose head (17 COCO
# keypoints of x, y and visibility an anchor)
YOLOV8_POSE = {
    "nc": 1,
    "kpt_shape": [17, 3],
    "scales": _SCALES,
    "backbone": _BACKBONE,
    "head": _FPN + [[[15, 18, 21], 1, "Pose", ["nc", [17, 3]]]],
}

MODELS = {
    "yolov8.yaml": YOLOV8,
    "yolov8-cls.yaml": YOLOV8_CLS,
    "yolov8-seg.yaml": YOLOV8_SEG,
    "yolov8-pose.yaml": YOLOV8_POSE,
    "yolov8ori.yaml": YOLOV8ORI,
    # layer 0 + stock YOLOv8 + Detect
    "yolov8-dedark.yaml": _variant(
        20, YOLOV8["backbone"],
        YOLOV8["head"][:12] + [[[16, 19, 22], 1, "Detect", ["nc"]]]),
    # FasterNet PConv bottlenecks throughout
    "yolov8-faster.yaml": _variant(
        20, _FASTER_BACKBONE,
        _blocks(_FPN, "FasterC2f_N") + [[[15, 18, 21], 1, "Detect", ["nc"]]]),
    # ... with two heads (P3, P4) fused by 2-level ASFF
    "yolov8-faster-twohead.yaml": _variant(
        20, _FASTER_BACKBONE,
        _blocks(_FPN[:9], "FasterC2f_N") + [
            [[18, 15], 1, "AsffDoubLevel", [0]],     # 19
            [[18, 15], 1, "AsffDoubLevel", [1]],     # 20
            [[20, 19], 1, "AsffDetect", ["nc"]]]),
    # RFB blocks on P3-P5
    "yolov8-rbf.yaml": _variant(
        20, _BACKBONE, _FPN + _RFB + [[[24, 23, 22], 1, "Detect", ["nc"]]]),
    # ... then 3-level ASFF
    "yolov8-rbf-asff.yaml": _variant(
        20, _BACKBONE, _FPN + _RFB + [
            [[24, 23, 22], 1, "AsffTribeLevel", [0]],
            [[24, 23, 22], 1, "AsffTribeLevel", [1]],
            [[24, 23, 22], 1, "AsffTribeLevel", [2]],
            [[27, 26, 25], 1, "Detect", ["nc"]]]),
    # MFRU of P5, P4, P3 joins the P3 concat; RFB; 3-level ASFF
    "yolov8-mfru-rbf-asff.yaml": _variant(
        20, _BACKBONE + [[[9, 6, 4], 1, "MFRU", ["None"]]], [
            [-2, 1, "nn.Upsample", ["None", 2, "nearest"]],   # 11 (of 9)
            [[-1, 6], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],                   # 13
            _UP,
            [[-1, 4, 10], 1, "Concat", [1]],         # 15 P3 + MFRU
            [-1, 3, "C2f", [256]],                   # 16 P3/8
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 13], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],                   # 19 P4/16
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 9], 1, "Concat", [1]],
            [-1, 3, "C2f", [1024]],                  # 22 P5/32
            [16, 1, "RFBblock", [256]],
            [19, 1, "RFBblock", [512]],
            [22, 1, "RFBblock", [512]],
            [[25, 24, 23], 1, "AsffTribeLevel", [0]],
            [[25, 24, 23], 1, "AsffTribeLevel", [1]],
            [[25, 24, 23], 1, "AsffTribeLevel", [2]],
            [[28, 27, 26], 1, "Detect", ["nc"]]]),
    # 3-level ASFF into the single-1x1 AsffDetect head
    "yolov8-asff-threehead.yaml": _variant(
        20, _BACKBONE, _FPN + [
            [[21, 18, 15], 1, "AsffTribeLevel", [0]],
            [[21, 18, 15], 1, "AsffTribeLevel", [1]],
            [[21, 18, 15], 1, "AsffTribeLevel", [2]],
            [[24, 23, 22], 1, "AsffDetect", ["nc"]]]),
    # four levels, P2/4 to P5/32
    "yolov8-p2.yaml": _variant(
        80, _BACKBONE, _FPN[:6] + [
            _UP,
            [[-1, 2], 1, "Concat", [1]],
            [-1, 3, "C2f", [128]],                   # 18 P2/4
            [-1, 1, "Conv", [128, 3, 2]],
            [[-1, 15], 1, "Concat", [1]],
            [-1, 3, "C2f", [256]],                   # 21 P3/8
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],                   # 24 P4/16
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 9], 1, "Concat", [1]],
            [-1, 3, "C2f", [1024]],                  # 27 P5/32
            [[18, 21, 24, 27], 1, "Detect", ["nc"]]]),
    # four levels, P3/8 to P6/64, C2 in the FPN
    "yolov8-p6.yaml": _variant(
        80, _BACKBONE[:7] + [
            [-1, 1, "Conv", [768, 3, 2]],
            [-1, 3, "C2f", [768, True]],             # 8 P5 tap
            [-1, 1, "Conv", [1024, 3, 2]],
            [-1, 3, "C2f", [1024, True]],
            [-1, 1, "SPPF", [1024, 5]]], [           # 11 P6 tap
            _UP,
            [[-1, 8], 1, "Concat", [1]],
            [-1, 3, "C2", [768, False]],             # 14
            _UP,
            [[-1, 6], 1, "Concat", [1]],
            [-1, 3, "C2", [512, False]],             # 17
            _UP,
            [[-1, 4], 1, "Concat", [1]],
            [-1, 3, "C2", [256, False]],             # 20 P3/8
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 17], 1, "Concat", [1]],
            [-1, 3, "C2", [512, False]],             # 23 P4/16
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 14], 1, "Concat", [1]],
            [-1, 3, "C2", [768, False]],             # 26 P5/32
            [-1, 1, "Conv", [768, 3, 2]],
            [[-1, 11], 1, "Concat", [1]],
            [-1, 3, "C2", [1024, False]],            # 29 P6/64
            [[20, 23, 26, 29], 1, "Detect", ["nc"]]]),
}

# four levels, P3/8 to P6/64, C2 in the FPN, the Pose head
MODELS["yolov8-pose-p6.yaml"] = {
    **MODELS["yolov8-p6.yaml"], "nc": 1,
    "head": MODELS["yolov8-p6.yaml"]["head"][:-1] + [
        [[20, 23, 26, 29], 1, "Pose", ["nc", [17, 3]]]]}

# the stock graph with RT-DETR's decoder head over P3-P5 (NMS-free
# queries; the head's optional args [nc, hd, nq, ndl] at their defaults)
MODELS["yolov8-rtdetr.yaml"] = {
    "nc": 80, "scales": _SCALES, "backbone": _BACKBONE,
    "head": _FPN + [[[15, 18, 21], 1, "RTDETRDecoder", ["nc"]]]}
