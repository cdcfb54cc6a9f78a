"""Model architectures as Python data (copies of the JAX package's model yamls).

The same `[from, repeats, module, args]` rows as `cfg/models/yolov8.yaml` and
`cfg/models/yolov8ori.yaml`, kept as dicts so the port needs no YAML parser to
build its models. Keyed by the unified file name that `model_yaml_load`
resolves a scaled name such as `yolov8l.yaml` to.
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

MODELS = {"yolov8.yaml": YOLOV8, "yolov8ori.yaml": YOLOV8ORI}
