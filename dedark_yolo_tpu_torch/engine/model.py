"""YOLO facade (JAX engine/model.py): build a model, load weights, predict.

YOLO("yolov8l.yaml", nc=3) builds the architecture with seeded random
weights on `device` (None means cuda, and raises without a CUDA device).
"""

from __future__ import annotations

import torch

from ..cfg import get_cfg, model_yaml_load
from ..nn.enhance import LowlightRecovery
from ..nn.graph import DetectionModel
from ..utils.weights import init_weights
from .predictor import DetectionPredictor, resolve_device


class YOLO:
    def __init__(self, model="yolov8l.yaml", nc=None, device=None, seed=0):
        self.device = resolve_device(device)
        self.model_yaml = model_yaml_load(model)
        with torch.device("meta"):
            net = DetectionModel(self.model_yaml, nc=nc)
        self.model = net.to_empty(device=self.device).eval()
        init_weights(self.model, seed)
        self.predictor = None

    def state_dict(self):
        return self.model.state_dict()

    def load_state_dict(self, state_dict, strict=True):
        return self.model.load_state_dict(state_dict, strict=strict)

    def predict(self, source, **kwargs):
        """Detections for every image of `source` (array, file, or list).

        kwargs are predict config keys (cfg.DEFAULT_CFG); device None means
        cuda. The model moves to the predict device.
        """
        args = get_cfg(kwargs)
        # contrast_mode changes the filter math, not the params (JAX
        # engine/model.py _sync_model_opts rebuilds the graph for it)
        for m in self.model.modules():
            if isinstance(m, LowlightRecovery):
                m.contrast_mode = args.contrast_mode
        self.predictor = DetectionPredictor(args=args, model=self.model,
                                            names=self.model.names)
        self.device = self.predictor.device
        return self.predictor(source)
