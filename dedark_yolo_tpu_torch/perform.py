"""The user-facing functions of the repository's root `perform.py` (reference
perform.py:19-621), on the port.

    train / train_lowght          training runs (perform.py:19, 35)
    predict                       val and its results dict (perform.py:557-592)
    calculate_detection_metrics   per-class detection and miss rates from
                                  the confusion matrix (perform.py:390-467)
    flops_params                  parameters and GFLOPs (perform.py:357-387)

`flops_params` counts parameters exactly as the JAX facade's `info` does;
its FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one
eval forward (convolutions and matmuls, two FLOPs a multiply-add), which
counts otherwise than XLA's cost analysis of the compiled graph in the root
script. `test_img`, `test_folders`, `test_video` and `onnx` need result
saving, drawing, video or export, which are not ported (ROADMAP A6b, A12):
they raise NotImplementedError.

    python -m dedark_yolo_tpu_torch.perform FUNC k=v ...   (values as JSON)
"""

from __future__ import annotations

import json
import sys

import torch

from .data.dataset import check_det_dataset
from .engine.model import YOLO
from .engine.validator import DetectionValidator
from .utils import LOGGER


def train(model_yaml="yolov8l.yaml", data="data.yaml", epochs=100, imgsz=640,
          batch=4, **kw):
    """A plain training run (reference perform.py:19-33)."""
    model = YOLO(model_yaml, device=kw.get("device"))
    return model.train(data=data, epochs=epochs, imgsz=imgsz, batch=batch,
                       lowlight_FLAG=False, dedark_FLAG=False, **kw)


def train_lowght(model_yaml="yolov8l.yaml", data="data.yaml", epochs=100,
                 imgsz=640, batch=4, dark_param=15.0, lrl=2.0, **kw):
    """Low-light training with the DeDark enhancement (reference
    perform.py:35-39)."""
    model = YOLO(model_yaml, device=kw.get("device"))
    return model.train(data=data, epochs=epochs, imgsz=imgsz, batch=batch,
                       lowlight_FLAG=True, dedark_FLAG=True,
                       dark_param=dark_param, lrl=lrl, **kw)


def predict(weights, data, imgsz=640, batch=4, **kw):
    """Validation and its results dict (reference perform.py:557-592)."""
    model = YOLO(weights, device=kw.get("device"))
    metrics = model.val(data=data, imgsz=imgsz, batch=batch, **kw)
    LOGGER.info("results: " + json.dumps(
        {k: round(float(v), 4) for k, v in metrics.items()}, indent=2))
    return metrics


def calculate_detection_metrics(weights, data, imgsz=640, batch=4,
                                save_dir="runs/detect/rates", **kw):
    """Per-class detection rate and miss rate from the confusion matrix
    (reference perform.py:390-467)."""
    model = YOLO(weights, device=kw.get("device"))
    args = model._args({"data": data, "imgsz": imgsz, "batch": batch,
                        "plots": True, **kw})
    validator = DetectionValidator(args=args, save_dir=save_dir)
    validator(model=model.model)
    rate, miss = validator.confusion_matrix.detection_rates()
    names = check_det_dataset(data)["names"]
    report = {names.get(i, str(i)): {"detection_rate": round(float(rate[i]), 4),
                                     "miss_rate": round(float(miss[i]), 4)}
              for i in range(len(rate))}
    LOGGER.info(json.dumps(report, indent=2))
    return report


def flops_params(model_yaml="yolov8l.yaml", imgsz=640, device=None):
    """(parameters, FLOPs of one eval forward at imgsz, batch 1)."""
    from torch.utils.flop_counter import FlopCounterMode
    model = YOLO(model_yaml, device=device)
    n_layers, n_params = model.info()
    img = torch.zeros((1, imgsz, imgsz, 3), device=model.device)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model.model.eval()(img)
    flops = counter.get_total_flops()
    LOGGER.info(f"layers {n_layers}  params {n_params:,}  "
                f"GFLOPs {flops / 1e9:.1f}")
    return n_params, flops


def _unported(what, item):
    raise NotImplementedError(f"{what} is not ported to dedark_yolo_tpu_torch "
                              f"(ROADMAP {item}); use the root perform.py")


def test_img(*args, **kw):
    """Needs annotated result saving (ROADMAP A6b)."""
    _unported("test_img (annotated result saving)", "A6b")


def test_folders(*args, **kw):
    """Needs annotated result saving and txt labels (ROADMAP A6b)."""
    _unported("test_folders (annotated result saving)", "A6b")


def test_video(*args, **kw):
    """Needs video sources and drawing (ROADMAP A6b)."""
    _unported("test_video (video sources and drawing)", "A6b")


def onnx(*args, **kw):
    """Needs the exporter (ROADMAP A12)."""
    _unported("onnx (export)", "A12")


FUNCTIONS = ("train", "train_lowght", "predict", "test_img", "test_video",
             "test_folders", "calculate_detection_metrics", "onnx",
             "flops_params")

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in FUNCTIONS:
        print(f"usage: python -m dedark_yolo_tpu_torch.perform "
              f"{{{','.join(FUNCTIONS)}}} k=v ...")
        raise SystemExit(1)
    kwargs = {}
    for a in sys.argv[2:]:
        k, v = a.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        kwargs[k] = v
    globals()[sys.argv[1]](**kwargs)
