"""The user-facing functions of the repository's root `perform.py` (reference
perform.py:19-621), on the port.

    train / train_lowght          training runs (perform.py:19, 35)
    predict                       val and its results dict (perform.py:557-592)
    calculate_detection_metrics   per-class detection and miss rates from
                                  the confusion matrix (perform.py:390-467)
    flops_params                  parameters and GFLOPs (perform.py:357-387)

    test_img / test_folders       predict with annotated images, txt
                                  labels and a stats JSON (perform.py:55-288)
    test_video                    an annotated video, frame by frame
                                  (perform.py:72-106)
    onnx                          an export (perform.py:41-53)

`flops_params` counts parameters exactly as the JAX facade's `info` does;
its FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one
eval forward (convolutions and matmuls, two FLOPs a multiply-add), which
counts otherwise than XLA's cost analysis of the compiled graph in the root
script. `test_img`, `test_folders` and `test_video` draw and encode through
OpenCV. `onnx` exports (default format pt2, `engine/exporter.py`).

    python -m dedark_yolo_tpu_torch.perform FUNC k=v ...   (values as JSON)
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .data.dataset import check_det_dataset
from .engine.model import YOLO
from .engine.validator import DetectionValidator
from .utils import LOGGER
from .utils.patches import require


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


def test_img(weights, img_path, imgsz=640, conf=0.4,
             save_dir="runs/detect/test_img", device=None):
    """One image's (or a source's) predict with the annotated output saved
    under save_dir/predict* (reference perform.py:55-77)."""
    model = YOLO(weights, device=device)
    results = model.predict(img_path, imgsz=imgsz, conf=conf, save=True,
                            project=save_dir, device=device)
    for r in results:
        LOGGER.info(f"{r.path}: {len(r)} detections")
    return results


def test_video(weights, video, imgsz=640, conf=0.4, output=None, fps=None,
               line_width=3, show=False, device=None):
    """An annotated copy of a video, frame by frame (reference
    perform.py:72-106: VideoCapture -> model(frame) -> plot(line_width=3)
    -> VideoWriter, XVID), with the frame's FPS drawn at the top left;
    `show` gates the window. The frames are written as `plot` returns them
    (RGB), as the root script does. Returns the output path."""
    cv2 = require("cv2", "test_video")
    model = YOLO(weights, device=device)
    path = Path(video)
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        LOGGER.error(f"Error: Could not open video {path}.")
        return None
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    out_path = Path(output) if output else Path(f"{path.stem}_output.mp4")
    out = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"XVID"),
                          fps or cap.get(cv2.CAP_PROP_FPS) or 40, size)
    n, t_total = 0, 0.0
    try:
        while cap.isOpened():
            ret, frame = cap.read()
            if not ret:
                break
            t0 = time.time()
            res = model(frame, imgsz=imgsz, conf=conf, verbose=False,
                        device=device)
            dt = time.time() - t0
            n, t_total = n + 1, t_total + dt
            ann = np.ascontiguousarray(res[0].plot(line_width=line_width))
            cv2.putText(ann, f"{1.0 / dt:.1f} FPS", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
            out.write(ann)
            if show:
                cv2.imshow("yolo", ann)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        if show:
            cv2.destroyAllWindows()
        cap.release()
        out.release()
    LOGGER.info(f"{n} frames -> {out_path} ({n / t_total:.1f} FPS avg)"
                if n else "no frames read")
    return out_path


def test_folders(weights, folder, imgsz=640, conf=0.4, batch=8,
                 save_dir="runs/detect/test_folders", device=None):
    """Predict over a directory: annotated images, txt labels and
    save_dir/detection_stats.json with the FPS and the detections per class
    (reference perform.py:107-288). Returns the stats."""
    model = YOLO(weights, device=device)
    t0 = time.time()
    results = model.predict(folder, imgsz=imgsz, conf=conf, batch=batch,
                            save=True, save_txt=True, project=save_dir,
                            device=device)
    dt = time.time() - t0
    n = len(results)
    per_class = {}
    for r in results:
        for c in r.boxes.cls.astype(int):
            name = r.names.get(int(c), str(int(c)))
            per_class[name] = per_class.get(name, 0) + 1
    stats = {"images": n, "seconds": round(dt, 3),
             "fps": round(n / dt, 2) if dt else None,
             "detections_per_class": per_class}
    out = Path(save_dir) / "detection_stats.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(stats, indent=2))
    LOGGER.info(f"stats -> {out}: {stats}")
    return stats


def onnx(weights, imgsz=640, fmt="pt2", device=None):
    """Export (reference perform.py:41-53 exports ONNX; the root perform.py
    exports StableHLO, the port its torch.export artifact); returns the
    path. fmt='onnx' raises through the exporter's guard."""
    return YOLO(weights, device=device).export(format=fmt, imgsz=imgsz,
                                               device=device)


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
