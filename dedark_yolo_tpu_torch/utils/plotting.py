"""Drawing of predictions (JAX utils/plotting.py:147-211): boxes and labels
on an image with OpenCV, per-layer feature grids with matplotlib. Both
packages are imported at call time (`utils.patches.require`)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .patches import require

PALETTE = [(56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
           (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
           (52, 147, 26), (187, 212, 0)]


def annotate_image(img_rgb, dets, names=None, line_width=None,
                   show_boxes=True, show_conf=True, show_labels=True):
    """Draw (n, 6) [xyxy, conf, cls] or (n, 7) [xyxy, track_id, conf, cls]
    detections on an RGB uint8 image; returns the RGB drawing.
    show_boxes/show_conf/show_labels are the predictor's `boxes`,
    `show_conf` and `show_labels` keys."""
    cv2 = require("cv2", "drawing detections")
    img = np.ascontiguousarray(img_rgb[..., ::-1].copy())  # to BGR for cv2
    if not show_boxes:
        return img[..., ::-1]
    lw = line_width or max(round(sum(img.shape) / 2 * 0.003), 2)
    is_track = len(dets) and len(dets[0]) == 7
    for d in dets:
        if d[-2] <= 0:
            continue
        x1, y1, x2, y2 = map(int, d[:4])
        c = int(d[-1])
        color = PALETTE[c % len(PALETTE)]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, lw)
        if not show_labels:
            continue
        label = f"{(names or {}).get(c, c)}"
        if show_conf:
            label += f" {d[-2]:.2f}"
        if is_track:
            label = f"id:{int(d[4])} " + label
        tf = max(lw - 1, 1)
        w, h = cv2.getTextSize(label, 0, lw / 3, tf)[0]
        cv2.rectangle(img, (x1, y1), (x1 + w, y1 - h - 3), color, -1)
        cv2.putText(img, label, (x1, y1 - 2), 0, lw / 3, (255, 255, 255), tf)
    return img[..., ::-1]


def feature_visualization(caps, save_dir, max_channels=32):
    """Each captured (1, H, W, C) activation of {layer: array} as a
    grayscale grid of its first `max_channels` channels,
    `save_dir/stage{i}_features.png`."""
    matplotlib = require("matplotlib", "drawing feature maps (visualize)")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for i, act in sorted(caps.items()):
        a = np.asarray(act)
        if a.ndim != 4:
            continue
        a = a[0]                                   # (H, W, C)
        n = min(max_channels, a.shape[-1])
        cols = min(8, n)
        rows = int(np.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.3, rows * 1.3),
                                 squeeze=False, tight_layout=True)
        for j, ax in enumerate(axes.ravel()):
            ax.axis("off")
            if j < n:
                ax.imshow(a[..., j], cmap="gray")
        fig.suptitle(f"layer {i} {a.shape[0]}x{a.shape[1]}x{act.shape[-1]}")
        fig.savefig(save_dir / f"stage{i}_features.png", dpi=90)
        plt.close(fig)
