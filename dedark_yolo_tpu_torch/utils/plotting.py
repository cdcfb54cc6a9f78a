"""Plots (JAX utils/plotting.py): the PR and metric-confidence curves and
the confusion matrix of val, the training curves, the train-batch mosaics
and the label-distribution plots of train, boxes and labels drawn on a
prediction, and per-layer feature grids.

matplotlib and OpenCV are imported at call time, never at import. As in
the JAX package (its HAS_MPL), a matplotlib plot draws nothing and returns
None where matplotlib is not installed; `matplotlib_available` lets a run
say so once. `plot_images` and `annotate_image` draw with OpenCV and
`feature_visualization` needs matplotlib: each raises an ImportError naming
its package where it is missing (`utils.patches.require`).
"""

from __future__ import annotations

import csv
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


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def matplotlib_available() -> bool:
    """Whether matplotlib imports on this host."""
    return _pyplot() is not None


def plot_pr_curve(px, py, ap, save_dir=Path("pr_curve.png"), names={}):
    """Single PR plot with per-class legend (fork's custom variant,
    reference metrics.py:328-389)."""
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if len(py) else np.zeros((1000, 0))
    if 0 < py.shape[1] < 21:
        for i in range(py.shape[1]):
            label = f"{names.get(i, i)} {ap[i, 0]:.3f}"
            ax.plot(px, py[:, i], linewidth=1, label=label)
    elif py.shape[1]:
        ax.plot(px, py, linewidth=1, color="grey")
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    ax.set_title("Precision-Recall Curve")
    Path(save_dir).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_dir=Path("mc_curve.png"), names={},
                  xlabel="Confidence", ylabel="Metric"):
    """Metric-confidence curve (reference metrics.py:392-415)."""
    plt = _pyplot()
    if plt is None:
        return
    from .metrics import smooth
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(py) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names.get(i, i)}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = smooth(np.asarray(py).mean(0), 0.05)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    ax.set_title(f"{ylabel}-Confidence Curve")
    Path(save_dir).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_confusion_matrix(matrix, names, save_dir=Path("confusion_matrix.png"),
                          normalize=True):
    """The (nc + 1)^2 matrix, each column normalised to its sum, with a
    background row and column."""
    plt = _pyplot()
    if plt is None:
        return
    nc = len(names)
    array = matrix / ((matrix.sum(0).reshape(1, -1) + 1e-9) if normalize else 1)
    fig, ax = plt.subplots(1, 1, figsize=(10, 8), tight_layout=True)
    im = ax.imshow(array, cmap="Blues")
    fig.colorbar(im)
    ticklabels = [names.get(i, str(i)) for i in range(nc)] + ["background"]
    ax.set_xticks(range(nc + 1))
    ax.set_yticks(range(nc + 1))
    ax.set_xticklabels(ticklabels, rotation=90)
    ax.set_yticklabels(ticklabels)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    Path(save_dir).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_results(csv_path, save_dir=None):
    """Training curves from the per-epoch results CSV, one panel a column
    against the epoch, as `results.png` (reference plotting.py:444)."""
    plt = _pyplot()
    if plt is None:
        return
    csv_path = Path(csv_path)
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    data = np.array([[float(x) for x in r] for r in rows[1:]])
    ncols = len(header) - 1
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4), tight_layout=True)
    if ncols == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        ax.plot(data[:, 0], data[:, i + 1])
        ax.set_title(header[i + 1])
        ax.set_xlabel("epoch")
    out = Path(save_dir or csv_path.parent) / "results.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_images(batch, save_path, names=None, max_images=16):
    """Mosaic of a batch's RGB images with their labels' boxes drawn, BGR
    on disk (reference plotting.py:312 plot_images)."""
    cv2 = require("cv2", "drawing a batch (plot_images)")
    imgs = batch["img"][:max_images]
    n = len(imgs)
    cols = int(np.ceil(np.sqrt(n)))
    rows_n = int(np.ceil(n / cols))
    h, w = imgs.shape[1:3]
    canvas = np.full((rows_n * h, cols * w, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        tile = imgs[i].copy()
        m = batch["mask_gt"][i] > 0
        for box, cls in zip(batch["bboxes"][i][m], batch["cls"][i][m]):
            cx, cy, bw, bh = box * [w, h, w, h]
            x1, y1 = int(cx - bw / 2), int(cy - bh / 2)
            x2, y2 = int(cx + bw / 2), int(cy + bh / 2)
            cv2.rectangle(tile, (x1, y1), (x2, y2), (255, 64, 64), 1)
            label = str((names or {}).get(int(cls), int(cls)))
            cv2.putText(tile, label, (x1, max(y1 - 2, 8)), 0, 0.4, (255, 64, 64), 1)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(save_path), canvas[..., ::-1])
    return save_path


def plot_labels(boxes, cls, names=None, save_dir=Path(".")):
    """Dataset label-distribution plots at train start (reference
    plotting.py:241-291 plot_labels): labels.jpg = class instance histogram +
    first-500 box rectangles + x/y and w/h 2D histograms;
    labels_correlogram.jpg = pairwise xywh histogram grid. Pure matplotlib.

    boxes: (n, 4) normalized xywh; cls: (n,) class indices.
    """
    plt = _pyplot()
    if plt is None:
        return
    import matplotlib.patches as mpatches
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    cls = np.asarray(cls).reshape(-1).astype(int)
    names = names or {}
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    nc = int(cls.max()) + 1 if len(cls) else 1
    cols = ["x", "y", "width", "height"]

    # correlogram: 4x4 pairwise grid, hist on the diagonal, hist2d below it
    fig, axes = plt.subplots(4, 4, figsize=(9, 9), tight_layout=True)
    for i in range(4):
        for j in range(4):
            ax = axes[i, j]
            if i == j:
                ax.hist(boxes[:, i], bins=50, color="#4c72b0")
            elif j < i:
                ax.hist2d(boxes[:, j], boxes[:, i], bins=50, cmap="Blues")
            else:
                ax.axis("off")
                continue
            if i == 3:
                ax.set_xlabel(cols[j])
            if j == 0:
                ax.set_ylabel(cols[i])
    fig.savefig(save_dir / "labels_correlogram.jpg", dpi=150)
    plt.close(fig)

    fig, axes = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = axes.ravel()
    # [0] instances per class
    ax[0].hist(cls, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    ax[0].set_ylabel("instances")
    if 0 < len(names) < 30:
        ax[0].set_xticks(range(len(names)))
        ax[0].set_xticklabels([str(names.get(i, i)) for i in range(len(names))],
                              rotation=90, fontsize=9)
    else:
        ax[0].set_xlabel("classes")
    # [1] first 500 boxes drawn centered (shape distribution at a glance)
    ax[1].axis("off")
    cmap = plt.get_cmap("tab10")
    for c, b in zip(cls[:500], boxes[:500]):
        w, h = b[2], b[3]
        ax[1].add_patch(mpatches.Rectangle(
            (0.5 - w / 2, 0.5 - h / 2), w, h, fill=False, lw=0.6,
            edgecolor=cmap(int(c) % 10)))
    ax[1].set_xlim(0, 1)
    ax[1].set_ylim(0, 1)
    # [2] center x/y density, [3] w/h density
    if len(boxes):
        ax[2].hist2d(boxes[:, 0], boxes[:, 1], bins=50, cmap="Blues")
        ax[3].hist2d(boxes[:, 2], boxes[:, 3], bins=50, cmap="Blues")
    ax[2].set_xlabel("x")
    ax[2].set_ylabel("y")
    ax[3].set_xlabel("width")
    ax[3].set_ylabel("height")
    fname = save_dir / "labels.jpg"
    fig.savefig(fname, dpi=150)
    plt.close(fig)
    return fname
