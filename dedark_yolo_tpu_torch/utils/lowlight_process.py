"""Offline low-light synthesis, the fork's 'lowlight_maker' (JAX
utils/lowlight_process.py): gamma-crush every image of a directory with
`img ** lowlight_param` on the device and write it under the same relative
path, as the fork makes its dark val split (`images/test_dark`).

Two layers: `lowlight_batches`, the array core (uint8 HWC images in,
uint8 out, grouped by shape in first-seen order and degraded `batch_size`
at a time on the device by `degrade_u8`), and `apply_lowlight_and_save`,
the files around it, read and written through OpenCV (`utils.patches`).
The device is the card unless the caller passes `device="cpu"`; without a
card that raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.degrade import lowlight_degrade
from . import LOGGER
from .patches import imread, imwrite


def group_by_shape(images):
    """{shape: [index, ...]} of a list of arrays, shapes in first-seen
    order."""
    groups = {}
    for i, im in enumerate(images):
        groups.setdefault(im.shape, []).append(i)
    return groups


def degrade_u8(x, lowlight_param):
    """A uint8 batch degraded on its device: divided by 255 in f32,
    `lowlight_degrade`, then quantised as `(clip(out, 0, 1) * 255)`
    truncated to uint8, as the JAX tool does on the host."""
    y = lowlight_degrade(x.float() / 255.0, lowlight_param)
    return (y.clamp(0.0, 1.0) * 255).to(torch.uint8)


def lowlight_batches(images, lowlight_param=7.5, batch_size=16, device=None):
    """The degraded uint8 copy of each uint8 HWC image, in input order:
    each batch stacked on the host, uploaded as uint8, `degrade_u8`, read
    back."""
    from ..engine.predictor import resolve_device
    dev = resolve_device(device)
    out = [None] * len(images)
    for idxs in group_by_shape(images).values():
        for i in range(0, len(idxs), batch_size):
            chunk = idxs[i:i + batch_size]
            x = torch.from_numpy(np.stack([images[k] for k in chunk])).to(dev)
            for k, im in zip(chunk, degrade_u8(x, lowlight_param).cpu().numpy()):
                out[k] = im
    return out


def apply_lowlight_and_save(src_dir, dst_dir, lowlight_param=7.5,
                            batch_size=16, device=None):
    """Degrade every image under src_dir (recursively) into dst_dir at the
    same relative path; returns the number written. Unreadable files are
    skipped with a log line; no image at all raises FileNotFoundError."""
    from ..data.dataset import IMG_FORMATS
    src_dir, dst_dir = Path(src_dir), Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(f for f in src_dir.rglob("*")
                   if f.suffix.lower() in IMG_FORMATS)
    if not files:
        raise FileNotFoundError(f"no images in {src_dir}")
    read, images = [], []
    for f in files:
        img = imread(f)
        if img is None:
            LOGGER.info(f"skipping unreadable image {f}")
            continue
        read.append(f)
        images.append(img)
    dark = lowlight_batches(images, lowlight_param, batch_size, device)
    for idxs in group_by_shape(images).values():   # the JAX tool's order
        for k in idxs:
            dst = dst_dir / read[k].relative_to(src_dir)
            dst.parent.mkdir(parents=True, exist_ok=True)
            imwrite(dst, dark[k])
    LOGGER.info(f"wrote {len(read)} degraded images (param={lowlight_param}) "
                f"to {dst_dir}")
    return len(read)
