"""Multi-object tracking, the `YOLO.track` surface (JAX trackers/__init__.py).

Detection runs batched on the device through the predictor's stream; the
tracker consumes the streamed Results in frame order on the host and
stamps track ids into a 7th box column. `make_tracker(name)` takes a
built-in choice (`bytetrack.yaml`, `botsort.yaml`: `cfg/trackers.py`) or a
tracker file on disk (`.json`, or yaml through PyYAML), checks its
`tracker_type` and returns a ready tracker.
"""

from __future__ import annotations

import copy
from pathlib import Path
from types import SimpleNamespace

from ..cfg import yaml_load
from ..cfg.trackers import TRACKERS
from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_TYPES = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def load_tracker_cfg(name):
    """'bytetrack.yaml' / 'botsort' / a tracker file's path -> a
    SimpleNamespace of tracker args. A file on disk wins over the built-in
    choice of the same name, as in JAX."""
    p = Path(str(name))
    if not p.suffix:
        p = p.with_suffix(".yaml")
    if p.is_file():
        cfg = yaml_load(p)
    elif p.name in TRACKERS:
        cfg = copy.deepcopy(TRACKERS[p.name])
    else:
        raise FileNotFoundError(
            f"tracker config '{name}' not found; choices: {sorted(TRACKERS)} "
            "or a tracker file")
    if cfg.get("tracker_type") not in TRACKER_TYPES:
        raise ValueError(
            f"tracker_type must be one of {sorted(TRACKER_TYPES)}, got "
            f"{cfg.get('tracker_type')!r} in {p}")
    return SimpleNamespace(**cfg)


def make_tracker(name, frame_rate=30):
    cfg = load_tracker_cfg(name)
    return TRACKER_TYPES[cfg.tracker_type](cfg, frame_rate=frame_rate)


def track_results(results_iter, tracker, persist_between_sources=False):
    """Wrap a streaming Results iterator with tracking (the reference's
    on_predict_postprocess_end callback).

    Each Results' boxes become (m, 7) [x1, y1, x2, y2, track_id, conf, cls].
    The tracker resets when the source path changes (a new video or
    sequence) unless persist_between_sources.
    """
    last_path = None
    for res in results_iter:
        if (last_path is not None and res.path != last_path
                and not persist_between_sources):
            tracker.reset()
        last_path = res.path
        b = res.boxes
        # explicit column selection: re-tracking tracked output drops the
        # id column rather than misreading it as a coordinate
        dets = b.data[:, [0, 1, 2, 3, 5, 6]] if b.is_track else b.data
        tracks = tracker.update(dets, img=res.orig_img[..., ::-1])
        res.update_tracks(tracks)
        yield res
