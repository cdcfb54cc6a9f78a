"""Tracker settings as Python data (copies of the JAX package's
`cfg/trackers/botsort.yaml` and `bytetrack.yaml`), so `track` needs no
YAML parser for the built-in choices; keyed by file name, as the config's
`tracker` key names them."""

from __future__ import annotations

_BYTETRACK = {
    "tracker_type": "bytetrack",
    "track_high_thresh": 0.5,   # first-stage association: detections above this
    "track_low_thresh": 0.1,    # second-stage floor: below this is discarded
    "new_track_thresh": 0.6,    # unmatched detections above this start new tracks
    "track_buffer": 30,         # frames a lost track survives before removal
    "match_thresh": 0.8,        # stage-1 gate on the fused (1 - IoU*score) cost
}

TRACKERS = {
    "bytetrack.yaml": _BYTETRACK,
    "botsort.yaml": {
        **_BYTETRACK,
        "tracker_type": "botsort",
        "gmc_method": "sparseOptFlow",  # camera-motion compensation: sparseOptFlow | none
        "proximity_thresh": 0.5,        # least raw IoU of a stage-1 candidate pair
        "appearance_thresh": 0.25,      # reserved (ReID); accepted, unused
        "with_reid": False,             # no ReID model is available
    },
}
