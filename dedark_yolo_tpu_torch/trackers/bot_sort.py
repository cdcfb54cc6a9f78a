"""BoT-SORT tracker: ByteTrack + camera-motion compensation + an XYWH
Kalman filter (a copy of JAX trackers/bot_sort.py; host numpy).

The additions over BYTETracker: a Kalman filter in [x, y, w, h] (extent-
scaled noise on both axes), an IoU proximity gate on stage-1 matches, and
global motion compensation by sparse optical flow, which warps the
predicted track means by the estimated inter-frame camera affine (OpenCV,
imported when a frame needs it, through `utils.patches.require`; with
`gmc_method: none` no OpenCV is needed). ReID embeddings (`with_reid`) are
not implemented, as in JAX: the flag is accepted and warned about.
"""

from __future__ import annotations

import numpy as np

from ..utils import LOGGER
from ..utils.patches import require
from .byte_tracker import BYTETracker, STrack, iou_matrix
from .kalman import KalmanFilterXYWH


class GMC:
    """Global (camera) motion compensation between consecutive frames.

    method 'sparseOptFlow': track Shi-Tomasi corners with pyramidal
    Lucas-Kanade and fit a partial 2D affine; 'none' disables compensation.
    Frames are downscaled 2x for corner detection — the affine is estimated
    in, and applied to, full-resolution coordinates.
    """

    def __init__(self, method="sparseOptFlow", downscale=2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self._prev = None

    def apply(self, img):
        """img: BGR or gray uint8 frame. Returns a 2x3 affine H mapping
        previous-frame coords to current-frame coords (identity on the first
        frame, on failure, or when disabled)."""
        eye = np.eye(2, 3, dtype=np.float64)
        if self.method in (None, "none") or img is None:
            return eye
        cv2 = require("cv2", "BoT-SORT's sparseOptFlow motion compensation")
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
        if self.downscale > 1:
            gray = cv2.resize(gray, (gray.shape[1] // self.downscale,
                                     gray.shape[0] // self.downscale))
        if self._prev is None:
            self._prev = gray
            return eye
        pts = cv2.goodFeaturesToTrack(self._prev, maxCorners=200,
                                      qualityLevel=0.01, minDistance=8)
        H = eye
        if pts is not None and len(pts) >= 4:
            nxt, ok, _ = cv2.calcOpticalFlowPyrLK(self._prev, gray, pts, None)
            ok = ok.reshape(-1).astype(bool)
            if ok.sum() >= 4:
                m, _ = cv2.estimateAffinePartial2D(pts[ok], nxt[ok],
                                                   method=cv2.RANSAC)
                if m is not None:
                    H = m.astype(np.float64)
                    # scale translation back to full resolution
                    H[:, 2] *= self.downscale
        self._prev = gray
        return H

    def reset(self):
        self._prev = None


class BSTrack(STrack):
    """STrack measured in xywh instead of xyah."""

    def to_measurement(self, tlwh):
        x, y, w, h = tlwh
        return np.asarray([x + w / 2, y + h / 2, w, h])

    def from_state(self):
        cx, cy, w, h = self.mean[:4]
        return np.asarray([cx - w / 2, cy - h / 2, w, h])


class BOTSORT(BYTETracker):
    track_cls = BSTrack

    def __init__(self, args, frame_rate=30):
        super().__init__(args, frame_rate)
        self.gmc = GMC(getattr(args, "gmc_method", "sparseOptFlow"))
        self.proximity_thresh = getattr(args, "proximity_thresh", 0.5)
        if getattr(args, "with_reid", False):
            LOGGER.warning(
                "BoT-SORT with_reid=True requested but no ReID model is "
                "available (the reference ships none); tracking "
                "with motion-only association.")

    def _make_kf(self):
        return KalmanFilterXYWH()

    def reset(self):
        super().reset()
        self.gmc.reset()

    def _gmc_apply(self, img, pool):
        H = self.gmc.apply(img)
        if np.allclose(H, np.eye(2, 3)) or not pool:
            return
        R, t = H[:2, :2], H[:2, 2]
        for tr in pool:
            if tr.mean is None:
                continue
            # rotate/scale the center and extents, translate the center
            tr.mean[:2] = R @ tr.mean[:2] + t
            s = float(np.sqrt(abs(np.linalg.det(R))))
            tr.mean[2:4] *= s
            tr.mean[4:6] = R @ tr.mean[4:6]
            tr.cov[:2, :2] = R @ tr.cov[:2, :2] @ R.T

    def _dists(self, tracks, dets):
        """BoT-SORT gates stage-1 candidates by raw IoU proximity before the
        score fuse: far-apart pairs are forbidden outright."""
        iou = iou_matrix([t.xyxy for t in tracks], [t.xyxy for t in dets])
        d = 1.0 - iou
        d[iou < self.proximity_thresh] = 1.0 + 1e-6  # above any match gate
        if len(tracks) and len(dets):
            scores = np.asarray([t.score for t in dets])[None, :]
            fused = 1.0 - (1.0 - d) * scores
            d = np.where(iou < self.proximity_thresh, d, fused)
        return d
