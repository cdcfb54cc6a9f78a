"""BYTETracker: two-stage tracking-by-detection association (a copy of
JAX trackers/byte_tracker.py; host numpy in both packages).

The ByteTrack algorithm (Zhang et al. 2022): every frame, high-score
detections are matched to the predicted tracks by IoU fused with the
score, then the low-score detections get a second chance against the
still-unmatched tracks, which keeps ids alive through partial occlusions
and motion blur. Detection runs batched on the device through the
predictor; this is the small sequential tail on the host.
"""

from __future__ import annotations

import numpy as np

from .kalman import KalmanFilterXYAH


# track lifecycle states
NEW, TRACKED, LOST, REMOVED = 0, 1, 2, 3


def iou_matrix(a, b):
    """Pairwise IoU of (N,4) and (M,4) xyxy boxes -> (N, M) float32."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    a = np.asarray(a, np.float32)[:, None, :]   # (N,1,4)
    b = np.asarray(b, np.float32)[None, :, :]   # (1,M,4)
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.clip(area_a + area_b - inter, 1e-9, None)


def linear_assignment(cost, thresh):
    """Min-cost matching with a per-pair gate: pairs costing > thresh are
    forbidden. Returns (matches list[(i,j)], unmatched_a, unmatched_b)."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    from scipy.optimize import linear_sum_assignment
    # gate by pushing forbidden pairs far above any feasible total
    gated = np.where(cost > thresh, thresh + 1e5, cost)
    rows, cols = linear_sum_assignment(gated)
    matches = [(int(r), int(c)) for r, c in zip(rows, cols)
               if cost[r, c] <= thresh]
    mr = {r for r, _ in matches}
    mc = {c for _, c in matches}
    return (matches,
            [i for i in range(cost.shape[0]) if i not in mr],
            [j for j in range(cost.shape[1]) if j not in mc])


class STrack:
    """One tracked object: Kalman state + lifecycle bookkeeping. Track ids
    are allocated by the owning tracker (per-instance, so concurrent streams
    have independent, deterministic id spaces)."""

    def __init__(self, xyxy, score, cls, det_idx):
        x1, y1, x2, y2 = map(float, xyxy)
        self._tlwh = np.asarray([x1, y1, x2 - x1, y2 - y1], np.float64)
        self.score = float(score)
        self.cls = float(cls)
        self.det_idx = int(det_idx)
        self.state = NEW
        self.is_activated = False
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.mean = None
        self.cov = None
        self.kf = None

    # -- box representations --------------------------------------------------
    def to_measurement(self, tlwh):
        """tlwh -> the filter's measurement space (xyah here)."""
        x, y, w, h = tlwh
        return np.asarray([x + w / 2, y + h / 2, w / max(h, 1e-9), h])

    def from_state(self):
        """Filter state -> tlwh."""
        cx, cy, a, h = self.mean[:4]
        w = a * h
        return np.asarray([cx - w / 2, cy - h / 2, w, h])

    @property
    def tlwh(self):
        return self._tlwh if self.mean is None else self.from_state()

    @property
    def xyxy(self):
        t = self.tlwh
        return np.asarray([t[0], t[1], t[0] + t[2], t[1] + t[3]])

    # -- lifecycle -------------------------------------------------------------
    def activate(self, kf, frame_id, track_id):
        self.kf = kf
        self.track_id = track_id
        self.mean, self.cov = kf.initiate(self.to_measurement(self._tlwh))
        self.state = TRACKED
        self.frame_id = self.start_frame = frame_id
        self.is_activated = frame_id == 1  # first frame: no confirmation lag

    def mark_lost(self):
        self.state = LOST

    def mark_removed(self):
        self.state = REMOVED


class BYTETracker:
    """Per-stream tracker; call `update(dets)` once per frame in order.

    Args come from a tracker yaml (cfg/trackers/bytetrack.yaml):
    track_high_thresh / track_low_thresh split detections into the two
    association stages; new_track_thresh gates track births; track_buffer is
    how many frames a lost track survives; match_thresh gates stage-1 IoU.
    """

    track_cls = STrack

    def __init__(self, args, frame_rate=30):
        self.args = args
        self.kf = self._make_kf()
        self.tracked: list[STrack] = []
        self.lost: list[STrack] = []
        self.removed: list[STrack] = []
        self.frame_id = 0
        self._id = 0
        self.max_time_lost = int(frame_rate / 30.0 * args.track_buffer)

    def _make_kf(self):
        return KalmanFilterXYAH()

    def next_id(self):
        self._id += 1
        return self._id

    def reset(self):
        self.tracked, self.lost, self.removed = [], [], []
        self.frame_id = 0
        self._id = 0

    # hooks BoT-SORT overrides ------------------------------------------------
    def _gmc_apply(self, img, pool):
        pass  # camera-motion compensation (BoT-SORT only)

    def _dists(self, tracks, dets):
        """Stage-1 cost: 1 - IoU, fused with detection score so a confident
        overlapping detection wins over a hesitant one."""
        d = 1.0 - iou_matrix([t.xyxy for t in tracks],
                             [t.xyxy for t in dets])
        if len(tracks) and len(dets):
            scores = np.asarray([t.score for t in dets])[None, :]
            d = 1.0 - (1.0 - d) * scores
        return d

    def update(self, dets, img=None):
        """dets: (n, 6) [x1,y1,x2,y2,conf,cls] for ONE frame (native pixels).

        Returns (m, 8) [x1,y1,x2,y2,track_id,conf,cls,det_idx] for currently
        activated tracks; det_idx indexes into THIS frame's input rows (-1 for
        tracks coasting on prediction alone — not emitted by default).
        """
        self.frame_id += 1
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        scores = dets[:, 4]
        hi = scores >= self.args.track_high_thresh
        lo = (scores >= self.args.track_low_thresh) & ~hi
        d_hi = [self.track_cls(d[:4], d[4], d[5], i)
                for i, d in enumerate(dets) if hi[i]]
        d_lo = [self.track_cls(d[:4], d[4], d[5], i)
                for i, d in enumerate(dets) if lo[i]]

        # split current tracks into confirmed pool + unconfirmed (1-frame-old)
        unconfirmed = [t for t in self.tracked if not t.is_activated]
        confirmed = [t for t in self.tracked if t.is_activated]
        pool = confirmed + self.lost

        # predict everyone forward one frame (vectorized), then compensate
        # camera motion if the subclass does that
        if pool:
            means = np.stack([t.mean for t in pool])
            covs = np.stack([t.cov for t in pool])
            means, covs = self.kf.multi_predict(means, covs)
            for t, m, c in zip(pool, means, covs):
                t.mean, t.cov = m, c
        self._gmc_apply(img, pool + unconfirmed)

        # matched (track, det) KF updates are DEFERRED and applied as one
        # stacked multi_update after all three association stages — each
        # track matches at most once and matching uses the predicted (not
        # updated) states, so deferral is semantics-preserving while turning
        # N Python-level 8x8 updates into one batched solve
        pending = []  # (track, det)

        # stage 1: high-score detections vs confirmed+lost tracks
        dists = self._dists(pool, d_hi)
        matches, u_track, u_det = linear_assignment(
            dists, self.args.match_thresh)
        activated, refind = [], []
        for it, idet in matches:
            t, d = pool[it], d_hi[idet]
            pending.append((t, d))
            (activated if t.state == TRACKED else refind).append(t)

        # stage 2: low-score detections vs tracks still TRACKED (ByteTrack's
        # core trick — occluded objects keep their ID through confidence dips)
        remain = [pool[i] for i in u_track if pool[i].state == TRACKED]
        d2 = 1.0 - iou_matrix([t.xyxy for t in remain],
                              [t.xyxy for t in d_lo])
        matches, u_remain, _ = linear_assignment(d2, 0.5)
        for it, idet in matches:
            pending.append((remain[it], d_lo[idet]))
            activated.append(remain[it])
        for i in u_remain:
            remain[i].mark_lost()
        lost_now = [t for t in remain if t.state == LOST]

        # unconfirmed tracks get one strict shot at the leftover high dets
        left_hi = [d_hi[i] for i in u_det]
        d3 = self._dists(unconfirmed, left_hi)
        matches, u_unconf, u_det2 = linear_assignment(d3, 0.7)
        for it, idet in matches:
            pending.append((unconfirmed[it], left_hi[idet]))
            activated.append(unconfirmed[it])
        for i in u_unconf:
            unconfirmed[i].mark_removed()
            self.removed.append(unconfirmed[i])

        # births
        for i in u_det2:
            d = left_hi[i]
            if d.score >= self.args.new_track_thresh:
                d.activate(self.kf, self.frame_id, self.next_id())
                activated.append(d)

        # apply the deferred updates in one stacked solve
        if pending:
            means = np.stack([t.mean for t, _ in pending])
            covs = np.stack([t.cov for t, _ in pending])
            meas = np.stack([t.to_measurement(d._tlwh) for t, d in pending])
            means, covs = self.kf.multi_update(means, covs, meas)
            for (t, d), m, c in zip(pending, means, covs):
                t.mean, t.cov = m, c
                t.state = TRACKED
                t.is_activated = True
                t.frame_id = self.frame_id
                t.score, t.cls, t.det_idx = d.score, d.cls, d.det_idx

        # expire stale lost tracks
        for t in self.lost:
            if self.frame_id - t.frame_id > self.max_time_lost:
                t.mark_removed()
                self.removed.append(t)

        # rebuild the lists (identity set: O(n) instead of O(n^2) scans)
        self.tracked = [t for t in self.tracked if t.state == TRACKED]
        cur = set(map(id, self.tracked))
        for t in activated + refind:
            if id(t) not in cur:
                self.tracked.append(t)
                cur.add(id(t))
        self.lost = [t for t in self.lost
                     if t.state == LOST] + [t for t in lost_now
                                            if t.state == LOST]
        self.removed = self.removed[-100:]  # bounded history

        out = [np.concatenate([t.xyxy, [t.track_id, t.score, t.cls,
                                        t.det_idx]])
               for t in self.tracked if t.is_activated
               and t.frame_id == self.frame_id]
        return (np.stack(out).astype(np.float32) if out
                else np.zeros((0, 8), np.float32))
