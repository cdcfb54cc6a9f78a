"""Constant-velocity Kalman filters for multi-object tracking (a copy of
JAX trackers/kalman.py; host numpy in both packages).

The standard ByteTrack formulation: an 8-dim constant-velocity state
observed by its first four coordinates, with measurement and process noise
scaled by box height (XYAH) or by both extents (XYWH, the BoT-SORT
variant). Association runs on the host between frames, sequential and
small (a few matrices under 100x100 a frame), while detection runs batched
on the device. `multi_predict` and `multi_update` are vectorized over
tracks, so a frame costs O(1) numpy calls, not O(tracks).
"""

from __future__ import annotations

import numpy as np

_chi2inv95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
              6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """State [x, y, a, h, vx, vy, va, vh]; a = aspect ratio w/h.

    Noise scales follow the widely-used ByteTrack constants:
    position sigma = h/20 per frame, velocity sigma = h/160.
    """

    ndim = 4

    def __init__(self):
        self._F = np.eye(8, dtype=np.float64)
        self._F[:4, 4:] = np.eye(4)
        self._H = np.eye(4, 8, dtype=np.float64)
        self._wp = 1.0 / 20  # position noise weight
        self._wv = 1.0 / 160  # velocity noise weight

    # -- noise scale vectors (subclasses change the aspect slot) -------------
    def _init_std(self, m):
        return np.asarray(
            [2 * self._wp * m[3], 2 * self._wp * m[3], 1e-2,
             2 * self._wp * m[3],
             10 * self._wv * m[3], 10 * self._wv * m[3], 1e-5,
             10 * self._wv * m[3]])

    def _predict_std(self, mean):
        h = mean[..., 3]
        pos = np.stack([self._wp * h, self._wp * h,
                        np.full_like(h, 1e-2), self._wp * h], -1)
        vel = np.stack([self._wv * h, self._wv * h,
                        np.full_like(h, 1e-5), self._wv * h], -1)
        return pos, vel

    def _project_std(self, mean):
        h = mean[3]
        return np.asarray([self._wp * h, self._wp * h, 1e-1, self._wp * h])

    # -- filter steps ---------------------------------------------------------
    def initiate(self, measurement):
        """New track from an unassociated measurement -> (mean(8), cov(8,8))."""
        mean = np.zeros(8)
        mean[:4] = measurement
        std = self._init_std(measurement)
        return mean, np.diag(std * std)

    def predict(self, mean, cov):
        pos, vel = self._predict_std(mean)
        q = np.concatenate([pos, vel]) ** 2
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + np.diag(q)
        return mean, cov

    def multi_predict(self, means, covs):
        """Vectorized predict over N tracks: (N,8), (N,8,8) -> same shapes."""
        if len(means) == 0:
            return means, covs
        pos, vel = self._predict_std(means)
        q = np.concatenate([pos, vel], -1) ** 2          # (N, 8)
        means = means @ self._F.T
        covs = self._F @ covs @ self._F.T                # broadcast over N
        covs = covs + q[:, :, None] * np.eye(8)
        return means, covs

    def project(self, mean, cov):
        std = self._project_std(mean)
        return (self._H @ mean,
                self._H @ cov @ self._H.T + np.diag(std * std))

    def update(self, mean, cov, measurement):
        pm, pc = self.project(mean, cov)
        # K = cov H' (H cov H' + R)^-1 via Cholesky solve
        chol = np.linalg.cholesky(pc)
        k = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (cov @ self._H.T).T)).T
        innov = measurement - pm
        return mean + k @ innov, cov - k @ pc @ k.T

    def _project_std_batch(self, means):
        """(N,8) means -> (N,4) measurement-noise stds (vectorized
        counterpart of _project_std)."""
        h = means[:, 3]
        return np.stack([self._wp * h, self._wp * h,
                         np.full_like(h, 1e-1), self._wp * h], -1)

    def multi_update(self, means, covs, measurements):
        """Vectorized update over N tracks: (N,8), (N,8,8), (N,4) -> same.
        One stacked Cholesky/solve instead of N Python-level 8x8 updates —
        the dominant cost of the per-frame tracker tail at high counts."""
        if len(means) == 0:
            return means, covs
        pm = means @ self._H.T                                   # (N,4)
        std = self._project_std_batch(means)
        pc = (self._H @ covs @ self._H.T
              + std[:, :, None] * np.eye(4) * std[:, None, :])   # diag(std^2)
        chol = np.linalg.cholesky(pc)
        covHT = covs @ self._H.T                                 # (N,8,4)
        # K^T = pc^-1 (cov H')^T via two stacked triangular-ish solves
        kt = np.linalg.solve(
            np.transpose(chol, (0, 2, 1)),
            np.linalg.solve(chol, np.transpose(covHT, (0, 2, 1))))
        k = np.transpose(kt, (0, 2, 1))                          # (N,8,4)
        innov = measurements - pm
        new_means = means + np.einsum("nij,nj->ni", k, innov)
        new_covs = covs - k @ pc @ np.transpose(k, (0, 2, 1))
        return new_means, new_covs

    def gating_distance(self, mean, cov, measurements, only_position=False):
        """Squared Mahalanobis distance of measurements (M,4) to the projected
        state; compare against _chi2inv95[4] (or [2]) to gate.

        NOT used by the built-in ByteTrack/BoT-SORT association (both gate on
        IoU, as their published algorithms do) — this is public API for
        custom trackers (e.g. a DeepSORT-style motion gate)."""
        pm, pc = self.project(mean, cov)
        if only_position:
            pm, pc = pm[:2], pc[:2, :2]
            measurements = measurements[:, :2]
        chol = np.linalg.cholesky(pc)
        z = np.linalg.solve(chol, (measurements - pm).T)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State [x, y, w, h, ...]: BoT-SORT's variant where the third slot is a
    pixel extent too, so it gets the same h-scaled noise as the others."""

    def _init_std(self, m):
        s = 2 * self._wp
        v = 10 * self._wv
        return np.asarray([s * m[2], s * m[3], s * m[2], s * m[3],
                           v * m[2], v * m[3], v * m[2], v * m[3]])

    def _predict_std(self, mean):
        w, h = mean[..., 2], mean[..., 3]
        pos = np.stack([self._wp * w, self._wp * h,
                        self._wp * w, self._wp * h], -1)
        vel = np.stack([self._wv * w, self._wv * h,
                        self._wv * w, self._wv * h], -1)
        return pos, vel

    def _project_std(self, mean):
        w, h = mean[2], mean[3]
        return np.asarray([self._wp * w, self._wp * h,
                           self._wp * w, self._wp * h])

    def _project_std_batch(self, means):
        w, h = means[:, 2], means[:, 3]
        return np.stack([self._wp * w, self._wp * h,
                         self._wp * w, self._wp * h], -1)
