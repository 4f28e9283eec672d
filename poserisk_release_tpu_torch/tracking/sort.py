"""SORT multi-object tracker (Kalman + Hungarian IoU association), host-side.

The reference's tracking comes from the external multi-person-tracker, which
wraps the canonical SORT algorithm (Bewley et al. 2016) with filterpy
(behavioural contract in SURVEY.md section 2.9). Tracking is a tiny,
inherently sequential per-frame state machine, so it stays on host numpy --
the card does the detector FLOPs, SORT consumes its boxes.

State per track: x = [cx, cy, s(area), r(aspect), vcx, vcy, vs], constant
velocity; measurement z = [cx, cy, s, r]. Matrices follow the canonical SORT
implementation (R diag[1,1,10,10], P0 diag[10,10,10,10,1e4,1e4,1e4],
Q diag[1,1,1,1,.01,.01,1e-4]); association is IoU with Hungarian assignment,
default thresholds (max_age=1, min_hits=3, iou_threshold=0.3).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _xyxy_to_z(bbox: np.ndarray) -> np.ndarray:
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    cx = bbox[0] + w / 2.0
    cy = bbox[1] + h / 2.0
    s = w * h
    r = w / float(h)
    return np.array([cx, cy, s, r], np.float64).reshape(4, 1)


def _x_to_xyxy(x: np.ndarray) -> np.ndarray:
    # Canonical convert_x_to_bbox: NO clamp/guard -- a Kalman update that
    # drives the area state negative yields sqrt(negative) = NaN, which the
    # predict loop's isnan check then uses to DELETE the track (exactly the
    # upstream death path; a clamp here would keep such tracks alive for
    # max_age extra frames with degenerate [cx, cy, cx, cy] boxes).
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.sqrt(x[2, 0] * x[3, 0])
        h = x[2, 0] / w
    return np.array(
        [x[0, 0] - w / 2.0, x[1, 0] - h / 2.0, x[0, 0] + w / 2.0, x[1, 0] + h / 2.0]
    )


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for (N, 4) x (M, 4) boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    xx1 = np.maximum(a[:, None, 0], b[None, :, 0])
    yy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    xx2 = np.minimum(a[:, None, 2], b[None, :, 2])
    yy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


class _KalmanBoxTrack:
    F = np.eye(7)
    for _i in range(3):
        F[_i, _i + 4] = 1.0
    H = np.zeros((4, 7))
    H[:4, :4] = np.eye(4)

    def __init__(self, bbox_xyxy: np.ndarray, track_id: int):
        self.x = np.zeros((7, 1))
        self.x[:4] = _xyxy_to_z(bbox_xyxy)
        self.P = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
        self.Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
        self.R = np.diag([1.0, 1.0, 10.0, 10.0])

        # Ids are PER-SORT-INSTANCE (assigned by Sort.update), unlike the
        # upstream SORT's process-global KalmanBoxTracker.count: the
        # reference runs one video per process, so the observable contract
        # is "ids start at 1 for every video" -- a shared warm Predictor
        # scoring a directory (cli.py) must reproduce that, or person_<id>
        # output dirs and --person_genders mappings would depend on how
        # many tracks every EARLIER video in the process happened to spawn.
        self.id = track_id
        self.time_since_update = 0
        self.hit_streak = 0
        self.age = 0

    def predict(self) -> np.ndarray:
        if self.x[2, 0] + self.x[6, 0] <= 0:
            self.x[6, 0] = 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return _x_to_xyxy(self.x)

    def update(self, bbox_xyxy: np.ndarray) -> None:
        self.time_since_update = 0
        self.hit_streak += 1
        z = _xyxy_to_z(bbox_xyxy)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        # Joseph-stabilised covariance update, the form filterpy's
        # KalmanFilter.update computes (the upstream SORT's filter): equal to
        # (I-KH)P in exact arithmetic but not in floats, and the track boxes
        # it shapes feed crop geometry downstream.
        i_kh = np.eye(7) - K @ self.H
        self.P = i_kh @ self.P @ i_kh.T + K @ self.R @ K.T

    def state(self) -> np.ndarray:
        return _x_to_xyxy(self.x)


def _associate(dets: np.ndarray, preds: np.ndarray, iou_threshold: float):
    if preds.shape[0] == 0 or dets.shape[0] == 0:
        return (
            np.zeros((0, 2), np.int64),
            np.arange(dets.shape[0]),
            np.arange(preds.shape[0]),
        )
    iou = iou_xyxy(dets, preds)
    from scipy.optimize import linear_sum_assignment  # ~1.4 s to import: on first use

    row, col = linear_sum_assignment(-iou)
    matches, unmatched_d, unmatched_t = [], [], []
    matched_d = set()
    matched_t = set()
    for r, c in zip(row, col):
        if iou[r, c] >= iou_threshold:
            matches.append((r, c))
            matched_d.add(r)
            matched_t.add(c)
    unmatched_d = [d for d in range(dets.shape[0]) if d not in matched_d]
    unmatched_t = [t for t in range(preds.shape[0]) if t not in matched_t]
    return (
        np.array(matches, np.int64).reshape(-1, 2),
        np.array(unmatched_d, np.int64),
        np.array(unmatched_t, np.int64),
    )


class Sort:
    def __init__(self, max_age: int = 1, min_hits: int = 3, iou_threshold: float = 0.3):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.tracks: List[_KalmanBoxTrack] = []
        self.frame_count = 0
        self._next_id = 0

    def update(self, dets: np.ndarray) -> np.ndarray:
        """dets: (k, 5) [x1, y1, x2, y2, score] for one frame.
        Returns (m, 5) [x1, y1, x2, y2, track_id] of confirmed tracks."""
        self.frame_count += 1
        dets = np.asarray(dets, np.float64).reshape(-1, 5)

        preds = []
        dead = []
        for t, track in enumerate(self.tracks):
            box = track.predict()
            if np.any(np.isnan(box)):
                dead.append(t)
            preds.append(box)
        for t in reversed(dead):
            self.tracks.pop(t)
            preds.pop(t)
        preds = np.asarray(preds).reshape(-1, 4)

        matches, unmatched_d, _ = _associate(dets[:, :4], preds, self.iou_threshold)
        for d, t in matches:
            self.tracks[t].update(dets[d, :4])
        for d in unmatched_d:
            self._next_id += 1
            self.tracks.append(_KalmanBoxTrack(dets[d, :4], self._next_id))

        out = []
        for track in reversed(self.tracks):
            if track.time_since_update < 1 and (
                track.hit_streak >= self.min_hits or self.frame_count <= self.min_hits
            ):
                out.append(np.concatenate([track.state(), [track.id]]))
        self.tracks = [t for t in self.tracks if t.time_since_update <= self.max_age]
        return np.asarray(out).reshape(-1, 5)
