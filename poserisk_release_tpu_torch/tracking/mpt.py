"""Multi-person tracking orchestration with the reference MPT's output contract.

Reproduces what the external multi-person-tracker returns to the reference
(consumed at reference lib/core/base.py:59-74; contract in SURVEY.md
section 2.9): a dict

    {person_id: {'bbox': ndarray (N, 4) [cx, cy, w, h], 'frames': ndarray (N,)}}

where each bbox is SQUARED to max(w, h) on both sides (the upstream tracker's
prepare_output_tracks does `w = h = max(w, h)`), which is what keeps the
224x224 crops aspect-correct downstream.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from poserisk_release_tpu_torch.tracking.sort import Sort, iou_xyxy


class MultiPersonTracker:
    """detector: frames (N, H, W, 3) uint8 RGB -> per-frame (k, 5) xyxy+score."""

    def __init__(
        self,
        detector: Callable[[np.ndarray], List[np.ndarray]],
        max_age: int = 1,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        detection_stride: int = 1,
        adaptive: bool = False,
        adaptive_tol: float = 0.2,
    ):
        if detection_stride < 1:
            raise ValueError(f"detection_stride must be >= 1, got {detection_stride}")
        if adaptive and detection_stride <= 1:
            raise ValueError(
                "adaptive stride needs detection_stride > 1 (its MAX interval)")
        self.detector = detector
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.detection_stride = detection_stride
        self.adaptive = adaptive
        self.adaptive_tol = adaptive_tol

    def __call__(self, frames_rgb: np.ndarray) -> Dict[int, Dict[str, np.ndarray]]:
        return self.track_windows([(0, frames_rgb)])

    def track_windows(self, windows) -> Dict[int, Dict[str, np.ndarray]]:
        """Track an iterable of (start_frame_idx, frames) windows with ONE
        persistent SORT state -- identical results to a whole-clip call, but
        consumable from a streaming decoder so detection (device) overlaps
        decode (host thread). Windows must arrive in frame order.

        detection_stride > 1 (opt-in throughput mode, a deviation from the
        reference's detect-every-frame contract -- docs/PARITY.md) detects
        only frames whose GLOBAL index is a stride multiple and fills the
        gaps of each surviving track by linear interpolation."""
        tracker = Sort(
            max_age=self.max_age, min_hits=self.min_hits, iou_threshold=self.iou_threshold
        )
        people: Dict[int, Dict[str, list]] = {}
        for start_idx, frames_rgb in windows:
            update_window_tracks(tracker, people, start_idx, frames_rgb,
                                 self.detector, self.detection_stride,
                                 adaptive=self.adaptive,
                                 adaptive_tol=self.adaptive_tol)
        results = finalize_tracks(people)
        if self.detection_stride > 1:
            results = interpolate_track_gaps(results)
        return results


def detect_frames(detector, frames_rgb) -> List[np.ndarray]:
    """Run the detector on one window and validate the per-frame contract
    (exactly one (k, 5) array per input frame). A scripted stub that ignores
    its frames argument would otherwise replay ALL its detections per
    window, silently corrupting SORT state and frame indices. Shared by the
    whole-clip tracker and the streaming scorer."""
    detections = detector(frames_rgb)
    if len(detections) != len(frames_rgb):
        raise ValueError(
            f"detector returned {len(detections)} per-frame results for a "
            f"{len(frames_rgb)}-frame window; detectors must emit exactly "
            "one (k, 5) array per input frame"
        )
    return detections


def strided_local_indices(start_idx: int, n_frames: int, stride: int) -> List[int]:
    """Window-local indices whose GLOBAL frame index is a stride multiple.

    The phase is derived from start_idx, so the selection is window-
    boundary-safe for any window length. This is THE stride-phase rule:
    every strided consumer (batch tracker, two-pass streaming, online
    streaming) selects frames through it so the semantics cannot fork."""
    if stride == 1:
        return list(range(n_frames))
    offset = (-start_idx) % stride
    return list(range(offset, n_frames, stride))


def update_window_tracks(sort, people: Dict[int, Dict[str, list]],
                         start_idx: int, frames_rgb, detector,
                         stride: int = 1, adaptive: bool = False,
                         adaptive_tol: float = 0.2) -> None:
    """Detect + SORT-update one decoded window into the shared accumulator.

    stride > 1 detects only frames at GLOBAL indices that are stride
    multiples (strided_local_indices); SORT then sees a uniformly
    downsampled clip -- its constant-velocity state is per detection step,
    which is exactly the canonical tracker run at 1/stride frame rate.
    adaptive=True upgrades the fixed stride to the motion-adaptive schedule
    (adaptive_window_detections: stride is the MAX interval; intervals
    whose boxes move get bisected until linear interpolation is accurate
    to adaptive_tol). Shared by the batch tracker and the streaming scorer
    so the strided semantics cannot fork."""
    if adaptive and stride > 1:
        for local_idx, dets in adaptive_window_detections(
                detector, frames_rgb, start_idx, stride, adaptive_tol):
            tracks = sort.update(dets.reshape(-1, 5))
            accumulate_tracks(people, start_idx + local_idx, tracks)
        return
    if stride == 1:
        sel = range(len(frames_rgb))
        detections = detect_frames(detector, frames_rgb)
    else:
        sel = strided_local_indices(start_idx, len(frames_rgb), stride)
        if not sel:
            return
        detections = detect_frames(detector, frames_rgb[sel])
    for local_idx, dets in zip(sel, detections):
        tracks = sort.update(np.asarray(dets, np.float64).reshape(-1, 5))
        accumulate_tracks(people, start_idx + local_idx, tracks)


# -- motion-adaptive detection stride ---------------------------------------

def _iou_xyxy(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box against (k, >=4) rows -- THE one pairwise IoU
    (tracking.sort.iou_xyxy, the association-critical implementation),
    so the adaptive-stride geometry cannot drift from SORT's."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.float64)
    return iou_xyxy(np.asarray(box)[None, :4], np.asarray(boxes)[:, :4])[0]


def _box_motion(da: np.ndarray, db: np.ndarray, rel_tol: float) -> bool:
    """True when the interval's endpoint detections differ enough to warrant
    probing: a box appeared/disappeared, or any matched box's center moved
    by more than rel_tol of its side."""
    if da.shape[0] != db.shape[0]:
        return True
    for ba in da:
        ious = _iou_xyxy(ba, db)
        if ious.size == 0:
            return True
        bb = db[int(np.argmax(ious))]
        side = max(ba[2] - ba[0], ba[3] - ba[1], 1e-9)
        dc = np.hypot((ba[0] + ba[2]) - (bb[0] + bb[2]),
                      (ba[1] + ba[3]) - (bb[1] + bb[3])) / 2.0
        if dc > rel_tol * side or float(np.max(ious)) < 0.3:
            return True
    return False


def _interp_error_exceeds(da: np.ndarray, db: np.ndarray, dm: np.ndarray,
                          frac: float, tol: float) -> bool:
    """True when the midpoint detections disagree with linear interpolation
    of the endpoint boxes by more than tol (center error relative to box
    side), or a box has no counterpart at the midpoint/endpoints."""
    if da.shape[0] != db.shape[0] or dm.shape[0] != da.shape[0]:
        return True
    for ba in da:
        ious = _iou_xyxy(ba, db)
        if ious.size == 0 or float(np.max(ious)) < 0.1:
            return True
        bb = db[int(np.argmax(ious))]
        pred = ba[:4] + (bb[:4] - ba[:4]) * frac
        side = max(pred[2] - pred[0], pred[3] - pred[1], 1e-9)
        if dm.shape[0] == 0:
            return True
        errs = []
        for bm in dm:
            dc = np.hypot((pred[0] + pred[2]) - (bm[0] + bm[2]),
                          (pred[1] + pred[3]) - (bm[1] + bm[3])) / 2.0
            ds = abs((pred[2] - pred[0]) - (bm[2] - bm[0])) + abs(
                (pred[3] - pred[1]) - (bm[3] - bm[1]))
            errs.append(dc + 0.5 * ds)
        if min(errs) > tol * side:
            return True
    return False


def adaptive_window_detections(detector, frames_rgb, start_idx: int,
                               max_stride: int, tol: float = 0.2,
                               vel_tol: float = 0.05):
    """Motion-adaptive detection schedule for one window (the opt-in
    upgrade of the fixed detection stride, DetectorConfig.adaptive_stride).

    Round 0 detects the fixed-stride frames (strided_local_indices at
    max_stride -- the same phase rule, so a static scene costs exactly the
    fixed stride). Each interval whose endpoint boxes MOVED (more than
    vel_tol of the box side, or appeared/disappeared) then probes its
    midpoint, and keeps bisecting while the midpoint detection disagrees
    with linear interpolation of the endpoints by more than tol of the box
    side -- the criterion IS the error the fixed stride would silently
    commit, so detections concentrate exactly where interpolation fails
    (direction reversals, accelerations, entrances). Every probe is batched
    per bisection round (one detector call per depth level, not per frame).

    Returns [(local_idx, dets_f64 (k, 5))] sorted by frame, for SORT to
    consume in order. Limits: refinement is window-local (the interval
    spanning a window boundary stays at the base stride), and a person both
    entering AND leaving strictly inside a motion-free interval is not
    probed (the fixed stride misses them too)."""
    n = len(frames_rgb)
    base = strided_local_indices(start_idx, n, max_stride)
    if not base:
        return []
    cache: Dict[int, np.ndarray] = {}

    def detect(ids):
        new = sorted(i for i in set(ids) if i not in cache)
        if new:
            for i, d in zip(new, detect_frames(detector, frames_rgb[new])):
                cache[i] = np.asarray(d, np.float64).reshape(-1, 5)

    detect(base)
    intervals = [
        (a, b) for a, b in zip(base[:-1], base[1:])
        if b - a >= 2 and _box_motion(cache[a], cache[b], vel_tol)
    ]
    while intervals:
        detect([(a + b) // 2 for a, b in intervals])
        nxt = []
        for a, b in intervals:
            m = (a + b) // 2
            if _interp_error_exceeds(cache[a], cache[b], cache[m],
                                     (m - a) / (b - a), tol):
                if m - a >= 2:
                    nxt.append((a, m))
                if b - m >= 2:
                    nxt.append((m, b))
        intervals = nxt
    return sorted(cache.items())


def interpolate_track_gaps(
    tracking_results: Dict[int, Dict[str, np.ndarray]],
) -> Dict[int, Dict[str, np.ndarray]]:
    """Fill each track's interior frame gaps by per-column linear
    interpolation of its cxcywh boxes (detected frames keep their exact
    boxes). The same gap policy as the reference's keypoint-path bbox
    smoothing (lib/utils/smooth_bbox.py interpolates bbox params across
    missing frames); squared boxes stay squared because w == h
    interpolates to w == h. No extrapolation beyond a track's first/last
    detection."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for pid, track in tracking_results.items():
        frames = np.asarray(track["frames"], np.int64)
        bbox = np.asarray(track["bbox"], np.float64)
        if frames.shape[0] < 2 or int(np.diff(frames).max()) <= 1:
            out[pid] = {"bbox": bbox, "frames": frames}
            continue
        full = np.arange(frames[0], frames[-1] + 1, dtype=np.int64)
        filled = np.stack(
            [np.interp(full, frames, bbox[:, c]) for c in range(bbox.shape[1])],
            axis=1,
        )
        out[pid] = {"bbox": filled, "frames": full}
    return out


def squared_cxcywh(x1: float, y1: float, x2: float, y2: float) -> np.ndarray:
    """xyxy -> the upstream tracker's squared [cx, cy, side, side] output
    convention (prepare_output_tracks, SURVEY.md section 2.9). THE one
    definition of the squaring rule -- shared by track accumulation, the
    online streaming target-follow, and the explicit-calibration crop
    geometry, so the crop aspect contract cannot fork between them."""
    w, h = x2 - x1, y2 - y1
    side = max(w, h)
    return np.array([x1 + w / 2.0, y1 + h / 2.0, side, side], np.float64)


def accumulate_tracks(people: Dict[int, Dict[str, list]], frame_idx: int,
                      tracks: np.ndarray) -> None:
    """Fold one frame's SORT output rows (x1, y1, x2, y2, id) into the MPT
    people dict, squaring each bbox to max(w, h) per the upstream tracker's
    prepare_output_tracks convention (SURVEY.md section 2.9). Shared by the
    whole-clip tracker above and the streaming scorer's tracking pass."""
    for row in tracks:
        x1, y1, x2, y2, tid = row
        entry = people.setdefault(int(tid), {"bbox": [], "frames": []})
        entry["bbox"].append(squared_cxcywh(x1, y1, x2, y2))
        entry["frames"].append(frame_idx)


def finalize_tracks(people: Dict[int, Dict[str, list]]) -> Dict[int, Dict[str, np.ndarray]]:
    """List-of-rows accumulator -> the MPT output contract arrays."""
    return {
        pid: {
            "bbox": np.stack(v["bbox"]),
            "frames": np.asarray(v["frames"], np.int64),
        }
        for pid, v in people.items()
    }


def surviving_tracks(
    tracking_results: Dict[int, Dict[str, np.ndarray]],
    total_frames: int,
    min_frame_ratio: float = 0.33,
    max_min_frames: int = 1000,
) -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's min-frames track filter with its keep-all fallback
    (drop tracks shorter than min(min_frame_ratio * total, 1000); if none
    survive keep everything, base.py:66-68). THE one filter rule: the
    single-target selector below, the batch Predictor's --multi_person
    extension, and streaming score_all all select through it."""
    min_frames = min(total_frames * min_frame_ratio, max_min_frames)
    return {
        pid: t for pid, t in tracking_results.items()
        if t["frames"].shape[0] >= min_frames
    } or dict(tracking_results)


def filter_and_select_target(
    tracking_results: Dict[int, Dict[str, np.ndarray]],
    total_frames: int,
    min_frame_ratio: float = 0.33,
    max_min_frames: int = 1000,
):
    """Track filtering + target selection, parity with the reference:
    the surviving_tracks filter, then pick the track with the largest mean
    bbox area (funcs_utils.py:55-64).

    Returns (bbox (N, 4) cxcywh, frames (N,)).
    """
    kept = list(surviving_tracks(tracking_results, total_frames,
                                 min_frame_ratio, max_min_frames).values())
    if not kept:
        raise ValueError("no person tracks found in the clip")

    areas = [float((t["bbox"][:, 2] * t["bbox"][:, 3]).mean()) for t in kept]
    best = kept[int(np.argmax(areas))]
    return best["bbox"], best["frames"]
