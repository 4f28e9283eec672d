"""Bounded-memory streaming scorer for long videos, in PyTorch.

Port of the JAX package's streaming.py. The batch Predictor holds every
frame of the clip; this module scores a video in fixed-size windows
decoded one window ahead on a background host thread
(io.video._window_stream), so peak host memory is about two windows of
frames (O(decode_workers * window) with DATASET.decode_workers > 1).

Two target-selection modes:

  * ``selection="reference"`` (default), two passes: pass 1 decodes,
    detects and SORT-tracks the whole video, keeping only per-identity
    box/frame lists; the reference's filter + max-mean-area selection then
    runs over the complete tracks exactly as the batch Predictor does, and
    pass 2 decodes again and crops/scores only the selected person. Scores
    equal the batch Predictor's on any clip, multi-person contention and
    pose_stride > 1 included: under a pose stride the track accumulates
    into the batch path's own chunk structure (_TrackChunkScorer).
  * ``selection="online"``, one pass: lock onto the largest-box identity
    as soon as one is seen and follow it (OnlineTargetTracker). No
    min-frame filter and no whole-video mean-area comparison, so on
    multi-person clips it can score another person than the reference
    would. Under detection_stride > 1 skipped frames wait in a bounded
    ring and are scored with boxes interpolated between the surrounding
    detections, so every frame between the target's first and last
    detection is scored.

Per window: decode -> [detect + track] -> crop (kernel K1 on the card) ->
pose -> REBA/RULA, with the final statistics those of
outputs.stats.post_process_scores over the whole video. Every entry runs
on CUDA unless given device="cpu", and raises without CUDA.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import Config, default_config
from poserisk_release_tpu_torch.device import resolve_device
from poserisk_release_tpu_torch.io.video import _window_stream
from poserisk_release_tpu_torch.models.detector import StubDetector
from poserisk_release_tpu_torch.outputs.render import ResultVideoWriter
from poserisk_release_tpu_torch.outputs.stats import (
    final_scores_stats,
    post_process_scores,
    scores_summary_block,
    write_result_txt,
)
from poserisk_release_tpu_torch.pipeline import (
    PoseEstimator,
    _global_rank,
    validate_rotation_roundtrip,
)
from poserisk_release_tpu_torch.scoring.reba import REBAScorer
from poserisk_release_tpu_torch.scoring.rula import RULAScorer
from poserisk_release_tpu_torch.tracking.mpt import (
    detect_frames,
    filter_and_select_target,
    finalize_tracks,
    interpolate_track_gaps,
    squared_cxcywh,
    strided_local_indices,
    surviving_tracks,
    update_window_tracks,
)
from poserisk_release_tpu_torch.tracking.sort import Sort


@dataclass
class StreamResult:
    frames: List[int] = field(default_factory=list)
    reba_scores: List[int] = field(default_factory=list)
    rula_scores: List[int] = field(default_factory=list)
    # Per-frame per-joint log entries (the scorers' "log_score"), in the
    # same frame order: what the annotated video's side panel prints.
    reba_logs: List[list] = field(default_factory=list)
    rula_logs: List[list] = field(default_factory=list)
    total_frames: int = 0
    fps: float = 0.0

    def stats(self, which: str = "reba"):
        """(avg, top50, top10, max, mode) through outputs.stats.
        final_scores_stats, the code the Predictor and write_outputs use.
        Raises ValueError when the stream scored no frame."""
        return final_scores_stats(getattr(self, f"{which}_scores"))


class OnlineTargetTracker:
    """Single-pass target follow + detection-stride backfill.

    The one implementation of the online selection policy (largest-box
    lock-on, re-lock on identity loss) and of the bounded-ring gap rules.
    Feed every frame in order through ``observe``; it returns the frames
    that became scoreable, each with its f64 cxcywh box:

      * a frame whose detections contain the followed target returns
        itself, plus any pending gap frames, their boxes linearly
        interpolated between the surrounding detections (the
        interpolate_track_gaps rule), or HELD at the old identity's last
        box when the target identity switched (never a blend of two
        people);
      * a frame without detections (stride-skipped, or a detection step
        that missed the target) waits in the pending ring; when the ring
        outgrows ``ring_capacity`` the oldest frame flushes with the last
        detection's box held (anchor-hold);
      * frames before the first detection are never scored (no
        extrapolation); frames after the last one stay pending.

    ``backfill=False`` (the detection-stride-1 contract) disables the ring:
    only directly tracked frames score, as in the two-pass mode at stride 1.

    ``copy_pending=True`` copies each frame as it enters the ring, for a
    caller that reuses its frame buffer between calls. The streaming scorer
    keeps the zero-copy default: its pending entries are views into
    immutable decode windows, consecutive by construction, so at most about
    two window buffers stay referenced.
    """

    def __init__(self, ring_capacity: int, backfill: bool = True,
                 copy_pending: bool = False):
        self.sort = Sort()
        self.ring = int(ring_capacity)
        self.backfill = backfill
        self.copy_pending = copy_pending
        self.target_id: Optional[int] = None
        self.pending: List[Tuple[int, np.ndarray]] = []
        self.last_det: Optional[Tuple[int, np.ndarray]] = None

    def _follow(self, tracks: np.ndarray):
        """Largest-box lock-on; returns (row, switched)."""
        if tracks.shape[0] == 0:
            return None, False
        switched = False
        if self.target_id is None or not np.any(tracks[:, 4] == self.target_id):
            areas = (tracks[:, 2] - tracks[:, 0]) * (tracks[:, 3] - tracks[:, 1])
            new_id = int(tracks[int(np.argmax(areas)), 4])
            switched = self.target_id is not None
            self.target_id = new_id
        return tracks[tracks[:, 4] == self.target_id][0], switched

    def observe(self, gidx: int, frame: np.ndarray,
                dets: Optional[np.ndarray]
                ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """Advance by one frame. dets: this frame's (N, 5) detections, or
        None for a stride-skipped frame. Returns [(global_idx, rgb, box)]
        newly scoreable, in frame order."""
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        if dets is not None:
            tracks = self.sort.update(np.asarray(dets, np.float64).reshape(-1, 5))
            row, switched = self._follow(tracks)
            if row is not None:
                box = squared_cxcywh(row[0], row[1], row[2], row[3])
                if self.last_det is not None and self.pending:
                    g0, b0 = self.last_det
                    for pg, prgb in self.pending:
                        if switched:
                            # The pending gap belongs to the OLD identity:
                            # its last box held, never a blend.
                            out.append((pg, prgb, b0.copy()))
                        else:
                            t = (pg - g0) / (gidx - g0)
                            out.append((pg, prgb, b0 + (box - b0) * t))
                self.pending.clear()
                out.append((gidx, frame, box))
                self.last_det = (gidx, box)
                return out
        if not self.backfill:
            return out
        self.pending.append(
            (gidx, np.array(frame, copy=True) if self.copy_pending else frame))
        if len(self.pending) > self.ring:
            # Ring overflow: flush the oldest frame with the last
            # detection's box held instead of dropping its pixels.
            pg, prgb = self.pending.pop(0)
            if self.last_det is not None:
                out.append((pg, prgb, self.last_det[1].copy()))
        return out


class _SpinCalibrator:
    """int8-PTQ calibration source for chunk-aligned streaming.

    The batch path calibrates the SPIN backbone on the first (up to) 8
    frames of the FIRST scored track; in --multi_person that is the first
    surviving track in discovery order. Chunk-aligned streaming flushes
    tracks in chunk-fill order, which can differ, so the calibration pixels
    are gathered here from the owner track in window order, and every
    accumulator's flush goes through ensure() before touching the
    estimator. Pixels are copied (a view would pin its whole window)."""

    def __init__(self, est: PoseEstimator):
        self.est = est
        self._px: List[np.ndarray] = []
        self._boxes: List[np.ndarray] = []

    @property
    def gathering(self) -> bool:
        return self.est.spin_needs_calibration and len(self._px) < 8

    def gather(self, frames, local_ids, boxes) -> None:
        for i, box in zip(np.asarray(local_ids), np.asarray(boxes)):
            if len(self._px) >= 8:
                return
            self._px.append(np.array(frames[i], copy=True))
            self._boxes.append(np.asarray(box))

    def ensure(self) -> None:
        """Quantize the backbone on the gathered frames, as run_from_frames
        would on the owner track's first frames."""
        if not self.est.spin_needs_calibration or not self._px:
            return
        self.est.calibrate_on_frames(np.stack(self._px), np.stack(self._boxes))
        self._px, self._boxes = [], []


class _TrackChunkScorer:
    """Accumulates ONE selected track across decode windows and scores it
    in exactly the batch Predictor's chunk structure.

    At pose_stride > 1 the batch path takes SPIN anchors per
    production_chunk()-sized chunk of the selected track
    (PoseEstimator._run_chunked), so the anchor phase and the chunk
    boundaries are a function of the track's own frame index; scoring
    window by window would restart that phase at every window. This helper
    buffers the anchor frames (1/stride of the pixels, each COPIED out of
    its window so no window stays pinned) until a full chunk of track
    frames has gone past, then replays the batch call: run_from_frames on a
    virtual track whose ids repeat each anchor stride times, so the strided
    slice inside _run_chunked selects exactly the buffered anchors, with
    the batch path's padding and trimming. Scores equal the batch path's.
    """

    def __init__(self, scorer: "StreamingScorer", add_info: Dict,
                 reba, rula, result: StreamResult,
                 calibrator: _SpinCalibrator):
        self.est = scorer.estimator
        self.validate = scorer.validate_rotations
        self.stride = self.est.pose_stride
        self.chunk = self.est.production_chunk()
        self.add_info, self.reba, self.rula = add_info, reba, rula
        self.result = result
        self.calibrator = calibrator
        self._pos = 0  # track position within the current chunk
        self._anchor_px: List[np.ndarray] = []
        self._anchor_boxes: List[np.ndarray] = []
        self._ids: List[int] = []

    def add(self, frames, local_ids: np.ndarray, boxes: np.ndarray,
            start_idx: int) -> None:
        for i, box in zip(np.asarray(local_ids), np.asarray(boxes)):
            if self._pos % self.stride == 0:
                self._anchor_px.append(np.array(frames[i], copy=True))
                self._anchor_boxes.append(box)
            self._ids.append(int(start_idx + i))
            self._pos += 1
            if self._pos == self.chunk:
                self.flush()

    def flush(self) -> None:
        if self._pos == 0:
            return
        self.calibrator.ensure()
        n = self._pos
        # Virtual track: id j//stride at position j, so the strided slice
        # inside _run_chunked reads the buffered anchors 0..n_anchors-1 in
        # order; the boxes repeat so the same slice reads the anchors' boxes.
        ids = np.repeat(np.arange(len(self._anchor_px)), self.stride)[:n]
        boxes = np.repeat(np.stack(self._anchor_boxes), self.stride, axis=0)[:n]
        euler, joint_cam, aa = self.est.run_from_frames(
            np.stack(self._anchor_px), ids, boxes, chunk=self.chunk)
        if self.validate:
            validate_rotation_roundtrip(aa)
        _append_scores(self.result, self.reba, self.rula, euler, joint_cam, self.add_info)
        self.result.frames.extend(self._ids)
        self._pos = 0
        self._anchor_px, self._anchor_boxes, self._ids = [], [], []


def _append_scores(result: StreamResult, reba, rula, euler, joint_cam, add_info) -> None:
    for r in reba(euler, joint_cam, add_info):
        result.reba_scores.append(r["score"])
        result.reba_logs.append(r["log_score"])
    for r in rula(euler, joint_cam, add_info):
        result.rula_scores.append(r["score"])
        result.rula_logs.append(r["log_score"])


class StreamingScorer:
    """Window-at-a-time scoring with persistent tracking state.

    >>> scorer = StreamingScorer(detector=StubDetector())
    >>> result = scorer(video_path, add_info)

    The JAX scorer's arguments, plus `device`: CUDA unless given, and
    raises without it. mesh: as pipeline.PoseEstimator's, a DeviceMesh or
    None, in which case cfg.PARALLEL decides (dp, tp, pp, ep, sp, over the
    process group this rank has joined). Under a mesh every rank decodes,
    detects and tracks the same clip (deterministic host work, replicated)
    and its estimator takes the mesh; every rank returns the same results,
    and rank 0 alone writes files (write_outputs, the annotated videos),
    as the Predictor does.
    """

    def __init__(
        self,
        cfg: Config | None = None,
        detector=None,
        window: int = 256,
        mesh=None,
        spin_variables=None,
        selection: str = "reference",
        fast: bool = False,
        spin_int8: bool = False,
        gender: str = "neutral",
        validate_rotations: bool = False,
        device=None,
    ):
        if selection not in ("reference", "online"):
            raise ValueError(f"selection must be 'reference' or 'online', got {selection!r}")
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        self.window = window
        self.selection = selection
        self.smpl = SMPLFamily(self.cfg.SPIN.smpl_model_dir)
        self.estimator = PoseEstimator(self.cfg, self.smpl, variables=spin_variables,
                                       gender=gender, fast=fast, spin_int8=spin_int8,
                                       device=self.device, mesh=mesh)
        self._writes = self.estimator.mesh is None or _global_rank() == 0
        self.detector = detector if detector is not None else StubDetector()
        # The Predictor's opt-in euler round-trip guard (--validate_rotations).
        self.validate_rotations = validate_rotations

    def _per_video_calibration_reset(self) -> None:
        """The Predictor's shared-instance int8 lifecycle: under
        recalibrate_per_video each video re-derives its own scales, unless
        an explicit calibration source fixes them."""
        if (self.cfg.DETECTOR.recalibrate_per_video
                and not self.cfg.DETECTOR.calibration):
            if hasattr(self.detector, "reset_calibration"):
                self.detector.reset_calibration()
            self.estimator.reset_calibration()

    def __call__(self, video_path: str, add_info: Dict,
                 max_frames: Optional[int] = None,
                 video_output: Optional[str] = None,
                 video_types: str = "REBA,RULA") -> StreamResult:
        """video_output: directory to write the annotated {REBA,RULA}_video
        .mp4 into, rendered window by window during pass 2 (frame-exact
        against the batch renderer). Still one window of pixels at a time,
        but rendering decodes the whole clip. Two-pass mode only: the
        online mode has no complete track for the side panel."""
        self._per_video_calibration_reset()
        if self.selection == "reference":
            return self._run_two_pass(video_path, add_info, max_frames,
                                      self._video_output(video_output), video_types)
        if video_output is not None:
            raise ValueError(
                "video rendering requires the two-pass mode "
                "(selection='reference')")
        return self._run_online(video_path, add_info, max_frames)

    def score_all(self, video_path: str, add_info: Dict,
                  max_frames: Optional[int] = None,
                  video_output: Optional[str] = None,
                  video_types: str = "REBA,RULA") -> Dict[int, StreamResult]:
        """Multi-person streaming: score EVERY track surviving the
        reference's min-frames filter, bounded-memory, with the batch
        --multi_person path's per-track filter and fallback. Pass 1 tracks
        everyone; pass 2 decodes once and scores all surviving tracks from
        the shared windows. Returns {person_id: StreamResult}.

        video_output: base directory; each surviving track's annotated
        videos go to <video_output>/person_<id>/ (the batch layout)."""
        if self.selection != "reference":
            raise ValueError(
                "score_all needs the two-pass mode (selection='reference'): "
                "online selection locks onto a single identity by design")
        self._per_video_calibration_reset()
        tracking_results, total, fps = self._track_pass(video_path, max_frames)
        if not tracking_results:
            return {}
        survivors = surviving_tracks(
            tracking_results, total, self.cfg.DATASET.min_frame_ratio)
        # The tracker's float64 boxes: the renderer's int() truncation is
        # dtype-sensitive (f32 rounds 72.99999676 up to 73.0, f64 truncates
        # to 72). Scoring casts to f32 itself, as the batch crop path does.
        tracks = {
            pid: (np.asarray(t["frames"]), np.asarray(t["bbox"]))
            for pid, t in survivors.items()
        }
        results = {pid: StreamResult(total_frames=total, fps=fps) for pid in tracks}
        reba, rula = self._scorers()
        stop_at = max(int(fr.max()) for fr, _ in tracks.values()) + 1
        if max_frames is not None:
            stop_at = min(stop_at, max_frames)
        render_plan, video_output = self._build_render_plan(
            reba, rula, video_types, self._video_output(video_output))
        if self.estimator.pose_stride > 1:
            # Chunk-aligned scoring per track (_TrackChunkScorer). Each
            # track buffers its own anchor pixels, so the shared union
            # upload does not apply; rendering is a decode pass of its own
            # from the complete results. The int8 calibration pixels come
            # from the FIRST surviving track in discovery order, the track
            # that calibrates the batch --multi_person path.
            cal = _SpinCalibrator(self.estimator)
            owner = next(iter(tracks))
            accs = {pid: _TrackChunkScorer(self, add_info, reba, rula, results[pid], cal)
                    for pid in tracks}
            for item in _window_stream(video_path, self.window, stop_at,
                                       self.cfg.DATASET.decode_workers):
                if item[0] != "window":
                    continue
                _, start_idx, frames = item
                for pid, (fr, bx) in tracks.items():
                    mask = (fr >= start_idx) & (fr < start_idx + len(frames))
                    if mask.any():
                        ids = fr[mask] - start_idx
                        if pid == owner and cal.gathering:
                            cal.gather(frames, ids, bx[mask])
                        accs[pid].add(frames, ids, bx[mask], int(start_idx))
            for acc in accs.values():
                acc.flush()
            if video_output is not None:
                entries = []
                for pid, (fr, bx) in tracks.items():
                    person_out = osp.join(video_output, f"person_{pid}")
                    os.makedirs(person_out, exist_ok=True)
                    entries.append((results[pid], fr, bx, person_out))
                self._render_pass(video_path, max_frames, video_output,
                                  render_plan, fps, entries)
            return results

        writers: Dict[int, list] = {}
        if video_output is not None:
            stop_at = max_frames  # rendering draws the whole clip
        try:
            for item in _window_stream(video_path, self.window, stop_at,
                                       self.cfg.DATASET.decode_workers):
                if item[0] != "window":
                    continue
                _, start_idx, frames = item
                if video_output is not None and not writers:
                    for pid, (fr, bx) in tracks.items():
                        person_out = osp.join(video_output, f"person_{pid}")
                        os.makedirs(person_out, exist_ok=True)
                        writers[pid] = [
                            ResultVideoWriter(person_out, title, fps, frames.shape[1:3],
                                              scorer.eval_items, fr, bx)
                            for title, scorer, _, _ in render_plan
                        ]
                overlapping = []
                for pid, (fr, bx) in tracks.items():
                    mask = (fr >= start_idx) & (fr < start_idx + len(frames))
                    if mask.any():
                        overlapping.append((pid, fr[mask] - start_idx, bx[mask]))
                if len(overlapping) > 1:
                    # Multi-person windows share ONE upload of the union of
                    # the selected frames; each track then gathers its own
                    # frames on the device (run_from_frames takes a tensor
                    # source). Each track still feeds the same (frame, box)
                    # sequence through the same chunking, so the scores are
                    # those of per-track uploads.
                    union = np.unique(np.concatenate([ids for _, ids, _ in overlapping]))
                    pos = np.full(int(union.max()) + 1, -1, np.int64)
                    pos[union] = np.arange(len(union))
                    frames_src = torch.as_tensor(frames[union], device=self.device)
                    for pid, ids, bx in overlapping:
                        self._score_window(
                            frames_src, pos[ids], bx, int(start_idx), add_info,
                            reba, rula, results[pid], orig_local_ids=ids)
                elif overlapping:
                    pid, ids, bx = overlapping[0]
                    self._score_window(frames, ids, bx, int(start_idx), add_info,
                                       reba, rula, results[pid])
                for pid, per_title in writers.items():
                    for writer, (_, _, s_attr, l_attr) in zip(per_title, render_plan):
                        writer.write_window(frames, int(start_idx),
                                            getattr(results[pid], s_attr),
                                            getattr(results[pid], l_attr))
        finally:
            # Release the video writers on every path, exceptions included.
            for per_title in writers.values():
                for writer in per_title:
                    writer.close()
        return results

    # -- pass 1: detect + track only (no pixels retained) -----------------
    def _track_pass(self, video_path: str, max_frames: Optional[int]
                    ) -> Tuple[Dict[int, Dict[str, np.ndarray]], int, float]:
        stride = int(self.cfg.DETECTOR.detection_stride)
        sort = Sort()
        people: Dict[int, Dict[str, list]] = {}
        fps = 0.0
        total = 0
        # The batch ingest's int8 lifecycle: the first window calibrates
        # the detector explicitly, then every window, the first included,
        # is detected by the int8 graph.
        needs_cal = getattr(self.detector, "needs_calibration", False)
        for item in _window_stream(video_path, self.window, max_frames,
                                   self.cfg.DATASET.decode_workers):
            if item[0] == "meta":
                fps = float(item[1])
            elif item[0] == "window":
                _, start_idx, frames = item
                if needs_cal:
                    self.detector.calibrate(frames)
                    needs_cal = False
                update_window_tracks(
                    sort, people, start_idx, frames, self.detector, stride,
                    adaptive=bool(self.cfg.DETECTOR.adaptive_stride),
                    adaptive_tol=float(self.cfg.DETECTOR.adaptive_tol))
            else:  # end
                total = int(item[1])
        results = finalize_tracks(people)
        if stride > 1:
            results = interpolate_track_gaps(results)
        return results, total, fps

    def _run_two_pass(self, video_path: str, add_info: Dict,
                      max_frames: Optional[int],
                      video_output: Optional[str] = None,
                      video_types: str = "REBA,RULA") -> StreamResult:
        tracking_results, total, fps = self._track_pass(video_path, max_frames)
        result = StreamResult(total_frames=total, fps=fps)
        if not tracking_results:
            # The batch Predictor's contract: nobody tracked is an error,
            # not a zero-score run.
            raise ValueError("no person tracks found in the clip")
        bboxes, sel_frames = filter_and_select_target(
            tracking_results, total, self.cfg.DATASET.min_frame_ratio)
        sel_frames = np.asarray(sel_frames)
        reba, rula = self._scorers()
        # Pass 2 decodes again and scores only the selected track's frames.
        # Without rendering it stops after the last selected frame;
        # rendering needs every clip frame ('Not detected target' tails).
        stop_at = int(sel_frames.max()) + 1
        if max_frames is not None:
            stop_at = min(stop_at, max_frames)
        render_plan, video_output = self._build_render_plan(
            reba, rula, video_types, video_output)
        if video_output is not None:
            os.makedirs(video_output, exist_ok=True)

        if self.estimator.pose_stride > 1:
            # Chunk-aligned scoring (_TrackChunkScorer): the anchor phase
            # follows the track's own frame index, as in the batch path.
            # Its scores lag the windows by up to a chunk, so rendering is
            # a decode pass of its own after scoring.
            cal = _SpinCalibrator(self.estimator)
            acc = _TrackChunkScorer(self, add_info, reba, rula, result, cal)
            for item in _window_stream(video_path, self.window, stop_at,
                                       self.cfg.DATASET.decode_workers):
                if item[0] != "window":
                    continue
                _, start_idx, frames = item
                mask = (sel_frames >= start_idx) & (sel_frames < start_idx + len(frames))
                if mask.any():
                    ids = sel_frames[mask] - start_idx
                    if cal.gathering:
                        cal.gather(frames, ids, bboxes[mask])
                    acc.add(frames, ids, bboxes[mask], int(start_idx))
            acc.flush()
            if video_output is not None:
                self._render_pass(video_path, max_frames, video_output,
                                  render_plan, fps, [(result, sel_frames, bboxes)])
            return result

        writers: list = []
        if video_output is not None:
            stop_at = max_frames  # rendering draws the whole clip
        try:
            for item in _window_stream(video_path, self.window, stop_at,
                                       self.cfg.DATASET.decode_workers):
                if item[0] != "window":
                    continue
                _, start_idx, frames = item
                mask = (sel_frames >= start_idx) & (sel_frames < start_idx + len(frames))
                if mask.any():
                    self._score_window(
                        frames, sel_frames[mask] - start_idx, bboxes[mask],
                        int(start_idx), add_info, reba, rula, result)
                if video_output is not None:
                    if not writers:
                        writers = [
                            ResultVideoWriter(video_output, title, fps, frames.shape[1:3],
                                              scorer.eval_items, sel_frames, bboxes)
                            for title, scorer, _, _ in render_plan
                        ]
                    for writer, (_, _, s_attr, l_attr) in zip(writers, render_plan):
                        writer.write_window(frames, int(start_idx),
                                            getattr(result, s_attr),
                                            getattr(result, l_attr))
        finally:
            for writer in writers:
                writer.close()
        return result

    def _video_output(self, video_output: Optional[str]) -> Optional[str]:
        """Where this rank renders: nowhere on a rank that writes no files.
        Rendering only decodes more windows, past the last scored frame,
        so every rank still runs the same pose steps."""
        return video_output if self._writes else None

    def _build_render_plan(self, reba, rula, video_types: str,
                           video_output: Optional[str]):
        """(render_plan, video_output): the (title, scorer, scores_attr,
        logs_attr) rows video_types selects, for both streaming modes. When
        video_output is set but NO family matches, rendering is skipped
        with a warning and video_output comes back None: the batch
        Predictor completes on an unmatched score_type, so streaming does
        not abort either."""
        wanted = video_types.replace(" ", "").upper().split(",")
        plan = [
            row for row in (
                ("REBA", reba, "reba_scores", "reba_logs"),
                ("RULA", rula, "rula_scores", "rula_logs"),
            )
            if row[0] in wanted
        ]
        if video_output is not None and not plan:
            warnings.warn(
                f"video_types {video_types!r} selects neither REBA nor "
                "RULA; skipping video rendering", stacklevel=3)
            video_output = None
        return plan, video_output

    def _render_pass(self, video_path: str, max_frames: Optional[int],
                     video_output: str, render_plan, fps: float,
                     tracks_to_render) -> None:
        """Render annotated videos from COMPLETE results in a decode pass of
        their own (the chunk-aligned pose-stride path). tracks_to_render:
        (result, track_frames, track_bboxes[, output_dir]) per person;
        output_dir defaults to video_output."""
        writers: list = []  # (writer, result, s_attr, l_attr)
        try:
            for item in _window_stream(video_path, self.window, max_frames,
                                       self.cfg.DATASET.decode_workers):
                if item[0] != "window":
                    continue
                _, start_idx, frames = item
                if not writers:
                    for entry in tracks_to_render:
                        result, tr_frames, tr_boxes = entry[:3]
                        out_dir = entry[3] if len(entry) > 3 else video_output
                        for title, scorer, s_attr, l_attr in render_plan:
                            writers.append((
                                ResultVideoWriter(out_dir, title, fps, frames.shape[1:3],
                                                  scorer.eval_items, tr_frames, tr_boxes),
                                result, s_attr, l_attr))
                for writer, result, s_attr, l_attr in writers:
                    writer.write_window(frames, int(start_idx),
                                        getattr(result, s_attr), getattr(result, l_attr))
        finally:
            for writer, _result, _s, _l in writers:
                writer.close()

    # -- single-pass online mode ------------------------------------------
    def _run_online(self, video_path: str, add_info: Dict,
                    max_frames: Optional[int]) -> StreamResult:
        stride = int(self.cfg.DETECTOR.detection_stride)
        result = StreamResult()
        reba, rula = self._scorers()
        needs_cal = getattr(self.detector, "needs_calibration", False)
        # Detection-stride backfill (OnlineTargetTracker): every frame
        # between the first and the last target detection is scored. The
        # single-pass deviations are in the BOXES, not the coverage: a gap
        # longer than the ring (one window of pixels) flushes its oldest
        # frames with the last box held, and a target switch holds the old
        # identity's last box over the gap. Backfill is off at stride 1,
        # where occlusion gaps stay unscored, as in the two-pass mode.
        tracker = OnlineTargetTracker(ring_capacity=self.window, backfill=stride > 1)

        for item in _window_stream(video_path, self.window, max_frames,
                                   self.cfg.DATASET.decode_workers):
            if item[0] == "meta":
                result.fps = float(item[1])
                continue
            if item[0] == "end":
                result.total_frames = int(item[1])
                break
            _, start_idx, frames = item
            if needs_cal:
                self.detector.calibrate(frames)
                needs_cal = False

            if stride == 1:
                det_map = dict(enumerate(self._detect(frames)))
            else:
                det_local = strided_local_indices(start_idx, len(frames), stride)
                det_map = dict(zip(
                    det_local, self._detect(frames[det_local]) if det_local else []))
            buf_px: List[np.ndarray] = []
            buf_boxes: List[np.ndarray] = []
            buf_ids: List[int] = []
            for local in range(len(frames)):
                for gidx, rgb, box in tracker.observe(
                        start_idx + local, frames[local], det_map.get(local)):
                    buf_px.append(rgb)
                    buf_boxes.append(box)
                    buf_ids.append(gidx)
            if buf_px:
                # Boxes stay float64 down to _score_window, which casts to
                # f32 where the two-pass mode does.
                self._score_window(
                    np.stack(buf_px), np.arange(len(buf_px)), np.stack(buf_boxes), 0,
                    add_info, reba, rula, result, orig_local_ids=np.asarray(buf_ids))
        if not result.frames:
            raise ValueError("no person tracks found in the clip")
        return result

    # -- shared helpers ----------------------------------------------------
    def _detect(self, frames: np.ndarray) -> List[np.ndarray]:
        return detect_frames(self.detector, frames)

    def _scorers(self):
        return REBAScorer(device=self.device), RULAScorer(device=self.device)

    def write_outputs(self, result: StreamResult, output_path: str,
                      score_type: str = "REBA,RULA") -> Dict:
        """Reference-format result files from a stream result: the
        {title}_score.png plot and {title.lower()}_result.txt (the
        Predictor's post_process_scores / write_result_txt) and a
        stream_summary.json. score_type filters the families with the
        Predictor's --type parsing. Returns {title: (final_scores,
        action_level, action_name)}. Under a mesh only rank 0 writes; every
        rank returns the summary."""
        writes = self._writes
        if writes:
            os.makedirs(output_path, exist_ok=True)
        wanted = score_type.replace(" ", "").upper().split(",")
        reba, rula = self._scorers()
        timestamp = (0, np.asarray(result.frames), result.total_frames)
        summary: Dict[str, tuple] = {}
        for title, scorer, scores in (
            ("REBA", reba, result.reba_scores),
            ("RULA", rula, result.rula_scores),
        ):
            if title not in wanted or not scores:
                continue
            final_scores, _, _ = post_process_scores(
                [{"score": s, "log_score": []} for s in scores],
                timestamp, output_path, title=title, make_plot=writes)
            action_level, action_name = scorer.action_level(final_scores[4])
            if writes:
                write_result_txt(output_path, title, final_scores, action_level, action_name)
            summary[title] = (final_scores, action_level, action_name)
        if not writes:
            return summary
        with open(osp.join(output_path, "stream_summary.json"), "w") as f:
            json.dump(
                {
                    "frames_total": int(result.total_frames),
                    "frames_scored": len(result.frames),
                    "fps": result.fps,
                    "scores": scores_summary_block(summary),
                },
                f, indent=2,
            )
        return summary

    def _score_window(self, frames, local_ids: np.ndarray,
                      boxes: np.ndarray, start_idx: int, add_info: Dict,
                      reba, rula, result: StreamResult,
                      orig_local_ids: Optional[np.ndarray] = None) -> None:
        # Crop + pose from the raw uint8 frames, chunked by the window size
        # (the default frames_per_step chunk would pad a small window).
        # `frames` may be a device tensor (score_all's shared union
        # upload): local_ids then index it, and orig_local_ids carries the
        # window-relative frame numbers.
        euler, joint_cam, aa = self.estimator.run_from_frames(
            frames, local_ids, np.asarray(boxes, np.float32), chunk=self.window)
        if self.validate_rotations:
            validate_rotation_roundtrip(aa)
        _append_scores(result, reba, rula, euler, joint_cam, add_info)
        ids = local_ids if orig_local_ids is None else orig_local_ids
        result.frames.extend(int(start_idx + i) for i in ids)
