"""End-to-end video -> ergonomic-risk pipeline (the reference Predictor) in PyTorch.

Port of the JAX package's pipeline.py. Reference contract:
Predictor.__init__/__call__ (reference lib/core/base.py:76-209) -- video
ingest, multi-person tracking, target selection, 224x224 crops, SPIN pose
regression, joint-angle extraction, neutral-SMPL joint positions, REBA/RULA
scoring, stats, plots, annotated video, result txts and debug CSVs.

Device policy: every entry point runs on CUDA unless the caller passes
device="cpu"; with no device given and no CUDA present it raises, it never
carries on quietly on the CPU. On the card the crop goes through the
hand-written kernel (ops/resample.crop_batch_cuda); on the CPU through its
plain version.

Numerics: the strict (default) path turns TF32 off for cuDNN convolutions
and matmuls, which default to TF32 on Hopper and would break f32 parity
with the JAX reference. fast=True runs the ResNet backbone in bfloat16 on
bf16 crops, with the IEF head and everything after it in float32.

Not in this slice (each raises rather than degrading): the YOLOv3 detector
(DETECTOR.weights present), the debug_frame mesh export (needs the full
vertex LBS), int8 SPIN, mesh parallelism and the streaming scorer.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import Config, default_config
from poserisk_release_tpu_torch.io.video import read_video_parallel
from poserisk_release_tpu_torch.models import convert as model_convert
from poserisk_release_tpu_torch.models.detector import StubDetector
from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params
from poserisk_release_tpu_torch.ops.crop import crop_batch
from poserisk_release_tpu_torch.ops.lbs import smpl_params_to_torch
from poserisk_release_tpu_torch.outputs.render import render_result_video
from poserisk_release_tpu_torch.outputs.stats import (
    post_process_scores,
    print_result_summary,
    scores_summary_block,
    write_result_txt,
)
from poserisk_release_tpu_torch.outputs.writers import (
    pose_to_str,
    save_csv_pose_log,
    save_eval_pose_log_csv,
    save_score_log_csv,
)
from poserisk_release_tpu_torch.scoring.reba import REBAScorer
from poserisk_release_tpu_torch.scoring.rula import RULAScorer
from poserisk_release_tpu_torch.throughput import make_pose_core
from poserisk_release_tpu_torch.tracking.mpt import (
    MultiPersonTracker,
    filter_and_select_target,
    surviving_tracks,
)


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: the caller's device, else CUDA; with
    neither a device nor CUDA it raises instead of using the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run the "
            "port on the CPU")
    return device


def load_spin_variables(cfg: Config) -> Dict[str, torch.Tensor]:
    """SPIN weights as the port's HMR state_dict, resolved as the JAX
    package resolves them: converted-npz cache > torch checkpoint (converted
    once, init_* filled from the mean params, then cached in the same
    `.flax.npz` format) > random init from a fixed seed with the mean params.

    The cache embeds the checkpoint's (size, mtime_ns) stamp; any mismatch
    triggers re-conversion, so new weights dropped over the old checkpoint
    path are never shadowed by the previous conversion. Caches without a
    stamp fall back to the mtime ordering."""
    npz_path = cfg.SPIN.checkpoint + ".flax.npz"
    have_ckpt = osp.isfile(cfg.SPIN.checkpoint)
    if osp.isfile(npz_path):
        fresh = not have_ckpt
        if have_ckpt:
            stamp = model_convert.cached_source_stamp(npz_path)
            if stamp is not None:
                fresh = bool(np.array_equal(
                    stamp, model_convert.source_stamp(cfg.SPIN.checkpoint)))
            else:
                fresh = not (os.path.getmtime(cfg.SPIN.checkpoint)
                             > os.path.getmtime(npz_path))
        if fresh:
            return model_convert.flax_to_state_dict(
                model_convert.load_flax_variables(npz_path))
    mean = load_mean_params(cfg.SPIN.smpl_mean_params)
    if have_ckpt:
        variables = model_convert.spin_state_dict_to_flax(
            model_convert.load_spin_checkpoint(cfg.SPIN.checkpoint))
        for key in ("init_pose", "init_shape", "init_cam"):
            variables["params"].setdefault(key, mean[key])
        model_convert.save_flax_variables(variables, npz_path,
                                          source=cfg.SPIN.checkpoint)
        return model_convert.flax_to_state_dict(variables)
    return init_spin_params(torch.Generator().manual_seed(0), mean,
                            n_iter=cfg.SPIN.ief_iters)


def _pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 up to a multiple by repeating the last row."""
    n = x.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return x
    pad = multiple - n % multiple
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def _check_single_device(cfg: Config) -> None:
    pcfg = cfg.PARALLEL
    axes = {k: getattr(pcfg, k) for k in ("model", "spatial", "stage", "expert")}
    if any(v > 1 for v in axes.values()) or pcfg.num_devices > 1:
        raise NotImplementedError(
            f"PARALLEL {axes} / num_devices={pcfg.num_devices}: mesh "
            "parallelism is a later slice of the port (ROADMAP Queue 1 item 15)")


class PoseEstimator:
    """Crops -> (euler deg, joint_cam mm, axis-angle), chunked on one device."""

    def __init__(self, cfg: Config, smpl_family: SMPLFamily,
                 variables: Optional[Dict[str, torch.Tensor]] = None,
                 gender: str = "neutral", fast: bool = False, device=None):
        """variables: an HMR state_dict (models.convert.flax_to_state_dict
        turns the JAX package's Flax tree into one); None resolves them
        through load_spin_variables. fast=True runs the ResNet backbone in
        bfloat16 on bf16 crops; the default is the strict f32 configuration
        with TF32 off."""
        _check_single_device(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fast = bool(fast)
        if self.device.type == "cuda" and not self.fast:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        self._family = smpl_family
        self.gender = gender
        parents = np.asarray(smpl_family[gender].kintree_parents).copy()
        parents[0] = 0
        self.parents = tuple(int(p) for p in parents)
        self.smpl_params = smpl_params_to_torch(smpl_family[gender], self.device)

        # Pose-stride throughput mode (SpinConfig.pose_stride): SPIN runs on
        # every Nth tracked frame; skipped frames slerp between anchors.
        self._pose_stride = int(cfg.SPIN.pose_stride)
        if variables is None:
            variables = load_spin_variables(cfg)
        model = HMR(n_iter=cfg.SPIN.ief_iters)
        model.load_state_dict(variables)
        model.eval()
        if self.fast:
            model.cast_backbone(torch.bfloat16)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self._crop_dtype = torch.bfloat16 if self.fast else torch.float32
        self._pose_core = make_pose_core(self.parents, pose_stride=self._pose_stride)

    def set_gender(self, gender: str) -> None:
        """Switch the SMPL body model between tracks (--person_genders)."""
        if gender == self.gender:
            return
        self.smpl_params = smpl_params_to_torch(self._family[gender], self.device)
        self.gender = gender

    def _pose_step(self, crops: torch.Tensor):
        return self._pose_core(self.model, self.smpl_params, crops)

    def _pose_step_from_frames(self, frames_u8: torch.Tensor, bboxes: torch.Tensor):
        # Crop fused into the pose step: the host uploads raw uint8 frames
        # once and downloads only angles/joints.
        crops = crop_batch(
            frames_u8, bboxes,
            scale=float(self.cfg.DATASET.bbox_scale),
            out_size=int(self.cfg.MODEL.input_shape[0]),
            out_dtype=self._crop_dtype,
        )
        return self._pose_core(self.model, self.smpl_params, crops)

    def run(self, crops: np.ndarray, chunk: int = 0):
        """crops: (F, 224, 224, 3) float32 [0,1]. Chunked + padded execution;
        under pose_stride > 1 only every Nth crop is uploaded (the anchors)."""
        stride = self._pose_stride
        return self._run_chunked(
            crops.shape[0],
            lambda start, size: (crops[start : start + size : stride],),
            self._pose_step,
            chunk,
        )

    def run_from_frames(self, frames_rgb: np.ndarray, frame_ids: np.ndarray,
                        bboxes: np.ndarray, chunk: int = 0):
        """Crop + pose straight from raw uint8 frames (the Predictor's
        production path): only the tracked uint8 frames go up, only
        angles/joints come back. Under pose_stride > 1 only every Nth
        tracked frame is uploaded."""
        frame_ids = np.asarray(frame_ids)
        bboxes = np.asarray(bboxes, np.float32)
        stride = self._pose_stride
        return self._run_chunked(
            len(frame_ids),
            lambda start, size: (
                frames_rgb[frame_ids[start : start + size : stride]],
                bboxes[start : start + size : stride],
            ),
            self._pose_step_from_frames,
            chunk,
        )

    def production_chunk(self, chunk: int = 0) -> int:
        """THE chunk-size rule: the requested (or configured frames_per_step)
        chunk rounded up to a multiple of pose_stride, so the anchor phase
        stays aligned across chunks."""
        if chunk <= 0:
            chunk = self.cfg.PARALLEL.frames_per_step
        q = self._pose_stride
        return ((chunk + q - 1) // q) * q

    def _run_chunked(self, num_items: int, host_chunk, step_fn, chunk: int = 0):
        chunk = self.production_chunk(chunk)
        if num_items == 0:
            empty = np.zeros((0, 24, 3), np.float32)
            return empty, empty.copy(), empty.copy()

        def upload(start: int):
            # n_valid counts FRAMES (the step's output rows); under a pose
            # stride the uploaded parts are the anchor subsample.
            n_valid = min(chunk, num_items - start)
            batches = [
                torch.from_numpy(_pad_to_multiple(np.ascontiguousarray(part),
                                                  chunk // self._pose_stride))
                .to(self.device, non_blocking=True)
                for part in host_chunk(start, chunk)
            ]
            return batches, n_valid

        eulers, jcams, aas = [], [], []

        def fetch(out, start, n_valid, idx):
            # Per-chunk fault isolation: a failed fetch re-runs its chunk
            # once on the same device before surfacing with context.
            try:
                e, jc, aa = (x.cpu().numpy() for x in out)
            except RuntimeError:
                try:
                    batches, _ = upload(start)
                    with torch.inference_mode():
                        out = step_fn(*batches)
                    e, jc, aa = (x.cpu().numpy() for x in out)
                except RuntimeError as exc:
                    raise RuntimeError(
                        f"pose-estimation chunk {idx} (frames "
                        f"{start}..{start + n_valid - 1}) failed twice"
                    ) from exc
            eulers.append(e[:n_valid])
            jcams.append(jc[:n_valid])
            aas.append(aa[:n_valid])

        # Bounded pipelining: the host enqueues up to MAX_IN_FLIGHT chunks
        # ahead of the fetches, so the device overlaps chunks while at most
        # that many chunks' uint8 frames are resident at once.
        MAX_IN_FLIGHT = 4
        pending = []
        for start in range(0, num_items, chunk):
            if len(pending) >= MAX_IN_FLIGHT:
                out, s, nv = pending.pop(0)
                fetch(out, s, nv, len(eulers))
            batches, n_valid = upload(start)
            with torch.inference_mode():
                pending.append((step_fn(*batches), start, n_valid))
            del batches
        for out, s, nv in pending:
            fetch(out, s, nv, len(eulers))
        return np.concatenate(eulers), np.concatenate(jcams), np.concatenate(aas)


def validate_rotation_roundtrip(axis_angles) -> None:
    """Host-side euler round-trip guard mirroring the reference's
    coord_utils assert (--validate_rotations). Joint 0 is excluded: its
    axis-angle is root-forced to (3.14, 0, 0) while its euler keeps the
    original rotmat."""
    from poserisk_release_tpu_torch.ops.rotations import (
        assert_euler_roundtrip,
        axis_angle_to_rotmat,
    )

    aa = torch.as_tensor(np.asarray(axis_angles, np.float32)[:, 1:, :])
    assert_euler_roundtrip(axis_angle_to_rotmat(aa))


def build_detector(cfg: Config):
    """The Predictor's detector policy: with DETECTOR.weights present the
    YOLOv3 detector would run, which is a later slice of the port, so that
    raises rather than silently using the stub; without weights the
    full-frame StubDetector keeps weight-free environments runnable."""
    if osp.isfile(cfg.DETECTOR.weights):
        raise NotImplementedError(
            f"detector weights found at {cfg.DETECTOR.weights}: the YOLOv3 "
            "detector is a later slice of the port (ROADMAP Queue 1 item 10)")
    print("[poserisk] no detector weights found; using full-frame stub detector")
    return StubDetector()


def load_add_info(cfg: Config, info_path: str) -> Dict:
    """Additional-information JSON with the reference's default fallback
    (base.py:137-142): a missing --info path falls back to the packaged
    default_information.json."""
    path = info_path if osp.isfile(info_path) else cfg.DATASET.default_information
    with open(path) as f:
        return json.load(f)


class Predictor:
    """Reference-compatible orchestrator. See module docstring."""

    def __init__(
        self,
        cfg: Config | None = None,
        score_type: str = "REBA,RULA",
        debug: bool = False,
        debug_joints: str = "",
        debug_frame: int = -1,
        visualize: bool = True,
        detector=None,
        spin_variables=None,
        allow_synthetic_assets: bool = True,
        gender: str = "neutral",
        multi_person: bool = False,
        person_genders: Optional[Dict] = None,
        fast: bool = False,
        validate_rotations: bool = False,
        device=None,
    ):
        if debug and debug_frame >= 0:
            raise NotImplementedError(
                "--debug_frame exports the SMPL mesh, which needs the full "
                "vertex LBS and its kernel (ROADMAP Queue 2, K4): a later "
                "slice of the port")
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        self.smpl = SMPLFamily(self.cfg.SPIN.smpl_model_dir, allow_synthetic=allow_synthetic_assets)
        self.gender = gender
        self.multi_person = multi_person
        self.person_genders = {
            int(pid): g for pid, g in (person_genders or {}).items()
        }
        for g in self.person_genders.values():
            if g not in ("neutral", "male", "female"):
                raise ValueError(f"Invalid gender: {g}")
        self.pose_estimator = PoseEstimator(
            self.cfg, self.smpl, variables=spin_variables, gender=gender,
            fast=fast, device=self.device,
        )

        if detector is None:
            detector = build_detector(self.cfg)
        self.tracker = MultiPersonTracker(
            detector, detection_stride=int(self.cfg.DETECTOR.detection_stride),
            adaptive=bool(self.cfg.DETECTOR.adaptive_stride),
            adaptive_tol=float(self.cfg.DETECTOR.adaptive_tol))

        self.reba = REBAScorer(debug, device=self.device)
        self.rula = RULAScorer(debug, device=self.device)
        scores = score_type.replace(" ", "").upper().split(",")
        self.run_reba = "REBA" in scores
        self.run_rula = "RULA" in scores

        self.debugging = debug
        self.visualize = visualize
        joints = debug_joints.replace(" ", "").split(",")
        if joints == [""]:
            self.debug_joints = None
        else:
            for joint in joints:
                if joint.upper() not in self.smpl.joints_name_upper:
                    raise ValueError(f"Invalid Joint name: {joint}")
            self.debug_joints = joints
        self.validate_rotations = validate_rotations
        self.timings: Dict[str, float] = {}

    def __call__(self, input_path: str, info_path: str, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self.timings = {}

        print("\n===> Data preprocessing...")
        if self.cfg.DATASET.jpeg_ingest:
            t0 = time.time()
            clip = read_video_parallel(input_path, self.cfg.DATASET.decode_workers)
            from poserisk_release_tpu_torch.io.video import jpeg_roundtrip

            # Reference-parity ingest: frames take the '%09d.jpg' disk round
            # trip (funcs_utils.py:42) before detection/cropping.
            tmp = osp.join(output_path, "tmp")
            clip = jpeg_roundtrip(clip, tmp_path=tmp)
            shutil.rmtree(tmp, ignore_errors=True)
            self.timings["decode"] = time.time() - t0

            t0 = time.time()
            print("\n===> Get human tracking results...")
            tracking_results = self.tracker(clip.frames)
            self.timings["track"] = time.time() - t0
        else:
            t0 = time.time()
            print("\n===> Get human tracking results (overlapped with decode)...")
            clip, tracking_results = self._ingest_and_track_overlapped(input_path)
            self.timings["decode+track (overlapped)"] = time.time() - t0

        if self.multi_person:
            # Extension over the reference: score every track surviving the
            # min-frames filter, one output dir each.
            survivors = surviving_tracks(
                tracking_results, clip.num_frames,
                self.cfg.DATASET.min_frame_ratio,
            )
            if not survivors:
                raise ValueError("no person tracks found in the clip")
            summaries = {}
            try:
                for pid, track in survivors.items():
                    person_out = osp.join(output_path, f"person_{pid}")
                    os.makedirs(person_out, exist_ok=True)
                    self.pose_estimator.set_gender(
                        self.person_genders.get(int(pid), self.gender))
                    summaries[pid] = self._process_track(
                        clip, track["bbox"], track["frames"], info_path,
                        person_out
                    )
            finally:
                # A failed track must not leave the shared estimator on ITS
                # gender for the caller's next video.
                self.pose_estimator.set_gender(self.gender)
            return summaries

        bboxes, frames = filter_and_select_target(
            tracking_results, clip.num_frames,
            self.cfg.DATASET.min_frame_ratio,
        )
        return self._process_track(clip, bboxes, frames, info_path, output_path)

    def _ingest_and_track_overlapped(self, input_path: str,
                                     window: int | None = None):
        """Decode windows on a background thread (io.video._window_stream)
        and feed them straight into the tracker, so detection of window k
        runs while window k+1 decodes. Frames are retained for the crop and
        render stages."""
        from poserisk_release_tpu_torch.io.video import VideoClip, _window_stream

        if window is None:
            window = int(self.cfg.DETECTOR.batch_size)
        fps = 0.0
        pieces = []

        def windows():
            nonlocal fps
            for item in _window_stream(input_path, window, None,
                                       self.cfg.DATASET.decode_workers):
                if item[0] == "meta":
                    fps = float(item[1])
                elif item[0] == "window":
                    pieces.append(item[2])
                    yield item[1], item[2]

        tracking_results = self.tracker.track_windows(windows())
        if not pieces:
            raise ValueError(f"video decoded to zero frames: {input_path}")
        clip = VideoClip(frames=np.concatenate(pieces), fps=fps)
        return clip, tracking_results

    def _process_track(self, clip, bboxes, frames, info_path, output_path):
        debug_path = osp.join(output_path, "debug")
        shutil.rmtree(debug_path, ignore_errors=True)
        os.makedirs(debug_path, exist_ok=True)
        timestamp = (0, frames, clip.num_frames)
        # Per-track stage keys start fresh (under --multi_person this runs
        # once per person within one __call__).
        for key in ("pose", "score", "score.device", "score.render"):
            self.timings.pop(key, None)

        t0 = time.time()
        print("\n===> Estimate human pose...")
        result, joint_cam, axis_angles = self.pose_estimator.run_from_frames(
            clip.frames, frames, bboxes
        )
        self.timings["pose"] = time.time() - t0

        if self.validate_rotations:
            validate_rotation_roundtrip(axis_angles)

        add_info = load_add_info(self.cfg, info_path)

        pose_str = pose_to_str(result)
        if self.debugging and self.debug_joints is not None:
            save_csv_pose_log(
                pose_str, timestamp, self.debug_joints,
                self.smpl.joints_name_upper, debug_path,
            )

        print("\n===> Post Processing...")
        summary = {}
        t0 = time.time()
        for title, scorer, enabled in (
            ("REBA", self.reba, self.run_reba),
            ("RULA", self.rula, self.run_rula),
        ):
            if not enabled:
                continue
            t1 = time.time()
            results = scorer(result, joint_cam, add_info)
            self.timings["score.device"] = (
                self.timings.get("score.device", 0.0) + time.time() - t1
            )
            final_scores, scores, logs = post_process_scores(
                results, timestamp, output_path, title=title
            )
            if self.visualize:
                t1 = time.time()
                render_result_video(
                    clip.frames, bboxes, timestamp, clip.fps,
                    scores, scorer.eval_items, logs, output_path, title=title,
                )
                self.timings["score.render"] = (
                    self.timings.get("score.render", 0.0) + time.time() - t1
                )
            if self.debugging:
                save_score_log_csv(timestamp, scores, scorer.eval_items, logs, debug_path, title)
                save_eval_pose_log_csv(timestamp, scorer.log, debug_path, title)

            action_level, action_name = scorer.action_level(final_scores[4])
            write_result_txt(output_path, title, final_scores, action_level, action_name)
            summary[title] = (final_scores, action_level, action_name)
        self.timings["score"] = time.time() - t0

        with open(osp.join(output_path, "run_summary.json"), "w") as f:
            json.dump(
                {
                    "frames_total": int(timestamp[2]),
                    "frames_tracked": int(len(frames)),
                    "device": str(self.device),
                    "timings_sec": {k: round(v, 4) for k, v in self.timings.items()},
                    "scores": scores_summary_block(summary),
                },
                f,
                indent=2,
            )

        print("\n\n===> DONE!")
        print("Result files saved in ", output_path)
        print_result_summary(summary)
        return summary
