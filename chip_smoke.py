"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
started together), holds each against its plain PyTorch version at the main
paths' shapes (and times kernel, plain version, one library call and the
bound), then drives the port's main paths, each with every kernel launch
counter set to 0 just before it and read just after:

* the pose path the way the Predictor does -- StubDetector ->
  MultiPersonTracker -> target selection -> PoseEstimator.run_from_frames
  (64-frame chunks, ResNet-50 + 3-step IEF at full width, seeded random
  weights, synthetic SMPL) -> REBA/RULA scorers -> stats and result txts --
  once strict (f32) and once fast (bf16); the card's strict output is held
  against the port's CPU path on a small input;
* the detector path: YoloDetector (YOLOv3, all 75 convs at full width, the
  seed-0 init BN-folded, the Predictor's square 416 canvas, 64-frame
  batches) under MultiPersonTracker; its tower and kept boxes are held
  against the port's CPU path on 2 frames;
* the full-frame step (throughput.make_full_frame_step) over 128 frames in
  64-frame chunks: strict f32 at strides 1/1 and fast bf16 at strides 8/8,
  both through the fused letterbox + crop kernel, each held against the
  unfused step;
* the streaming scorer (streaming.StreamingScorer, --streaming) at full
  width, window 64, fed by an in-memory window stream: two-pass at
  pose_stride 1 (equal to the batch path's scores on 256 frames), at
  pose_stride 2 and fast with the int8 backbone; online at detection_stride
  4; score_all with two people (its shared union upload on the card); and
  the device memory peak over 256 and 1024 frames, which must not grow;
* the request-batching server (serving.PoseScoringServer, one CUDA graph
  per bucket of the ladder 1/4/16/64) strict, fast and int8, each bucket
  equal to the eager step; a closed loop of 16 clients; and three
  StreamSessions on threads, equal to the online streaming scorer;
* the --debug_frame mesh: Predictor._save_debug_mesh (LBS on the card);
* the int8 detector path (--fast_detector): YoloDetector(int8=True,
  rect=True) calibrated explicitly on the first 64 frames, then under
  MultiPersonTracker; its int8 heads and kept boxes are held against the
  port's CPU int8 path on 2 frames;
* the pose path fast with the int8 SPIN backbone (--spin_int8), held
  against the CPU int8 path on 4 frames (same quantized backbone);
* the full-frame step fast at strides 8/8 with the int8 detector and the
  int8 backbone (the JAX bench's production configuration), through K2,
  held against the unfused step;
* the mesh layouts (parallel_path): dp 2 x tp 2, dp 2 x pp 2 (2
  microbatches), ep 4, dp 4, sp 4, dp 2 x sp 2 (also fast and int8) and
  tp 2 x sp 2, each driving PoseEstimator.run_from_frames over one
  64-frame chunk of tracked frames at full width on 4 ranks (spawned
  processes; NCCL with one card per rank where there are enough cards,
  else ranks sharing cuda:0 over gloo, staged through the host); scores
  equal the single-card step's, Euler and joints within the CPU tests'
  limits, each rank's halo-exchange bytes equal the count from the
  geometry, sp 4's peak memory a rank stays below 0.6 of ep 4's, and every
  data rank on stage 0 launches K1; then, under dp 2 x sp 2 on the same
  ranks, the streaming scorer over 128 frames and one server request,
  each equal to the single card's;
* the data preparation (data_prep): tools/data_preprocessing.person_chunks
  on the tracked frames and io/images.get_single_image_crop, both through
  K1, equal to the plain crop exactly (the chunks' uint8 BGR images, and
  K1 on each chunk's frames in f32);
* training (train_single): train.step.TrainState at full width, 64 crops
  of 224x224 from K1, adam, six steps with whole-backbone remat and six
  without (ms per step, max_memory_allocated), a checkpoint round trip into
  PoseEstimator equal to the trained model's forward, and one SGD step at
  B = 2 held against the port's CPU step, its update leaf by leaf;
* training under a mesh (train_mesh): one SGD step at B = 16 under dp 4
  and dp 2 x tp 2 on 4 spawned ranks (sharing cuda:0 over gloo on a
  one-card machine), each equal to the single-card step (its update leaf
  by leaf), K1 on every rank;
* the port's bench (bench_phase: poserisk_release_tpu_torch.bench in-process
  at B = 128, two passes, strict on), whose record must carry the root
  bench.py's keys plus device, power_limit and the peak bytes;
* the port's measurement tools (tools_phase), in-process at reduced sizes:
  tools/profile_stages at B = 32 (K1 and K2 launch), roofline_detector's
  three largest conv classes with bf16 and its chain mode on the first
  stage, roofline_spin on the first stage, bench_e2e (the Predictor's wall
  clock) on 128 synthetic frames without plots, and graft_entry.entry()
  held against a direct call of the pose + score step;
* the mesh dry run (dryrun_phase: graft_entry.dryrun_multichip(4), the
  JAX repo's __graft_entry__.dryrun_multichip on 4 spawned ranks sharing
  cuda:0 over gloo on a one-card machine): dp over frames, the score
  histogram, the full-frame step f32 / int8 + bf16 / pose stride, K2
  alone, tp / sp / pp / ep through the config path and a dp 2 x tp 2
  training step, each section held against the single-process step; K1
  and K2 launched on every rank whose sections crop;
* the JAX repo's last tools (experiments_phase), in-process at reduced
  sizes: exp_resample, exp_det_stride, exp_pose_stride (b512 at 128
  frames), exp_mixed_int8, exp_spin_mixed, exp_int8_glue and
  exp_spin_early at B = 32, one pass; 2 StreamSessions x 8 frames; the
  streaming soak over 512 frames; the reference hot loop on 16 frames with
  the port's step beside it; validate_real_assets with no asset, every
  section skipped;
* the training augmentation crop (augment_check: ops/crop.crop_batch_affine
  with rotation, flip and colour scale) on the card against the CPU;
* the experiment paths of K5 (tools/exp_fused_stage: the fused int8
  residual stage against its plain version and the per-conv int8 chain, at
  the three stage shapes) and K3 with K1m (tools/exp_window_crop: the
  windowed crop against its plain version and K1, windows 384 and 512; K1
  with 2 and 4 frames per block against the plain crop).

The Predictor's own video decode needs opencv and its plots matplotlib,
which the card's machine need not have, so frames are made with numpy and
no figure is drawn.

Prints one line per phase, then a JSON line with every kernel's numbers,
the nvidia-smi name/power-limit line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0,
no last line). Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES, FRAME_HW, CHUNK, OUT = 128, (450, 800), 64, 224


def time_ms(fn, **kw) -> float:
    """Device milliseconds of one fn() call on the card: the port's
    tools/timing.time_ms (median of CUDA-event samples, each enqueued while
    the card sleeps, so it holds device time and not launch overhead)."""
    from poserisk_release_tpu_torch.tools.timing import time_ms as device_time_ms

    return device_time_ms(fn, "cuda", **kw)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def elapsed_ms(fn, device) -> float:
    """Milliseconds of one fn() call: CUDA-event time on the card (the
    stream's time from the first launch to the last, idle gaps included),
    the host clock elsewhere."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def reset_launch_counts() -> None:
    from poserisk_release_tpu_torch.ops.resample import (
        crop_batch_cuda,
        crop_batch_multi_cuda,
        crop_batch_windowed_cuda,
        fused_letterbox_crop_cuda,
    )
    from poserisk_release_tpu_torch.ops.skin import skin_vertices_cuda
    from poserisk_release_tpu_torch.ops.yolo_stage import fused_residual_stage_cuda

    crop_batch_cuda.launches = fused_letterbox_crop_cuda.launches = 0
    skin_vertices_cuda.launches = crop_batch_windowed_cuda.launches = 0
    fused_residual_stage_cuda.launches = crop_batch_multi_cuda.launches = 0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_frames(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Smooth background, a moving bright 'person' block, and sensor noise."""
    H, W = FRAME_HW
    yy, xx = np.mgrid[0:H, 0:W]
    base = (60 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 23.0)).astype(np.float32)
    frames = np.empty((n, H, W, 3), np.uint8)
    for i in range(n):
        img = np.repeat(base[:, :, None], 3, axis=2) + rng.normal(0, 6, (H, W, 3))
        x = 250 + 2 * i
        img[60:420, x:x + 180] = (180, 150, 120)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def crop_bytes(bboxes: np.ndarray, H: int, W: int, out_bytes: int) -> int:
    """Bytes the crop must move: each output written once, and per frame
    each source pixel that a nonzero tap reads, read once."""
    from poserisk_release_tpu_torch.ops.crop import axis_taps, crop_coords

    ys, xs = crop_coords(torch.as_tensor(bboxes, dtype=torch.float32), 1.2, OUT)
    total = bboxes.shape[0] * OUT * OUT * 3 * out_bytes
    for b in range(bboxes.shape[0]):
        counts = []
        for coords, size in ((ys[b], H), (xs[b], W)):
            i0, i1, w0, w1 = axis_taps(coords, size)
            idx = torch.cat([i0[w0 != 0], i1[w1 != 0]])
            counts.append(int(torch.unique(idx).numel()))
        total += counts[0] * counts[1] * 3
    return total


def crop_row(name, replaces, launches, err, ms, plain_ms, n_bytes, library_ms) -> dict:
    """A crop kernel's entry of the kernels line (f32 output, B = CHUNK):
    the bound is the larger of n_bytes over the memory rate and ~10 f32
    operations per output value over the f32 rate."""
    from poserisk_release_tpu_torch.tools.timing import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = CHUNK * OUT * OUT * 3 * 10 / FP32_FLOPS_PER_S
    return {"name": name, "route": "cuda", "source": "poserisk_release_tpu_torch/csrc/crop.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def check_inputs(device, seed):
    """CHUNK seeded noise frames of FRAME_HW and their boxes: the edge boxes
    (centred, small off-centre, straddling the right/bottom border, partly
    outside) then random ones, some reaching past the frame."""
    rng = np.random.RandomState(seed)
    H, W = FRAME_HW
    frames = torch.as_tensor(rng.randint(0, 256, (CHUNK, H, W, 3)).astype(np.uint8), device=device)
    edge = np.array([[400.0, 225.0, 220.0, 220.0], [100.0, 80.0, 60.0, 120.0],
                     [780.0, 440.0, 100.0, 50.0], [-20.0, 10.0, 80.0, 80.0]], np.float32)
    side = rng.uniform(40, 520, CHUNK - 4)
    rand = np.stack([rng.uniform(-60, W + 60, CHUNK - 4), rng.uniform(-60, H + 60, CHUNK - 4),
                     side, side], axis=1).astype(np.float32)
    return frames, torch.as_tensor(np.concatenate([edge, rand]), device=device)


def grid_sample_crop(f: torch.Tensor, bb: torch.Tensor):
    """Yardstick only (the port never calls it): a call of F.grid_sample
    computing the f32 bbox crop of (B, H, W, 3) uint8 frames with the same
    sampling (align_corners=True maps -1/+1 to pixel centres 0 and size-1,
    zero padding), on frames already converted to float NCHW."""
    import torch.nn.functional as F

    from poserisk_release_tpu_torch.ops.crop import crop_coords

    H, W = f.shape[1:3]
    ys, xs = crop_coords(bb, 1.2, OUT)
    grid = torch.stack([
        (2.0 * xs / (W - 1) - 1.0)[:, None, :].expand(-1, OUT, -1),
        (2.0 * ys / (H - 1) - 1.0)[:, :, None].expand(-1, -1, OUT)], dim=-1)
    f_nchw = f.permute(0, 3, 1, 2).float() / 255.0
    return lambda: F.grid_sample(f_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


def check_crop_kernel(device, main_frames, main_bboxes) -> dict:
    """K1 against its plain version on the card, then timings at the main
    path's shapes (one 64-frame chunk of tracked 450x800 frames)."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch_plain
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

    frames, bboxes = check_inputs(device, seed=0)
    H, W = FRAME_HW

    got32 = crop_batch_cuda(frames, bboxes)
    got16 = crop_batch_cuda(frames, bboxes, out_dtype=torch.bfloat16)
    want32 = crop_batch_plain(frames, bboxes)
    torch.cuda.synchronize()
    err32 = float((got32 - want32).abs().max())
    err16 = float((got16.float() - want32).abs().max())
    print(json.dumps({"phase": "crop_check", "frames": list(frames.shape),
                      "f32_max_abs_err": err32, "bf16_max_abs_err_vs_f32": err16}))
    if not err32 <= 1e-5:
        raise AssertionError(f"crop kernel f32 disagrees with its plain version: {err32}")
    if not err16 <= 4.0 / 255.0:
        raise AssertionError(f"crop kernel bf16 off by {err16} > 4/255")

    # Timings on the main path's own input: the first tracked chunk.
    f = torch.as_tensor(main_frames[:CHUNK], device=device)
    bb = torch.as_tensor(main_bboxes[:CHUNK], dtype=torch.float32, device=device).contiguous()
    ms = time_ms(lambda: crop_batch_cuda(f, bb))
    ms16 = time_ms(lambda: crop_batch_cuda(f, bb, out_dtype=torch.bfloat16))
    plain_ms = time_ms(lambda: crop_batch_plain(f, bb))
    library = grid_sample_crop(f, bb)
    lib_err = float((library().permute(0, 2, 3, 1) - crop_batch_cuda(f, bb)).abs().max())
    library_ms = time_ms(library)
    n_bytes = crop_bytes(main_bboxes[:CHUNK], H, W, 4)
    # launches: the main path's count, filled in by main().
    row = crop_row("crop_batch_cuda", "poserisk_release_tpu/ops/resample_pallas.py:426", None,
                   err32, ms, plain_ms, n_bytes, library_ms)
    print(json.dumps({"phase": "crop_timing", "shape": [CHUNK, H, W, 3],
                      "bytes": n_bytes, "ms_f32": ms, "ms_bf16": ms16,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "library_max_abs_err": lib_err, "bound_ms": row["bound_ms"]}))
    return row


def main_path(device, frames, fast: bool, variables, smpl, cfg, cpu_ref=None,
              spin_int8: bool = False):
    """Drive the pose path once; returns (K1 launches, axis-angles, tracked
    frame ids, the estimator). With spin_int8 the estimator calibrates its
    int8 backbone on the warm-up call's first 8 crops."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.outputs.stats import post_process_scores, write_result_txt
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_add_info
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker, filter_and_select_target

    est = PoseEstimator(cfg, smpl, variables=variables, fast=fast, spin_int8=spin_int8,
                        device=device)
    est.run_from_frames(frames, np.arange(CHUNK), np.tile([[400.0, 225.0, 400.0, 400.0]],
                                                           (CHUNK, 1)))  # warm-up
    sync(device)

    reset_launch_counts()
    t = {}
    t0 = time.perf_counter()
    tracks = MultiPersonTracker(StubDetector()).track_windows(
        (s, frames[s:s + 64]) for s in range(0, len(frames), 64))
    bboxes, track_frames = filter_and_select_target(tracks, len(frames), 0.33)
    t["track"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    euler, joint_cam, aa = est.run_from_frames(frames, track_frames, bboxes, chunk=CHUNK)
    t["pose"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = load_add_info(cfg, "")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    scores = {}
    for title, scorer in (("REBA", REBAScorer(device=device)), ("RULA", RULAScorer(device=device))):
        results = scorer(euler, joint_cam, info)
        final, per_frame, _ = post_process_scores(
            results, (0, track_frames, len(frames)), out_dir, title, make_plot=False)
        level, name = scorer.action_level(final[4])
        write_result_txt(out_dir, title, final, level, name)
        scores[title] = np.asarray(per_frame)
    t["score+outputs"] = time.perf_counter() - t0
    launches = crop_batch_cuda.launches

    n = len(track_frames)
    for name, arr in (("euler", euler), ("joint_cam", joint_cam), ("aa", aa)):
        if arr.shape != (n, 24, 3) or not np.isfinite(arr).all():
            raise AssertionError(f"{name}: shape {arr.shape} or non-finite values")
    if not (scores["REBA"].min() >= 1 and scores["REBA"].max() <= 12
            and scores["RULA"].min() >= 1 and scores["RULA"].max() <= 7):
        raise AssertionError(f"scores out of range: {scores}")
    for title in ("reba", "rula"):
        if not os.path.getsize(os.path.join(out_dir, f"{title}_result.txt")):
            raise AssertionError(f"empty {title}_result.txt")
    # Where one chunk's device time goes (after the counts were read, so
    # these launches are not the main path's).
    from poserisk_release_tpu_torch.ops.crop import crop_batch

    f = torch.as_tensor(frames[track_frames[:CHUNK]], device=device)
    bb = torch.as_tensor(np.asarray(bboxes[:CHUNK], np.float32), device=device)
    with torch.inference_mode():
        crops = crop_batch(f, bb, out_dtype=torch.bfloat16 if fast else torch.float32)
        if spin_int8:
            from poserisk_release_tpu_torch.models.spin import hmr_forward_quant

            def hmr():
                return hmr_forward_quant(est._quant_backbone, est.model, crops, crops.dtype)
        else:
            def hmr():
                return est.model(crops)

        chunk_ms = {"crop": time_ms(lambda: crop_batch(f, bb, out_dtype=crops.dtype)),
                    "hmr": time_ms(hmr, per_rep=2),
                    "pose_step": time_ms(lambda: est._pose_step_from_frames(f, bb), per_rep=2)}
    chunk_ms["rotations+joints"] = chunk_ms["pose_step"] - chunk_ms["hmr"] - chunk_ms["crop"]
    line = {"phase": ("main_path_fast" if fast else "main_path_strict")
            + ("_spin_int8" if spin_int8 else ""),
            "frames": len(frames), "tracked": n, "crop_launches": launches,
            "pose_frames_per_s": n / t["pose"], "stage_s": t, "chunk_ms": chunk_ms,
            "reba_mode": int(np.bincount(scores["REBA"]).argmax()),
            "rula_mode": int(np.bincount(scores["RULA"]).argmax())}
    if cpu_ref is not None:
        ref_euler, ref_joints = cpu_ref(bboxes, track_frames, est)
        k = ref_euler.shape[0]
        d_e = np.abs(euler[:k] - ref_euler)
        d_e = float(np.minimum(d_e, 360.0 - d_e).max())
        d_j = float(np.abs(joint_cam[:k] - ref_joints).max())
        same = all([r["score"] for r in scorer(euler[:k], None, info)]
                   == [r["score"] for r in scorer(ref_euler, None, info)]
                   for scorer in (REBAScorer(device="cpu"), RULAScorer(device="cpu")))
        line.update(cpu_ref_frames=k, euler_max_abs_diff_deg=d_e, joint_max_abs_diff_mm=d_j,
                    cpu_ref_scores_equal=same)
        if not (d_e < 0.05 and d_j < 0.05 and same):
            raise AssertionError(
                f"card vs CPU path: euler {d_e} deg, joints {d_j} mm, scores equal {same}")
    print(json.dumps(line))
    if launches <= 0:
        raise AssertionError("the main path launched no crop kernel")
    return launches, aa, track_frames, est


STRIDE_TRIPLES = [(1, 1, 1), (2, 2, 1), (4, 1, 1), (2, 1, 2), (1, 4, 1), (1, 1, 8), (1, 2, 4),
                  (2, 4, 1)]  # (frame, det, crop) strides; tests/test_pose_stride.py's and 1/1/1


def _taps_read(i0, i1, w0, w1) -> set:
    """The source indices one axis's nonzero taps read."""
    return set(np.asarray(i0)[np.asarray(w0) != 0].tolist()) | set(
        np.asarray(i1)[np.asarray(w1) != 0].tolist())


def letterbox_crop_bytes(bboxes, H: int, W: int, out_bytes: int, rect: bool = True,
                         n_frames: int = 0) -> int:
    """Bytes K2 must move on the rect (or square) 416 canvas: each output
    written once, and per frame each source pixel that a nonzero letterbox
    or crop tap reads, read once (the union of the two windows). bboxes
    (n, 4) are the boxes of the frames the kernel reads (frames[::frame_stride]);
    bboxes=None is the letterbox-only mode on n_frames frames."""
    from poserisk_release_tpu_torch.ops.crop import axis_taps, crop_coords, letterbox_taps

    rows, cols, CH, CW = letterbox_taps(H, W, 416, rect)
    lr, lc = _taps_read(*rows), _taps_read(*cols)
    if bboxes is None:
        return n_frames * (CH * CW * 3 * out_bytes + len(lr) * len(lc) * 3)
    ys, xs = crop_coords(torch.as_tensor(bboxes, dtype=torch.float32), 1.2, OUT)
    total = bboxes.shape[0] * (CH * CW + OUT * OUT) * 3 * out_bytes
    for b in range(bboxes.shape[0]):
        cr, cc = _taps_read(*axis_taps(ys[b], H)), _taps_read(*axis_taps(xs[b], W))
        total += (len(lr) * len(lc) + len(cr) * len(cc) - len(lr & cr) * len(lc & cc)) * 3
    return total


def k2_bound(bboxes, H: int, W: int, out_bytes: int, rect: bool = True,
             n_frames: int = 0) -> tuple:
    """(bound ms, 'bytes' | 'operations', bytes) of one K2 call:
    letterbox_crop_bytes over the memory rate against ~10 f32 operations
    per output value over the f32 rate."""
    from poserisk_release_tpu_torch.ops.crop import canvas_geometry
    from poserisk_release_tpu_torch.tools.timing import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

    CH, CW = canvas_geometry(H, W, 416, rect)[:2]
    n = n_frames if bboxes is None else bboxes.shape[0]
    n_bytes = letterbox_crop_bytes(bboxes, H, W, out_bytes, rect, n_frames)
    n_flops = n * (CH * CW + (0 if bboxes is None else OUT * OUT)) * 3 * 10
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes


def edge_boxes(B: int, H: int, W: int, seed: int) -> np.ndarray:
    """Tiny (upscaled crops), huge, partly and wholly outside the frame,
    then random boxes, cycled over B frames."""
    rng = np.random.RandomState(seed)
    edge = [[W / 2, H / 2, 3.0, 2.0], [W / 3, H / 4, 0.5, 0.7], [W / 2, H / 2, 4 * W, 3 * H],
            [-10.0, H + 5.0, 0.8 * W, 0.8 * H], [W - 5.0, 2.0, 90.0, 70.0],
            [-5 * W, H / 2, 40.0, 40.0], [W / 2, 4 * H, 60.0, 60.0]]
    rand = np.stack([rng.uniform(-60, W + 60, B), rng.uniform(-60, H + 60, B),
                     rng.uniform(2, 1.5 * W, B), rng.uniform(2, 1.5 * H, B)], 1)
    return np.concatenate([edge, rand])[:B].astype(np.float32)


def check_letterbox_crop_kernel(device, main_frames, main_bboxes) -> dict:
    """K2 against its plain version on the card at every stride triple and
    in both letterbox-only modes, then at other frame sizes (449x797:
    unaligned rows; 240x320: upscaling; 1080x1920) with edge boxes and on a
    batch slice from an odd frame; then timings at the main paths' four
    shapes (tools/exp_k2_k4: one 64-frame chunk of tracked 450x800 frames;
    f32 and bf16 at strides 1/1, bf16 at frame_stride 8, square f32
    letterbox-only), each beside its bound."""
    import torch.nn.functional as F

    from poserisk_release_tpu_torch.ops.crop import GRAY, canvas_geometry, crop_coords, letterbox_plain
    from poserisk_release_tpu_torch.ops.resample import (
        fused_letterbox_crop_cuda,
        fused_letterbox_crop_plain,
    )
    from poserisk_release_tpu_torch.tools.exp_k2_k4 import k2_cases, k2_times

    frames, bboxes = check_inputs(device, seed=1)
    H, W = FRAME_HW
    errs = {}
    for g, d, p in STRIDE_TRIPLES:
        kw = dict(det_stride=d, crop_stride=p, frame_stride=g)
        want = fused_letterbox_crop_plain(frames, bboxes, **kw)
        got32 = fused_letterbox_crop_cuda(frames, bboxes, **kw)
        got16 = fused_letterbox_crop_cuda(frames, bboxes, out_dtype=torch.bfloat16, **kw)
        sync(device)
        errs[f"{g}/{d}/{p}"] = (
            max(float((a - b).abs().max()) for a, b in zip(got32, want)),
            max(float((a.float() - b).abs().max()) for a, b in zip(got16, want)))
    for rect in (False, True):
        want = letterbox_plain(frames, 416, rect=rect)
        got32 = fused_letterbox_crop_cuda(frames, None, rect=rect)[0]
        got16 = fused_letterbox_crop_cuda(frames, None, rect=rect, out_dtype=torch.bfloat16)[0]
        sync(device)
        errs["rect" if rect else "square"] = (float((got32 - want).abs().max()),
                                              float((got16.float() - want).abs().max()))
    rng = np.random.RandomState(4)
    for hw in ((449, 797), (240, 320), (1080, 1920)):
        f = torch.as_tensor(rng.randint(0, 256, (9,) + hw + (3,)).astype(np.uint8), device=device)
        bb = torch.as_tensor(edge_boxes(9, hw[0], hw[1], 5), device=device)
        for rect in (True, False):  # the batch slice frames[1::2] starts at an odd frame
            for ff, b in ((f, bb), (f[1::2], bb[1::2].contiguous())):
                want = fused_letterbox_crop_plain(ff, b, rect=rect)
                got32 = fused_letterbox_crop_cuda(ff, b, rect=rect)
                got16 = fused_letterbox_crop_cuda(ff, b, rect=rect, out_dtype=torch.bfloat16)
                sync(device)
                key = f"{hw[0]}x{hw[1]}{'' if rect else ' square'}{' slice' if b is not bb else ''}"
                errs[key] = (max(float((a - w).abs().max()) for a, w in zip(got32, want)),
                             max(float((a.float() - w).abs().max()) for a, w in zip(got16, want)))
    err32 = max(e[0] for e in errs.values())
    err16 = max(e[1] for e in errs.values())
    print(json.dumps({"phase": "letterbox_crop_check", "frames": list(frames.shape),
                      "f32_bf16_max_abs_err": errs}))
    if not err32 == 0.0:
        raise AssertionError(f"letterbox+crop kernel f32 disagrees with its plain version: {errs}")
    if not err16 <= 4.0 / 255.0:
        raise AssertionError(f"letterbox+crop kernel bf16 off by more than 4/255: {errs}")

    f = torch.as_tensor(main_frames[:CHUNK], device=device)
    bb = torch.as_tensor(main_bboxes[:CHUNK], dtype=torch.float32, device=device).contiguous()
    times = k2_times(f, bb)  # each case bit-equal to the plain version first
    shapes = {}
    for case, (kw, boxes) in k2_cases(f, bb).items():
        g = kw.get("frame_stride", 1)
        out_bytes = 2 if kw.get("out_dtype") == torch.bfloat16 else 4
        bound_ms, bound_by, n_bytes = k2_bound(
            None if boxes is None else main_bboxes[:CHUNK:g], H, W, out_bytes,
            kw.get("rect", True), n_frames=-(-CHUNK // g))
        shapes[case] = {"ms": times[case]["ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": n_bytes, "share_of_bound": bound_ms / times[case]["ms"]}
    ms = shapes["f32 1/1"]["ms"]
    plain_ms = time_ms(lambda: fused_letterbox_crop_plain(f, bb), reps=5, per_rep=2)
    # Yardstick only (the port never calls it): bilinear F.interpolate with
    # cv2's half-pixel rule (align_corners=False) into the content band of a
    # 128/255 canvas, plus K1's grid_sample crop, on frames already converted
    # to float NCHW.
    CH, CW, new_w, new_h, pad_x, pad_y = canvas_geometry(H, W, 416, True)
    ys, xs = crop_coords(bb, 1.2, OUT)
    grid = torch.stack([
        (2.0 * xs / (W - 1) - 1.0)[:, None, :].expand(-1, OUT, -1),
        (2.0 * ys / (H - 1) - 1.0)[:, :, None].expand(-1, -1, OUT)], dim=-1)
    f_nchw = f.permute(0, 3, 1, 2).float() / 255.0

    def library():
        canvas = torch.full((CHUNK, 3, CH, CW), GRAY, device=device)
        canvas[:, :, pad_y:pad_y + new_h, pad_x:pad_x + new_w] = F.interpolate(
            f_nchw, size=(new_h, new_w), mode="bilinear", align_corners=False)
        return canvas, F.grid_sample(f_nchw, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=True)

    lib_err = max(float((a.permute(0, 2, 3, 1) - b).abs().max())
                  for a, b in zip(library(), fused_letterbox_crop_cuda(f, bb)))
    if not lib_err <= 1e-3:
        raise AssertionError(f"the library yardstick computes another function: {lib_err}")
    library_ms = time_ms(library)
    row = {"name": "fused_letterbox_crop_cuda", "route": "cuda",
           "source": "poserisk_release_tpu_torch/csrc/letterbox_crop.cu",
           "replaces": "poserisk_release_tpu/ops/resample_pallas.py:133",
           "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": shapes["f32 1/1"]["bound_ms"], "bound_by": shapes["f32 1/1"]["bound_by"],
           "library_ms": library_ms}
    print(json.dumps({"phase": "letterbox_crop_timing", "shape": [CHUNK, H, W, 3],
                      "canvas": [CH, CW], "shapes": shapes, "plain_ms": plain_ms,
                      "library_ms": library_ms, "library_max_abs_err": lib_err}))
    return row


class CountingDetector:
    """Wraps a detector and keeps the number of detections of every frame."""

    def __init__(self, detector):
        self.detector, self.counts = detector, []

    def __call__(self, frames_rgb):
        out = self.detector(frames_rgb)
        self.counts.extend(len(d) for d in out)
        return out


def detector_path(device, frames):
    """The YOLOv3 detector at full width on the Predictor's square 416
    canvas: its tower and kept boxes against the port's CPU path on 2
    frames, then the detector path under MultiPersonTracker over all
    frames. Returns (K2 launches, the BN-folded weights)."""
    from poserisk_release_tpu_torch.models.detector import (
        YoloDetector,
        fold_bn_params,
        init_yolo_params,
        yolo_forward,
    )
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop_cuda
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker

    sd = fold_bn_params(init_yolo_params(0))
    det = YoloDetector(params=sd, device=device, batch_size=CHUNK)
    cpu_det = YoloDetector(params=sd, device="cpu", batch_size=2)
    two = frames[:2]
    # Strict f32 on both sides (TF32 off on the card): the conv tower's sums
    # run in another order (cuDNN's algorithms against the CPU's), so the
    # raw head logits are held to 1e-3 of each head's largest magnitude; the
    # same comparison between the port and the JAX package on the CPU
    # measures about 1e-5 (tests/test_torch_detector.py).
    with torch.no_grad():
        heads = [h for h, _ in det.model.heads(
            det.letterbox(torch.as_tensor(two, device=device)).permute(0, 3, 1, 2))]
        ref = [h for h, _ in cpu_det.model.heads(
            cpu_det.letterbox(torch.as_tensor(two)).permute(0, 3, 1, 2))]
    head_rel = max(float((h.cpu() - r).abs().max() / r.abs().max()) for h, r in zip(heads, ref))
    got, want = det(two), cpu_det(two)
    if [g.shape for g in got] != [w.shape for w in want]:
        raise AssertionError(f"kept boxes differ in number: {got} vs {want}")
    box_err = max([float(np.abs(g - w).max()) for g, w in zip(got, want) if g.size] + [0.0])
    if not (head_rel <= 1e-3 and box_err <= 0.5):
        raise AssertionError(f"detector card vs CPU: heads {head_rel}, boxes {box_err} px")

    det(frames[:CHUNK])  # warm-up
    sync(device)
    counting = CountingDetector(det)
    reset_launch_counts()
    t0 = time.perf_counter()
    tracks = MultiPersonTracker(counting).track_windows(
        (s, frames[s:s + CHUNK]) for s in range(0, len(frames), CHUNK))
    seconds = time.perf_counter() - t0
    launches = fused_letterbox_crop_cuda.launches
    letter = det.letterbox(torch.as_tensor(frames[:CHUNK], device=device))
    yolo_ms = time_ms(lambda: yolo_forward(det.model, letter), reps=5, per_rep=1, warmup=2)
    counts = np.asarray(counting.counts)
    print(json.dumps({
        "phase": "detector_path", "frames": len(frames), "canvas": list(letter.shape[1:3]),
        "k2_launches": launches, "track_s": seconds, "frames_per_s": len(frames) / seconds,
        "yolo_chunk_ms": yolo_ms, "detections_per_frame": {
            "mean": float(counts.mean()), "min": int(counts.min()), "max": int(counts.max())},
        "tracks": len(tracks), "cpu_ref_frames": 2, "head_max_rel_err": head_rel,
        "box_max_abs_err_px": box_err,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
    if len(counts) != len(frames):
        raise AssertionError(f"detections for {len(counts)} of {len(frames)} frames")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the strict detector left TF32 on")
    if launches <= 0:
        raise AssertionError("the detector path launched no letterbox kernel")
    return launches, sd


def full_frame(device, frames, bboxes, yolo_sd, variables, smpl, cfg, fast: bool,
               quant_backbone=None) -> int:
    """make_full_frame_step over all frames in CHUNK-frame chunks through
    K2 (fused), held against the unfused step; strict f32 at strides 1/1 or
    fast bf16 at 8/8. A quantized yolo_sd with a prepared quant_backbone is
    the int8 configuration (fast, 8/8). Returns K2's launches."""
    from poserisk_release_tpu_torch.models.detector import YoloV3, yolo_forward
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop, fused_letterbox_crop_cuda
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.scoring.reba import reba_frame_scores
    from poserisk_release_tpu_torch.scoring.rula import rula_frame_scores
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_full_frame_step,
        make_pose_core,
    )

    dtype, stride = (torch.bfloat16, 8) if fast else (torch.float32, 1)
    est = PoseEstimator(cfg, smpl, variables=variables, fast=fast, device=device)
    yolo = YoloV3.from_state_dict(yolo_sd)
    # A quantized tower is built in its compute dtype (bf16): move it only.
    yolo = (yolo.to(device, memory_format=torch.channels_last) if yolo.quantized
            else yolo.to(device, dtype, memory_format=torch.channels_last))
    ir, iu = (torch.as_tensor(a, device=device) for a in default_packed_infos())
    f_dev = torch.as_tensor(frames, device=device)
    b_dev = torch.as_tensor(np.asarray(bboxes, np.float32), device=device)
    kw = dict(yolo_model=yolo, img_size=416, compute_dtype=dtype, rect=True,
              det_stride=stride, pose_stride=stride, quant_backbone=quant_backbone)
    fused = make_full_frame_step(est.parents, fused_resample=True, **kw)
    unfused = make_full_frame_step(est.parents, **kw)

    def run(step):
        return [step(est.model, est.smpl_params, f_dev[s:s + CHUNK], b_dev[s:s + CHUNK], ir, iu)
                for s in range(0, len(frames), CHUNK)]

    run(fused)  # warm-up
    sync(device)
    reset_launch_counts()
    outs = []
    dev_ms = elapsed_ms(lambda: outs.extend(run(fused)), device)
    launches = fused_letterbox_crop_cuda.launches
    reba, rula, best = (torch.cat([o[i] for o in outs]).cpu() for i in range(3))
    ref = run(unfused)
    ref_reba, ref_rula, ref_best = (torch.cat([o[i] for o in ref]).cpu() for i in range(3))
    best_diff = float((best.float() - ref_best.float()).abs().max())
    same_scores = bool(torch.equal(reba, ref_reba) and torch.equal(rula, ref_rula))

    # Equal strides: the step's kernel reads every stride-th frame and both
    # outputs cover each frame it reads.
    f0, b0 = f_dev[:CHUNK], b_dev[:CHUNK]
    core = make_pose_core(est.parents, pose_stride=stride, quant_backbone=quant_backbone)

    def resample():
        return fused_letterbox_crop(f0, b0, out_dtype=dtype, frame_stride=stride)

    with torch.inference_mode():
        letter, crops = resample()
        euler = core(est.model, est.smpl_params, crops)[0]
        chunk_ms = {
            "letterbox+crop": time_ms(resample),
            "yolo": time_ms(lambda: yolo_forward(yolo, letter), reps=5, per_rep=1, warmup=2),
            "pose": time_ms(lambda: core(est.model, est.smpl_params, crops), reps=5, per_rep=1,
                            warmup=2),
            "score": time_ms(lambda: (reba_frame_scores(euler, ir), rula_frame_scores(euler, iu)),
                             reps=5, per_rep=2, warmup=2)}
    print(json.dumps({
        "phase": ("full_frame_fast" if fast else "full_frame_strict")
        + ("_int8" if yolo.quantized else ""), "frames": len(frames),
        "chunk": CHUNK, "det_stride": stride, "pose_stride": stride, "dtype": str(dtype),
        "detector_frames_per_chunk": letter.shape[0], "k2_launches": launches,
        "device_ms": dev_ms, "frames_per_s": len(frames) / dev_ms * 1e3, "chunk_ms": chunk_ms,
        "det_best_max_diff_vs_unfused": best_diff, "scores_equal_unfused": same_scores,
        "reba_range": [int(reba.min()), int(reba.max())],
        "rula_range": [int(rula.min()), int(rula.max())]}))
    if not (reba.shape == (len(frames),) and best.shape == (-(-len(frames) // stride),)):
        raise AssertionError(f"full-frame shapes: reba {tuple(reba.shape)}, best {tuple(best.shape)}")
    if not (int(reba.min()) >= 1 and int(reba.max()) <= 12
            and int(rula.min()) >= 1 and int(rula.max()) <= 7):
        raise AssertionError("full-frame scores out of range")
    if not (torch.isfinite(best).all() and best_diff < 1e-3 and same_scores):
        raise AssertionError(f"fused vs unfused: det_best {best_diff}, scores equal {same_scores}")
    if launches <= 0:
        raise AssertionError("the full-frame step launched no letterbox+crop kernel")
    return launches


def skin_bound_ms(B, V, NB, P, J) -> tuple:
    """(bound ms, 'bytes' | 'operations') of K4: the tables read once, the
    per-frame inputs read once, the vertices written once; ~2 kFLOP per
    vertex-frame (shape and pose blends, the 24-joint affine blend, the
    3x4 transform) in f32 off the tensor cores."""
    from poserisk_release_tpu_torch.tools.timing import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

    n_bytes = 4 * (V * 3 * (NB + P) + V * J + V * 3 + B * (NB + P + 12 * J) + B * V * 3)
    n_flops = B * V * (2 * (3 * (NB + P) + 12 * J + 9) + 6)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def debug_mesh(device, cfg, smpl, variables, aa, track_frames) -> dict:
    """K4 against its plain version on the card at B = 1 and B = 64, LBS
    against the plain forward, timings, then the --debug_frame mesh export
    through the Predictor (the obj half; the figure needs matplotlib)."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.ops.lbs import LBS, _lbs_impl, skin_inputs
    from poserisk_release_tpu_torch.ops.skin import skin_vertices_cuda, skin_vertices_plain
    from poserisk_release_tpu_torch.pipeline import Predictor

    lbs = LBS(smpl["neutral"], device)
    p = lbs.params
    tables = (p["v_template"], p["shapedirs"], p["posedirs"], p["weights"])
    V, J = p["weights"].shape
    NB, P = p["shapedirs"].shape[1], p["posedirs"].shape[1]
    rng = np.random.RandomState(2)
    line = {"phase": "skin_check"}
    row = None
    for B in (1, CHUNK):
        pose = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, 72)).astype(np.float32), device=device)
        betas = torch.as_tensor(rng.normal(0, 0.5, (B, 10)).astype(np.float32), device=device)
        betas[::3] = 0.0  # the template-betas fallback on every third frame
        with torch.no_grad():
            eff_betas, pose_map, affines, _ = skin_inputs(p, pose, betas, lbs.parents)
            args = (eff_betas.contiguous(), pose_map.contiguous(), affines.contiguous()) + tables
            err = float((skin_vertices_cuda(*args) - skin_vertices_plain(*args)).abs().max())
            zeros = torch.zeros((B, 3), device=device)
            lbs_err = float((lbs(pose, betas)[0] - _lbs_impl(p, pose, betas, zeros,
                                                            lbs.parents)[0]).abs().max())
            sd3, pd3 = p["shapedirs"].reshape(V, 3, NB), p["posedirs"].reshape(V, 3, P)

            def library():
                v = (p["v_template"][None] + torch.einsum("bs,vcs->bvc", eff_betas, sd3)
                     + torch.einsum("bk,vck->bvc", pose_map, pd3))
                M = torch.einsum("vj,bjk->bvk", p["weights"], affines)
                return torch.einsum("bvij,bvj->bvi", M[..., :9].reshape(B, V, 3, 3), v) + M[..., 9:]

            lib_err = float((library() - skin_vertices_plain(*args)).abs().max())
            ms = time_ms(lambda: skin_vertices_cuda(*args))
            plain_ms = time_ms(lambda: skin_vertices_plain(*args))
            library_ms = time_ms(library)
        bound_ms, bound_by = skin_bound_ms(B, V, NB, P, J)
        line[f"B{B}"] = {"max_abs_err_m": err, "lbs_max_abs_err_m": lbs_err, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_max_abs_err_m": lib_err, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        # Another summation order than the plain version's matmuls: f32
        # rounding of ~220-term sums at a vertex scale of ~1 m.
        if not (err <= 1e-5 and lbs_err <= 1e-5):
            raise AssertionError(f"skin kernel at B={B}: {err} m, LBS {lbs_err} m")
        if B == 1:  # the debug export's size, the main path's shape
            row = {"name": "skin_vertices_cuda", "route": "cuda",
                   "source": "poserisk_release_tpu_torch/csrc/skin.cu",
                   "replaces": "poserisk_release_tpu/ops/lbs_pallas.py:74", "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
    print(json.dumps(line))

    k = int(track_frames[len(track_frames) // 2])
    pred = Predictor(cfg, debug=True, debug_frame=k, visualize=False, detector=StubDetector(),
                     spin_variables=variables, device=device)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    pred._lbs("neutral")  # tables on the card before the counted run
    reset_launch_counts()
    idx = pred._save_debug_mesh(aa, track_frames, out_dir)
    sync(device)
    row["launches"] = skin_vertices_cuda.launches
    with open(os.path.join(out_dir, "smpl_model.obj")) as f:
        verts = np.array([ln.split()[1:] for ln in f if ln.startswith("v ")], np.float64)
    print(json.dumps({"phase": "debug_mesh", "debug_frame": k, "track_index": idx,
                      "k4_launches": row["launches"], "vertices": len(verts),
                      "extent_mm": float(np.ptp(verts, axis=0).max()) if len(verts) else None}))
    if verts.shape != (6890, 3) or not np.isfinite(verts).all():
        raise AssertionError(f"debug mesh: {verts.shape} vertices or non-finite values")
    if row["launches"] <= 0:
        raise AssertionError("the debug mesh launched no skinning kernel")
    return row


STREAM_FRAMES, STREAM_LONG, STREAM_SHORT = 256, 1024, 128


class SyntheticStream:
    """In-memory stand-in for io.video._window_stream (the card's machine
    need not have opencv): the same items, ("meta", fps), ("window", start,
    frames), ("end", total), each window made only when it is asked for.
    Frame i is a smooth background, noise from RandomState(seed * 1000003 +
    i) and a bright block moving 2 px a frame, so every pass (and the batch
    reference) sees the same pixels and no pass holds the clip."""

    def __init__(self, n_frames: int, seed: int = 7):
        H, W = FRAME_HW
        yy, xx = np.mgrid[0:H, 0:W]
        base = 60 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 23.0)
        self.base = np.repeat(base[:, :, None], 3, axis=2).astype(np.uint8)
        self.n_frames, self.seed = n_frames, seed

    def frames(self, start: int, n: int) -> np.ndarray:
        H, W = FRAME_HW
        out = np.empty((n, H, W, 3), np.uint8)
        for k in range(n):
            i = start + k
            noise = np.random.RandomState(self.seed * 1000003 + i).randint(
                0, 24, (H, W, 3), dtype=np.uint8)
            np.add(self.base, noise, out=out[k])
            x = 100 + (2 * i) % 400
            out[k, 60:420, x:x + 180] = (180, 150, 120)
        return out

    def __call__(self, video_path, window, max_frames, workers=1):
        total = self.n_frames if max_frames is None else min(self.n_frames, max_frames)
        yield ("meta", 30.0)
        for start in range(0, total, window):
            yield ("window", start, self.frames(start, min(window, total - start)))
        yield ("end", total)


class ScriptedDetector:
    """Cursor-scripted detector: per-frame detection lists served across
    window-sized calls."""

    def __init__(self, per_frame_dets):
        self.dets = [np.asarray(d, np.float32).reshape(-1, 5) for d in per_frame_dets]
        self.pos = 0

    def __call__(self, frames):
        out = self.dets[self.pos:self.pos + len(frames)]
        self.pos += len(frames)
        return [d.copy() for d in out]


def streaming_path(device, variables, smpl, cfg) -> int:
    """The bounded-memory StreamingScorer (streaming.py) at full width,
    window = CHUNK, on SyntheticStream in place of the video decoder:
    two-pass at pose_stride 1 (STREAM_FRAMES frames), at pose_stride 2 and
    fast with the int8 backbone at pose_stride 2 (STREAM_SHORT), each equal
    to the port's batch path on the same frames; online at detection_stride
    4 with a scripted moving box (every frame between the first and last
    detection scored, boxes those of interpolate_track_gaps); score_all
    with two scripted people (equal to per-track batch runs, the union of a
    window's frames uploaded once to the card); and the device memory peak
    of the two-pass over STREAM_FRAMES and STREAM_LONG frames. Returns the
    K1 launches of the streaming runs (not of their references)."""
    from poserisk_release_tpu_torch import streaming
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_add_info
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer
    from poserisk_release_tpu_torch.tracking.mpt import (
        MultiPersonTracker,
        filter_and_select_target,
        surviving_tracks,
    )

    info = load_add_info(cfg, "")
    reba, rula = REBAScorer(device=device), RULAScorer(device=device)
    launches, t_phase = [], time.perf_counter()
    real_stream = streaming._window_stream

    def drive(scorer, n_frames, method="__call__"):
        """One counted streaming run over n_frames: (result, K1 launches,
        host seconds)."""
        streaming._window_stream = SyntheticStream(n_frames)
        try:
            sync(device)
            reset_launch_counts()
            t0 = time.perf_counter()
            result = getattr(scorer, method)("synthetic.mp4", info)
            sync(device)
            seconds = time.perf_counter() - t0
            launches.append(crop_batch_cuda.launches)
        finally:
            streaming._window_stream = real_stream
        return result, launches[-1], seconds

    def batch_scores(est, frames, track_frames, bboxes):
        euler, joint_cam, _ = est.run_from_frames(frames, track_frames, bboxes, chunk=CHUNK)
        return ([r["score"] for r in reba(euler, joint_cam, info)],
                [r["score"] for r in rula(euler, joint_cam, info)])

    def windows(det, n_frames, frames, stride=1):
        return MultiPersonTracker(det, detection_stride=stride).track_windows(
            (s, frames[s:s + CHUNK]) for s in range(0, n_frames, CHUNK))

    def two_pass(n_frames, fast=False, spin_int8=False, pose_stride=1):
        run_cfg = cfg.replace(SPIN={"pose_stride": pose_stride})
        scorer = streaming.StreamingScorer(cfg=run_cfg, window=CHUNK, spin_variables=variables,
                                           fast=fast, spin_int8=spin_int8, device=device)
        result, k1, seconds = drive(scorer, n_frames)
        frames = SyntheticStream(n_frames).frames(0, n_frames)
        bboxes, track_frames = filter_and_select_target(
            windows(StubDetector(), n_frames, frames), n_frames, cfg.DATASET.min_frame_ratio)
        est = PoseEstimator(run_cfg, smpl, variables=variables, fast=fast, device=device)
        if spin_int8:  # the streaming run's quantized backbone, handed over
            est.load_quant_backbone(scorer.estimator.quant_params)
        want = batch_scores(est, frames, track_frames, bboxes)
        same = (result.frames == [int(f) for f in track_frames]
                and (result.reba_scores, result.rula_scores) == want)
        line = {"phase": "streaming_two_pass", "frames": n_frames, "pose_stride": pose_stride,
                "fast": fast, "spin_int8": spin_int8, "k1_launches": k1, "seconds": seconds,
                "streaming_frames_per_s": n_frames / seconds, "scored": len(result.frames),
                "equal_to_batch_path": same}
        print(json.dumps(line))
        if not same:
            raise AssertionError(f"streaming two-pass differs from the batch path: {line}")
        return scorer

    scorer = two_pass(STREAM_SHORT)  # warm-up, also held against the batch path
    peaks = {}
    for n in (STREAM_FRAMES, STREAM_LONG):
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        result, k1, seconds = drive(scorer, n)
        peaks[n] = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
                    else 0)
        line = {"phase": "streaming_memory", "frames": n, "k1_launches": k1,
                "seconds": seconds, "streaming_frames_per_s": n / seconds,
                "max_memory_allocated": peaks[n]}
        if n == STREAM_FRAMES:  # held against the batch path on the same frames
            t0 = time.perf_counter()
            frames = SyntheticStream(n).frames(0, n)
            # Host seconds to make the frames once; the run made them once a
            # pass, standing in for the decode.
            line["make_frames_s"] = time.perf_counter() - t0
            bboxes, track_frames = filter_and_select_target(
                windows(StubDetector(), n, frames), n, cfg.DATASET.min_frame_ratio)
            want = batch_scores(scorer.estimator, frames, track_frames, bboxes)
            line["equal_to_batch_path"] = (
                result.frames == [int(f) for f in track_frames]
                and (result.reba_scores, result.rula_scores) == want)
            del frames
        print(json.dumps(line))
        if not line.get("equal_to_batch_path", True):
            raise AssertionError(f"streaming {n} frames differs from the batch path")
    if peaks[STREAM_LONG] > 1.1 * peaks[STREAM_FRAMES]:
        raise AssertionError(f"device memory grows with the clip: {peaks}")
    two_pass(STREAM_SHORT, pose_stride=2)
    two_pass(STREAM_SHORT, fast=True, spin_int8=True, pose_stride=2)

    # Online, detection_stride 4: a box moving 2 px a frame, detected on
    # every 4th frame; the two-pass tracker's interpolation is the reference.
    n = STREAM_SHORT
    dets = [[[150.0 + 2 * g, 60.0, 330.0 + 2 * g, 420.0, 0.9]] for g in range(0, n, 4)]
    online_cfg = cfg.replace(DETECTOR={"detection_stride": 4})
    scorer = streaming.StreamingScorer(cfg=online_cfg, detector=ScriptedDetector(dets),
                                       window=CHUNK, spin_variables=variables,
                                       selection="online", device=device)
    boxes = {}
    score_window = scorer._score_window

    def spy(frames_, local_ids, bxs, start_idx, *args, **kwargs):
        ids = kwargs.get("orig_local_ids")
        for gid, box in zip(np.asarray(local_ids if ids is None else ids) + start_idx,
                            np.asarray(bxs)):
            boxes[int(gid)] = np.asarray(box, np.float64)
        return score_window(frames_, local_ids, bxs, start_idx, *args, **kwargs)

    scorer._score_window = spy
    result, k1, seconds = drive(scorer, n)
    track = next(iter(windows(ScriptedDetector(dets), n, np.zeros((n, 1, 1, 3), np.uint8),
                              stride=4).values()))
    want = {int(f): b for f, b in zip(track["frames"], track["bbox"])}
    first, last = 0, 4 * ((n - 1) // 4)
    box_err = max(float(np.abs(boxes[g] - want[g]).max()) for g in want) if (
        sorted(boxes) == sorted(want)) else float("inf")
    line = {"phase": "streaming_online", "frames": n, "detection_stride": 4, "k1_launches": k1,
            "seconds": seconds, "scored": len(result.frames),
            "scored_first_to_last_detection": result.frames == list(range(first, last + 1)),
            "box_max_abs_diff_vs_interpolate_track_gaps": box_err}
    print(json.dumps(line))
    if not (line["scored_first_to_last_detection"] and box_err <= 1e-9):
        raise AssertionError(f"online streaming: {line}")

    # score_all: person A in the first 60% of the frames, B from frame 2 on.
    dets = []
    for i in range(n):
        frame = [[120.0 + i, 60.0, 300.0 + i, 420.0, 0.9]] if i >= 2 else []
        if i < int(0.6 * n):
            frame.append([480.0, 20.0, 760.0, 440.0, 0.95])
        dets.append(frame)
    scorer = streaming.StreamingScorer(cfg=cfg, detector=ScriptedDetector(dets), window=CHUNK,
                                       spin_variables=variables, device=device)
    sources = []
    run_chunked = scorer.estimator._run_chunked

    def recording(num_items, host_chunk, step_fn, chunk=0):
        part = host_chunk(0, 1)[0]
        sources.append(part.device.type if isinstance(part, torch.Tensor) else "host")
        return run_chunked(num_items, host_chunk, step_fn, chunk)

    scorer.estimator._run_chunked = recording
    results, k1, seconds = drive(scorer, n, "score_all")
    frames = SyntheticStream(n).frames(0, n)
    survivors = surviving_tracks(windows(ScriptedDetector(dets), n, frames), n,
                                 cfg.DATASET.min_frame_ratio)
    same = sorted(results) == sorted(survivors) and len(results) == 2 and all(
        (results[pid].reba_scores, results[pid].rula_scores)
        == batch_scores(scorer.estimator, frames, t["frames"], t["bbox"])
        for pid, t in survivors.items())
    line = {"phase": "streaming_score_all", "frames": n, "people": len(results),
            "k1_launches": k1, "seconds": seconds, "equal_to_per_track_batch": same,
            "union_upload_device": sorted(set(sources))}
    print(json.dumps(line))
    if not same:
        raise AssertionError(f"score_all differs from per-track batch runs: {line}")
    if torch.device(device).type not in sources:
        raise AssertionError(f"score_all's shared union upload is not on {device}: {sources}")
    print(json.dumps({"phase": "streaming_path", "seconds": time.perf_counter() - t_phase,
                      "k1_launches": sum(launches)}))
    if min(launches) <= 0:
        raise AssertionError(f"a streaming run launched no crop kernel: {launches}")
    return sum(launches)


SERVING_LADDER, SERVING_CLIENTS, SERVING_PER_CLIENT, SESSION_FRAMES = (1, 4, 16, 64), 16, 64, 32


def events_ms(fn, n: int = 10) -> float:
    """Milliseconds per fn() call over n back-to-back calls between two CUDA
    events (after two warm-up calls): the rate the card sustains, host
    pacing included, unlike time_ms, which enqueues while the card sleeps."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_replays(bucket, n: int = 5) -> tuple:
    """torch.profiler over n replays of a bucket graph: (crop_kernel
    records, kernel records, summed kernel microseconds), the last two per
    replay."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            bucket.graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not any(k in e.name.lower() for k in ("memcpy", "memset"))]
    return (sum("crop_kernel" in e.name for e in kernels), len(kernels) / n,
            sum(e.time_range.elapsed_us() for e in kernels) / n)


def serving_path(device, frames, bboxes, track_frames, variables, smpl, cfg) -> int:
    """The request-batching server (serving.PoseScoringServer) and its
    per-camera StreamSession at full width, frame_hw 450x800:

    * strict f32, ladder 1/4/16/64 (one CUDA graph per bucket): b requests
      submitted together fill bucket b; results equal the eager step at the
      same shape (run_from_frames, chunk = b, + the scorers; Euler within
      1e-4 deg); bucket 4's within 0.05 deg / 0.05 mm of the port's CPU path;
      per bucket one replay against the eager step in CUDA-event time, and
      torch.profiler's crop_kernel records over 5 replays;
    * a closed loop of SERVING_CLIENTS threads x SERVING_PER_CLIENT requests:
      requests/s, latency percentiles, the batch-fill histogram;
    * three StreamSessions on threads over the strict server (detection
      strides 1, 4, 4, scripted detectors): frames and scores equal the
      online StreamingScorer's on the same frames;
    * fast bf16 at bucket 16 against the eager fast step;
    * spin_int8 with calibration_crops at buckets 1 and 4 against the eager
      int8 step on the same quantized backbone;
    * spin_int8 calibrated by its first real batch, captured anew while
      three sessions push from their threads and a fourth thread runs eager
      pose steps on the card; afterwards each bucket equals the eager int8
      step.

    Returns the K1 launches of the servers: eager warm-up runs before each
    capture and the int8 calibration crop, plus those each replay launches
    (a capture records the kernel and launches nothing:
    ops/resample.crop_batch_cuda.captured). The references' and the
    timings' launches are left out."""
    import threading

    from poserisk_release_tpu_torch import streaming
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_add_info
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer
    from poserisk_release_tpu_torch.serving import PoseScoringServer, StreamSession

    cuda = torch.device(device).type == "cuda"
    info = load_add_info(cfg, "")
    t_phase = time.perf_counter()
    req_frames = frames[track_frames]
    req_boxes = np.asarray(bboxes, np.float32)
    launches = []

    def served(server, idx):
        """Submit requests idx together; (results, the new batch fills)."""
        before = len(server.stats()["batch_fill"])
        futs = [server.submit(req_frames[i], req_boxes[i]) for i in idx]
        return [f.result(timeout=300) for f in futs], server.stats()["batch_fill"][before:]

    def uncounted(fn):
        """fn() on the card with its K1 launches left out of the count: a
        reference or a timing, not the server (called while the server is
        idle)."""
        before = crop_batch_cuda.launches
        try:
            return fn()
        finally:
            crop_batch_cuda.launches = before

    def eager(est, idx, chunk):
        euler, joint_cam, _ = uncounted(lambda: est.run_from_frames(
            req_frames, np.asarray(idx), req_boxes[idx], chunk=chunk))
        return ([r["score"] for r in REBAScorer(device=device)(euler, joint_cam, info)],
                [r["score"] for r in RULAScorer(device=device)(euler, joint_cam, info)],
                euler, joint_cam)

    def against(results, want, bound=1e-4):
        """(scores equal, largest Euler difference in deg) against an eager
        reference."""
        reba, rula, euler, _ = want
        d = np.abs(np.stack([r.euler_deg for r in results]) - euler)
        d = float(np.minimum(d, 360.0 - d).max())
        same = [(r.reba, r.rula) for r in results] == list(zip(reba, rula))
        return same and d <= bound, d

    def ensure(ok, what):
        if not ok:
            raise AssertionError(f"serving_path: {what}")

    # -- strict f32, the default ladder -----------------------------------
    sync(device)
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    server = PoseScoringServer(cfg=cfg, batch_sizes=SERVING_LADDER, max_delay_ms=500.0,
                               frame_hw=FRAME_HW, spin_variables=variables, device=device)
    build_s = time.perf_counter() - t0
    memory = ({"allocated_before": mem0,
               "allocated_by_server": torch.cuda.memory_allocated() - mem0,
               "max_memory_allocated": torch.cuda.max_memory_allocated()} if cuda else {})
    line = {"phase": "serving_strict", "ladder": list(SERVING_LADDER), "build_and_capture_s":
            build_s, "memory_after_captures": memory, "buckets": {}}
    start = 0
    for b in SERVING_LADDER:
        idx = list(range(start, start + b))
        start += b
        results, fills = served(server, idx)
        ok, d = against(results, eager(server.estimator, idx, b))
        ensure(fills == [(b, b)], f"bucket {b} filled {fills}")
        ensure(ok, f"bucket {b} differs from the eager step: euler {d} deg")
        rec = {"fills": fills, "scores_equal_eager": ok, "euler_max_abs_diff_deg": d}
        if cuda:
            bucket = server._steps[b]
            step = server._make_step()
            with torch.inference_mode():
                rec["replay_ms"] = events_ms(bucket.graph.replay)
                rec["eager_step_ms"] = uncounted(lambda: events_ms(
                    lambda: step(bucket.frames, bucket.boxes)))
            n_prof = 5
            rec["profiled_replays"] = n_prof
            rec["crop_kernel_records"], rec["kernels_per_replay"], rec[
                "replay_kernel_us"] = profile_replays(bucket, n_prof)
            rec["k1_recorded_per_replay"] = bucket.k1_per_replay
            # One K1 launch a replay: the capture recorded exactly one, and
            # the profiler sees n records in n replays. In some processes on
            # the card it lost a few kernel records in every session, one
            # crop_kernel among them, so n - 1 also passes; two launches a
            # replay would read 2n.
            ensure(bucket.k1_per_replay == 1
                   and n_prof - 1 <= rec["crop_kernel_records"] <= n_prof,
                   f"bucket {b}: {bucket.k1_per_replay} K1 launches recorded, "
                   f"{rec['crop_kernel_records']} crop_kernel records in {n_prof} replays")
        if b == 4:  # the port's CPU path on the same 4 requests
            cpu_est = PoseEstimator(cfg, smpl, variables=variables, device="cpu")
            e, j, _ = cpu_est.run_from_frames(req_frames, np.asarray(idx), req_boxes[idx],
                                              chunk=4)
            d_e = np.abs(np.stack([r.euler_deg for r in results]) - e)
            d_e = float(np.minimum(d_e, 360.0 - d_e).max())
            d_j = float(np.abs(np.stack([r.joint_cam_mm for r in results]) - j).max())
            same = all([r["score"] for r in scorer(e, None, info)] == [
                getattr(r, name) for r in results] for name, scorer in (
                ("reba", REBAScorer(device="cpu")), ("rula", RULAScorer(device="cpu"))))
            rec.update(cpu_ref_euler_max_abs_diff_deg=d_e, cpu_ref_joint_max_abs_diff_mm=d_j,
                       cpu_ref_scores_equal=same)
            ensure(d_e < 0.05 and d_j < 0.05 and same, f"card vs CPU path: {rec}")
        line["buckets"][b] = rec
    print(json.dumps(line))

    # -- closed-loop load ----------------------------------------------------
    server.max_delay_s = 0.003  # the constructor's default deadline
    before = len(server.stats()["batch_fill"])
    lat, errors = [], []
    lock = threading.Lock()

    def client(c):
        try:
            for k in range(SERVING_PER_CLIENT):
                i = (c * SERVING_PER_CLIENT + k) % len(req_frames)
                t0 = time.perf_counter()
                server.score(req_frames[i], req_boxes[i], timeout=300)
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as exc:  # reported below
            errors.append(repr(exc))

    clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVING_CLIENTS)]
    t0 = time.perf_counter()
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    fills = server.stats()["batch_fill"][before:]
    hist = {}
    for n, b in fills:
        hist[f"{n}/{b}"] = hist.get(f"{n}/{b}", 0) + 1
    lat_ms = np.asarray(lat) * 1e3
    n_req = SERVING_CLIENTS * SERVING_PER_CLIENT
    line = {"phase": "serving_load", "clients": SERVING_CLIENTS, "requests": len(lat),
            "seconds": seconds, "requests_per_s": len(lat) / seconds,
            "latency_ms": {p: float(np.percentile(lat_ms, q)) for p, q in (
                ("p50", 50), ("p95", 95), ("p99", 99))} if len(lat) else None,
            "batches": len(fills), "mean_fill": float(np.mean([n for n, _ in fills])),
            "batch_fill_histogram": hist, "errors": errors[:3]}
    print(json.dumps(line))
    ensure(len(lat) == n_req and not errors, f"closed loop: {line}")

    # -- three StreamSessions over the strict server -------------------------
    server.max_delay_s = 0.002
    cams = [("cam0", 1, 150.0), ("cam1", 4, 90.0), ("cam2", 4, 300.0)]
    clips = {name: SyntheticStream(SESSION_FRAMES, seed=11 + k).frames(0, SESSION_FRAMES)
             for k, (name, _, _) in enumerate(cams)}

    def scripted(stride, x0):
        return [[[x0 + 2 * g, 60.0, x0 + 180 + 2 * g, 420.0, 0.9]]
                for g in range(0, SESSION_FRAMES, stride)]

    def feed(sessions, futures, name):
        for frame in clips[name]:
            futures[name].extend(sessions[name].push(frame))

    def run_sessions(srv, sessions, extra=()):
        futures = {name: [] for name, _, _ in cams}
        threads = [threading.Thread(target=feed, args=(sessions, futures, name))
                   for name, _, _ in cams] + list(extra)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        return {name: [(i, f.result(timeout=300)) for i, f in futs]
                for name, futs in futures.items()}

    sessions = {name: StreamSession(server, detector=ScriptedDetector(scripted(s, x0)),
                                    detection_stride=s, ring_capacity=16)
                for name, s, x0 in cams}
    got = run_sessions(server, sessions)
    same = {}
    real_stream = streaming._window_stream
    try:
        for k, (name, s, x0) in enumerate(cams):
            streaming._window_stream = SyntheticStream(SESSION_FRAMES, seed=11 + k)
            online = uncounted(lambda: streaming.StreamingScorer(
                cfg=cfg.replace(DETECTOR={"detection_stride": s}),
                detector=ScriptedDetector(scripted(s, x0)), window=16,
                spin_variables=variables, selection="online", device=device)("s.mp4", info))
            same[name] = ([i for i, _ in got[name]] == online.frames
                          and [r.reba for _, r in got[name]] == online.reba_scores
                          and [r.rula for _, r in got[name]] == online.rula_scores)
    finally:
        streaming._window_stream = real_stream
    line = {"phase": "serving_sessions", "cameras": len(cams), "frames": SESSION_FRAMES,
            "scored": {n: len(v) for n, v in got.items()}, "equal_to_online_streaming": same}
    print(json.dumps(line))
    ensure(all(same.values()), f"sessions differ from the online streaming scorer: {line}")
    server.close()
    launches.append(crop_batch_cuda.launches)
    replays = [server.graph_replays]

    # -- fast bf16, one bucket -------------------------------------------------
    reset_launch_counts()
    with PoseScoringServer(cfg=cfg, batch_sizes=(16,), max_delay_ms=500.0, frame_hw=FRAME_HW,
                           fast=True, spin_variables=variables, device=device) as fast:
        idx = list(range(16))
        results, fills = served(fast, idx)
        ok, d = against(results, eager(fast.estimator, idx, 16))
    launches.append(crop_batch_cuda.launches)
    replays.append(fast.graph_replays)
    print(json.dumps({"phase": "serving_fast", "bucket": 16, "fills": fills,
                      "scores_equal_eager": ok, "euler_max_abs_diff_deg": d}))
    ensure(fills == [(16, 16)] and ok, f"fast bucket 16 vs eager: euler {d} deg")

    # -- spin_int8 with calibration_crops, buckets 1 and 4 -------------------
    from poserisk_release_tpu_torch.ops.crop import crop_batch

    calib = crop_batch(torch.as_tensor(req_frames[:8], device=device),
                       torch.as_tensor(req_boxes[:8], device=device)).cpu().numpy()
    reset_launch_counts()
    int8_line = {"phase": "serving_int8_calibration_crops", "buckets": {}}
    with PoseScoringServer(cfg=cfg, batch_sizes=(1, 4), max_delay_ms=500.0, frame_hw=FRAME_HW,
                           spin_int8=True, calibration_crops=calib, spin_variables=variables,
                           device=device) as q8:
        # The eager reference runs on the server's own estimator: the same
        # quantized backbone.
        for b, idx in ((1, [20]), (4, list(range(24, 28)))):
            results, fills = served(q8, idx)
            ok, d = against(results, eager(q8.estimator, idx, b))
            int8_line["buckets"][b] = {"fills": fills, "scores_equal_eager": ok,
                                       "euler_max_abs_diff_deg": d}
            ensure(fills == [(b, b)] and ok, f"int8 bucket {b} vs eager: euler {d} deg")
    launches.append(crop_batch_cuda.launches)
    replays.append(q8.graph_replays)
    print(json.dumps(int8_line))

    # -- spin_int8 calibrated mid-traffic, with other threads on the card ----
    reset_launch_counts()
    q8 = PoseScoringServer(cfg=cfg, batch_sizes=(1, 4), max_delay_ms=2.0, frame_hw=FRAME_HW,
                           spin_int8=True, spin_variables=variables, device=device)
    ensure(q8.estimator.spin_needs_calibration, "warm-up calibrated the int8 backbone")
    stop = threading.Event()
    busy = {"steps": 0}
    other = PoseEstimator(cfg, smpl, variables=variables, device=device)

    def card_work():  # eager pose steps with host read-backs, on the default stream
        f = torch.as_tensor(req_frames[:8], device=device)
        bb = torch.as_tensor(req_boxes[:8], device=device)
        with torch.inference_mode():
            while not stop.is_set():
                float(other._pose_step_from_frames(f, bb)[0].sum())
                busy["steps"] += 1

    worker = threading.Thread(target=card_work)
    sessions = {name: StreamSession(q8, detector=ScriptedDetector(scripted(s, x0)),
                                    detection_stride=s, ring_capacity=16)
                for name, s, x0 in cams}
    worker.start()
    try:
        got = run_sessions(q8, sessions)
    finally:
        stop.set()
        worker.join(timeout=120)
    after = {}
    n = len(req_frames)
    for b, idx in ((1, [n - 5]), (4, list(range(n - 4, n)))):
        results, fills = served(q8, idx)
        ok, d = against(results, eager(q8.estimator, idx, b))
        after[b] = {"scores_equal_eager": ok, "euler_max_abs_diff_deg": d}
        ensure(ok, f"int8 bucket {b} captured mid-traffic differs from eager: euler {d} deg")
    line = {"phase": "serving_int8_mid_traffic", "calibrated": not
            q8.estimator.spin_needs_calibration, "scored": {n: len(v) for n, v in got.items()},
            "other_thread_pose_steps": busy["steps"], "after": after,
            "graph_replays": q8.graph_replays}
    q8.close()
    # The other thread's pose steps launched K1 once each: not the server's.
    launches.append(crop_batch_cuda.launches - busy["steps"])
    replays.append(q8.graph_replays)
    print(json.dumps(line))
    ensure(line["calibrated"] and all(len(v) > 0 for v in got.values()),
           f"int8 mid-traffic: {line}")

    # Each replay launches K1 once (k1_recorded_per_replay, and the profiler
    # above); the rest of each server's count is its eager warm-up runs
    # before a capture and its int8 calibration crop.
    print(json.dumps({"phase": "serving_path", "seconds": time.perf_counter() - t_phase,
                      "k1_launches": launches, "graph_replays": replays}))
    ensure(min(launches) > 0 and min(replays) > 0, "a serving run launched no crop kernel")
    return sum(launches)


# name, PARALLEL, JAX layout tolerance (tests/test_torch_parallel_ranks.py)
PARALLEL_LAYOUTS = (
    ("dp2_tp2", {"num_devices": 2, "model": 2}, 5e-3),
    ("dp2_pp2", {"num_devices": 2, "stage": 2, "stage_microbatches": 2}, 1e-3),
    ("ep4", {"num_devices": 1, "expert": 4}, 1e-3),
    ("dp4", {"num_devices": 4}, 1e-3),
    ("sp4", {"num_devices": 1, "spatial": 4}, 5e-3),
    ("dp2_sp2", {"num_devices": 2, "spatial": 2}, 5e-3),
    ("tp2_sp2", {"num_devices": 1, "model": 2, "spatial": 2}, 5e-3),
)
# name, layout, estimator options: held against the single card in the same
# configuration (the int8 one given the ranks' quantized backbone), within
# the card-vs-CPU class of main_path; a bf16 run within twice the single
# card's own bf16-vs-f32 gap, if that is larger: cuDNN picks other bf16
# algorithms for a row window than for the whole map, and two bf16 runs lie
# as far apart as bf16 lies from f32 (JAX's bf16 class, tests/test_bf16_path.py,
# allows 0.15 on a rotation-matrix element).
PARALLEL_VARIANTS = (("dp2_sp2_fast", "dp2_sp2", {"fast": True}),
                     ("dp2_sp2_int8", "dp2_sp2", {"spin_int8": True}))
VARIANT_TOL = 0.05  # deg and mm
SP_MEMORY_SHARE = 0.6  # sp4's largest rank peak against ep4's, same frames
MESH_LAYOUT = "dp2_sp2"  # the streaming scorer's and the server's mesh
PARALLEL_WORLD, PARALLEL_TIMEOUT_S = 4, 420
PORT_VS_JAX = 1e-2  # deg and mm, tests/test_torch_pose.py


def halo_bytes_expected(hw: int, parallel: dict, frames: int, elem: int = 4) -> list:
    """The bytes each rank of a layout receives in halo exchanges over one
    run of `frames` frames (split over the data axis) of hw x hw crops,
    counted from the ResNet-50's geometry and the partition rule alone:
    rank r of S owns rows [min(r c, H), min((r + 1) c, H)), c = ceil(H / S),
    of every activation; a conv or pool whose output rows [o0, o1) read
    the input rows [o0 s - p, (o1 - 1) s - p + k) receives those of them
    inside the input that it does not own. The stem reads the whole crops
    (no exchange); under tp the exchanged activations are channel shards.
    Ranks in mesh order (data, stage, expert, model, spatial; spatial
    fastest)."""
    S = parallel.get("spatial", 1)
    T = parallel.get("model", 1)
    D = parallel.get("num_devices", 1)
    B = frames // D

    def missing(H, k, s, p, r):
        ho = (H + 2 * p - k) // s + 1
        c, co = -(-H // S), -(-ho // S)
        o0, o1 = min(r * co, ho), min((r + 1) * co, ho)
        if o1 <= o0:
            return 0
        need = set(range(max(o0 * s - p, 0), min((o1 - 1) * s - p + k, H)))
        return len(need - set(range(min(r * c, H), min((r + 1) * c, H))))

    # (input rows = columns, channels, k, s, p) of every exchange
    h = (hw + 6 - 7) // 2 + 1
    layers = [(h, 64, 3, 2, 1)]  # the max-pool on the stem's output
    h, cin = (h + 2 - 3) // 2 + 1, 64
    for L, (n_blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for i in range(n_blocks):
            s = 2 if (L > 1 and i == 0) else 1
            if i == 0:
                layers.append((h, cin, 1, s, 0))  # downsample
            layers.append((h, cin, 1, 1, 0))  # conv1
            layers.append((h, planes, 3, s, 1))  # conv2
            h2 = (h + 2 - 3) // s + 1
            layers.append((h2, planes, 1, 1, 0))  # conv3
            h, cin = h2, planes * 4
    per_spatial = [sum(missing(H, k, s, p, r) * H * (C // T) * B * elem
                       for H, C, k, s, p in layers) for r in range(S)]
    world = D * T * S * parallel.get("stage", 1) * parallel.get("expert", 1)
    return [per_spatial[rank % S] for rank in range(world)]


def parallel_rank(rank: int, root: str, cfg, on_cpu: bool) -> None:
    """One rank of parallel_path: every layout (then every variant) in
    turn on the same 4-rank group, each a fresh PoseEstimator (its own
    DeviceMesh) on the smoke's cfg over the shared 64-frame chunk; a
    warm-up run, then the driven run with the launch and halo-byte counts
    set to 0 just before it and read just after. Then, under MESH_LAYOUT,
    the streaming scorer over STREAM_SHORT synthetic frames and one
    request to the server. Writes its numbers to root/rank{rank}.pt.
    on_cpu: the CPU rehearsal (gloo on the CPU)."""
    import torch.distributed as dist

    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.parallel import mesh as pmesh
    from poserisk_release_tpu_torch.parallel.collectives import transport
    from poserisk_release_tpu_torch.parallel.distributed import rank_device
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // PARALLEL_WORLD))
    device = rank_device(cpu=on_cpu)
    cuda = device.type == "cuda"
    variables = torch.load(os.path.join(root, "weights.pt"))
    chunk = np.load(os.path.join(root, "chunk.npz"))
    frames, boxes = chunk["frames"], chunk["boxes"]
    ids = np.arange(len(frames))
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    layouts = {name: parallel for name, parallel, _tol in PARALLEL_LAYOUTS}

    def layout_cfg(parallel):
        return cfg.replace(PARALLEL={"frames_per_step": len(frames) // parallel["num_devices"],
                                     **parallel})

    def start_count():
        sync(device)
        reset_launch_counts()
        pmesh.RowShards.received_bytes = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()

    out = {}
    runs = [(name, name, {}) for name in layouts] + list(PARALLEL_VARIANTS)
    for name, layout, options in runs:
        est = PoseEstimator(layout_cfg(layouts[layout]), smpl, variables=variables,
                            device=device, **options)
        est.run_from_frames(frames, ids, boxes)  # warm-up (int8: calibrates)
        start_count()
        t0 = time.perf_counter()
        result = est.run_from_frames(frames, ids, boxes)
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = {
            "result": result, "ms": ms, "k1": crop_batch_cuda.launches,
            "halo_bytes": pmesh.RowShards.received_bytes,
            "quant_params": est.quant_params if rank == 0 else None,
            "param_bytes": est.param_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None,
            "transport": transport(), "device": str(device),
            "coords": {n: pmesh.axis_index(est.mesh, n) for n in est.mesh.mesh_dim_names},
            "shape": {n: pmesh.axis_size(est.mesh, n) for n in est.mesh.mesh_dim_names},
            "tf32": (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)}
        del est
        if cuda:
            torch.cuda.empty_cache()

    from poserisk_release_tpu_torch import streaming
    from poserisk_release_tpu_torch.pipeline import load_add_info
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    mesh_cfg = layout_cfg(layouts[MESH_LAYOUT])
    scorer = streaming.StreamingScorer(cfg=mesh_cfg, window=CHUNK, spin_variables=variables,
                                       device=device)
    streaming._window_stream = SyntheticStream(STREAM_SHORT)
    start_count()
    t0 = time.perf_counter()
    res = scorer("synthetic.mp4", load_add_info(cfg, ""))
    out["streaming_mesh"] = {"frames": res.frames, "reba": res.reba_scores,
                             "rula": res.rula_scores, "k1": crop_batch_cuda.launches,
                             "halo_bytes": pmesh.RowShards.received_bytes,
                             "seconds": time.perf_counter() - t0}
    del scorer
    # Counted from before the server exists: once built, the other ranks'
    # worker loops answer rank 0's broadcasts on threads of their own, and
    # a barrier here would cross them. Unwarmed, the one request captures
    # its bucket's graph on every rank and replays it.
    start_count()
    with PoseScoringServer(cfg=mesh_cfg, batch_sizes=(1,), frame_hw=FRAME_HW, warm=False,
                           spin_variables=variables, device=device) as srv:
        got = srv.score(frames[0], boxes[0], timeout=120) if rank == 0 else None
    ladder, replays = srv.batch_sizes, srv.graph_replays  # closed: every rank's batch ran
    out["serving_mesh"] = {"result": None if got is None else (got.reba, got.rula,
                                                                got.euler_deg, got.joint_cam_mm),
                           "ladder": ladder, "graph_replays": replays,
                           "k1": crop_batch_cuda.launches}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def parallel_path(device, frames, bboxes, track_frames, variables, smpl, cfg) -> int:
    """The mesh layouts of PARALLEL_LAYOUTS at full width: 224x224 crops,
    the smoke's ResNet-50 HMR weights and SMPL tables, one 64-frame chunk of
    tracked 450x800 frames split over the data axis, strict f32 with TF32
    off on every rank. The ranks are 4 spawned processes: NCCL with one card
    each where the card count allows, else gloo with the ranks sharing the
    cards (cuda:0 on one card), their collectives staged through the host;
    gloo-staged times measure that staging, not parallel speed. Holds every
    layout against this process's single-card step (scores exactly equal,
    Euler and joints within the CPU tests' limits), the variants
    (dp 2 x sp 2 fast and int8) against the single card in their
    configuration, each layout's halo bytes against halo_bytes_expected,
    sp4's largest rank peak against SP_MEMORY_SHARE of ep4's, and, under
    MESH_LAYOUT, the streaming scorer over STREAM_SHORT frames and one
    server request against the single card's. Requires every data rank on
    stage 0 to have launched K1 in every run. Returns the ranks' K1
    launches."""
    from poserisk_release_tpu_torch import streaming
    from poserisk_release_tpu_torch.parallel.distributed import run_ranks
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_add_info
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    t_phase = time.perf_counter()
    ids = track_frames[:CHUNK]
    chunk_frames = np.ascontiguousarray(frames[ids])
    chunk_boxes = np.asarray(bboxes[:CHUNK], np.float32)
    info = load_add_info(cfg, "")

    def single(**options):
        return PoseEstimator(cfg, smpl, variables=variables, device=device, **options)

    ref = single().run_from_frames(chunk_frames, np.arange(CHUNK), chunk_boxes, chunk=CHUNK)

    def scores(euler):
        return [[r["score"] for r in scorer(euler, None, info)]
                for scorer in (REBAScorer(device="cpu"), RULAScorer(device="cpu"))]

    on_cpu = torch.device(device).type != "cuda"
    backend = "nccl" if not on_cpu and torch.cuda.device_count() >= PARALLEL_WORLD else "gloo"
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as root:
        torch.save(variables, os.path.join(root, "weights.pt"))
        np.savez(os.path.join(root, "chunk.npz"), frames=chunk_frames, boxes=chunk_boxes)
        t0 = time.perf_counter()
        run_ranks(parallel_rank, PARALLEL_WORLD, backend, f"file://{root}/init",
                  args=(root, cfg, on_cpu), timeout=PARALLEL_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(PARALLEL_WORLD)]
    layouts = {name: (parallel, tol) for name, parallel, tol in PARALLEL_LAYOUTS}
    checks = [(name, name, {}, ref, (PORT_VS_JAX + tol,) * 2)
              for name, (_p, tol) in layouts.items()]
    gaps = {}
    for name, layout, options in PARALLEL_VARIANTS:
        est = single(**options)
        if options.get("spin_int8"):
            est.load_quant_backbone(ranks[0][name]["quant_params"])
        want = est.run_from_frames(chunk_frames, np.arange(CHUNK), chunk_boxes, chunk=CHUNK)
        limit = (VARIANT_TOL, VARIANT_TOL)  # deg, mm
        if options.get("fast"):  # the single card's own bf16-vs-f32 gap
            d = np.abs(want[0] - ref[0])
            gaps[name] = (float(np.minimum(d, 360.0 - d).max()),
                          float(np.abs(want[1] - ref[1]).max()))
            limit = tuple(max(VARIANT_TOL, 2 * g) for g in gaps[name])
        checks.append((name, layout, options, want, limit))
        del est
    silent, peaks = [], {}
    for name, layout, options, want, limit in checks:
        rs = [r[name] for r in ranks]
        euler, joints, _aa = rs[0]["result"]
        for r in rs[1:]:
            for a, b in zip(rs[0]["result"], r["result"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: the ranks' gathered chunks differ")
        d_e = np.abs(euler - want[0])
        d_e = float(np.minimum(d_e, 360.0 - d_e).max())
        d_j = float(np.abs(joints - want[1]).max())
        same = scores(euler) == scores(want[0])
        k1 = [r["k1"] for r in rs]
        halo = [r["halo_bytes"] for r in rs]
        halo_want = halo_bytes_expected(int(cfg.MODEL.input_shape[0]), layouts[layout][0], CHUNK,
                                        2 if options.get("fast") else 4)
        peaks[name] = [r["max_memory_allocated"] for r in rs]
        first_stage = [r["coords"].get("stage", 0) == 0 for r in rs]
        line = {
            "phase": f"parallel_{name}", "transport": rs[0]["transport"],
            "world": rs[0]["shape"], "devices": [r["device"] for r in rs],
            "ms_per_chunk": max(r["ms"] for r in rs), "ms_per_rank": [r["ms"] for r in rs],
            "frames": CHUNK, "param_bytes": [r["param_bytes"] for r in rs],
            "single_card_param_bytes": sum(v.numel() * v.element_size()
                                           for v in variables.values()),
            "max_memory_allocated": peaks[name], "halo_bytes": halo,
            "halo_bytes_expected": halo_want, "k1_launches": k1,
            "euler_max_abs_diff_deg": d_e, "joint_max_abs_diff_mm": d_j,
            "scores_equal": same}
        if options:
            line.update(options=options, limit=limit)
        if name in gaps:
            line["single_card_bf16_vs_f32_deg_mm"] = gaps[name]
        print(json.dumps(line))
        if not same or d_e >= limit[0] or d_j >= limit[1]:
            raise AssertionError(
                f"{name} vs the single-card step: euler {d_e} deg, joints {d_j} mm, "
                f"scores equal {same}")
        if halo != halo_want:
            raise AssertionError(f"{name}: halo bytes {halo}, the geometry's {halo_want}")
        if not on_cpu and not options.get("fast") and any(
                r["tf32"] != (False, False) for r in rs):
            raise AssertionError(f"{name}: a rank left TF32 on")
        if not all(n > 0 for n, first in zip(k1, first_stage) if first):
            silent.append((name, k1))
        launches += sum(k1)
    if not on_cpu:
        share = max(peaks["sp4"]) / max(peaks["ep4"])
        print(json.dumps({"phase": "parallel_sp4_memory", "sp4_max_memory_allocated":
                          peaks["sp4"], "ep4_max_memory_allocated": peaks["ep4"],
                          "sp4_share_of_ep4": share, "limit": SP_MEMORY_SHARE}))
        if share >= SP_MEMORY_SHARE:
            raise AssertionError(f"sp4's peak is {share} of ep4's (limit {SP_MEMORY_SHARE})")

    # The streaming scorer under MESH_LAYOUT against the single card's.
    real_stream = streaming._window_stream
    streaming._window_stream = SyntheticStream(STREAM_SHORT)
    try:
        res = streaming.StreamingScorer(cfg=cfg, window=CHUNK, spin_variables=variables,
                                        device=device)("synthetic.mp4", info)
    finally:
        streaming._window_stream = real_stream
    rs = [r["streaming_mesh"] for r in ranks]
    k1 = [r["k1"] for r in rs]
    same = all((r["frames"], r["reba"], r["rula"])
               == (res.frames, res.reba_scores, res.rula_scores) for r in rs)
    line = {"phase": "streaming_mesh", "layout": MESH_LAYOUT, "frames": STREAM_SHORT,
            "scored": len(res.frames), "seconds": max(r["seconds"] for r in rs),
            "halo_bytes": [r["halo_bytes"] for r in rs], "k1_launches": k1,
            "equal_to_single_card": same}
    print(json.dumps(line))
    if not same:
        raise AssertionError(f"streaming under {MESH_LAYOUT} differs from the single card")
    if min(k1) <= 0:
        silent.append(("streaming_mesh", k1))
    launches += sum(k1)

    # One request to the server under MESH_LAYOUT against the single card's.
    with PoseScoringServer(cfg=cfg, batch_sizes=(1,), frame_hw=FRAME_HW, warm=False,
                           spin_variables=variables, device=device) as srv:
        want = srv.score(chunk_frames[0], chunk_boxes[0], timeout=120)
    rs = [r["serving_mesh"] for r in ranks]
    reba, rula, euler, joints = rs[0]["result"]
    d_e = np.abs(euler - want.euler_deg)
    d_e = float(np.minimum(d_e, 360.0 - d_e).max())
    d_j = float(np.abs(joints - want.joint_cam_mm).max())
    k1 = [r["k1"] for r in rs]
    line = {"phase": "serving_mesh", "layout": MESH_LAYOUT, "ladder": rs[0]["ladder"],
            "graph_replays": [r["graph_replays"] for r in rs], "k1_launches": k1,
            "scores": (reba, rula), "single_card_scores": (want.reba, want.rula),
            "euler_max_abs_diff_deg": d_e, "joint_max_abs_diff_mm": d_j}
    print(json.dumps(line))
    if (reba, rula) != (want.reba, want.rula) or d_e >= VARIANT_TOL or d_j >= VARIANT_TOL:
        raise AssertionError(f"the server under {MESH_LAYOUT} differs from the single card")
    if min(k1) <= 0:
        silent.append(("serving_mesh", k1))
    launches += sum(k1)
    print(json.dumps({"phase": "parallel_path", "backend": backend, "spawn_s": spawn_s,
                      "seconds": time.perf_counter() - t_phase, "k1_launches": launches}))
    if silent:
        raise AssertionError(f"a data rank on stage 0 launched no crop kernel: {silent}")
    return launches


# -- the training side (train/*) and its data preparation ---------------------
PREP_FPS = 12.0  # 8 s (MIN_SEC) at 12 fps: one 96-frame chunk of each track
TRAIN_B, TRAIN_STEPS, TRAIN_CPU_B, TRAIN_MESH_B = 64, 6, 2, 16
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-4, 5e-4  # tests/test_torch_train.py
# The steps held against a reference take SGD at lr 10, so that each leaf's
# update (-lr * grad) stands far above its parameters' f32 rounding; each
# update is then held to a share of the reference update's largest element
# (tests/test_torch_train_ranks.py holds 1e-3 at 64x64). At full width f32
# itself lies up to 1.3e-3 of a leaf's largest update from the f64 step
# (train_single's cpu_vs_f64), so two f32 steps may differ by twice that:
# 1e-2 leaves room and stays far below a wrong backward (a planted fault
# is off by 0.99 to 3).
TRAIN_CHECK_LR, TRAIN_UPDATE_RTOL = 10.0, 1e-2
TRAIN_MESH_LAYOUTS = (("dp4", {"data": 4}), ("dp2_tp2", {"data": 2, "model": 2}))


def data_prep(device, frames, tracks) -> int:
    """tools/data_preprocessing.person_chunks on the smoke's frames and the
    StubDetector tracks (at PREP_FPS, so each track gives one MIN_SEC chunk):
    its uint8 BGR images equal those of the plain crop on the card exactly,
    and K1 (crop_batch) on each chunk's frames equals the plain crop exactly
    in f32; then io/images.get_single_image_crop on one frame (K1 at
    B = 1), held the same way. Returns K1's launches (those of the path,
    not of the comparison)."""
    from poserisk_release_tpu_torch.io.images import get_single_image_crop
    from poserisk_release_tpu_torch.ops.crop import crop_batch, crop_batch_plain
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.tools.data_preprocessing import BBOX_SCALE, person_chunks

    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    chunks = list(person_chunks(frames, PREP_FPS, tracks, device=device))
    prep_s = time.perf_counter() - t0
    box = np.asarray(tracks[next(iter(tracks))]["bbox"][0], np.float32)
    single = get_single_image_crop(frames[0], box, device=device)
    sync(device)
    launches = crop_batch_cuda.launches
    crop_err = image_err = 0.0
    for c in chunks:
        f = torch.as_tensor(frames[c["frames"]], device=device)
        b = torch.as_tensor(c["bbox"], device=device)
        want = crop_batch_plain(f, b, BBOX_SCALE).cpu().numpy()
        got = crop_batch(f, b, BBOX_SCALE).cpu().numpy()
        crop_err = max(crop_err, float(np.abs(got - want).max()))
        image_err = max(image_err, float(np.abs(
            c["images_bgr"].astype(int) - (want[..., ::-1] * 255).astype(np.uint8)).max()))
    want1 = crop_batch_plain(torch.as_tensor(frames[:1], device=device),
                             torch.as_tensor(box[None], device=device), 1.3).cpu().numpy()[0]
    single_err = float(np.abs(single - want1).max())
    print(json.dumps({"phase": "data_prep", "chunks": len(chunks),
                      "frames_per_chunk": [len(c["frames"]) for c in chunks],
                      "fps": PREP_FPS, "seconds": prep_s, "k1_launches": launches,
                      "crops_max_abs_err": crop_err, "bgr_u8_max_abs_err": image_err,
                      "single_image_crop_max_abs_err": single_err}))
    if not chunks or crop_err != 0.0 or image_err != 0.0 or single_err != 0.0:
        raise AssertionError("data_prep: the crops differ from the plain crop")
    if launches < len(chunks) + 1:
        raise AssertionError(f"data_prep launched K1 {launches} times for {len(chunks)} chunks")
    return launches


def _train_crops(device, frames, bboxes, track_frames, n: int) -> torch.Tensor:
    """The first n tracked frames cropped to 224x224 f32 (K1 on the card)."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch

    f = torch.as_tensor(np.ascontiguousarray(frames[track_frames[:n]]), device=device)
    return crop_batch(f, torch.as_tensor(np.asarray(bboxes[:n], np.float32), device=device))


def _max_param_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max()) for k in b
               if not k.endswith("num_batches_tracked"))


def _update_check(before: dict, got: dict, want: dict) -> dict:
    """Each trained leaf's update after - before (f64 from the f32 values),
    got's against want's as a share of want's largest element
    (tests/test_torch_train_ranks.assert_update_matches): the worst share,
    its leaf and that leaf's largest reference update, the largest update
    of all, and the trained leaves that did not move in want or in got."""
    out = {"update_worst_rel": 0.0, "update_worst_leaf": None, "update_worst_leaf_max": None,
           "update_max_abs_ref": 0.0, "leaves_not_moved": []}
    for k, b in before.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        b = b.double().cpu()
        d_want, d_got = want[k].double().cpu() - b, got[k].double().cpu() - b
        scale = float(d_want.abs().max())
        if scale == 0.0 or float(d_got.abs().max()) == 0.0:
            out["leaves_not_moved"].append(k)
            continue
        ratio = float((d_got - d_want).abs().max()) / scale
        out["update_max_abs_ref"] = max(out["update_max_abs_ref"], scale)
        if ratio >= out["update_worst_rel"]:
            out.update(update_worst_rel=ratio, update_worst_leaf=k, update_worst_leaf_max=scale)
    return out


def _sgd_step_f64(cfg, smpl, variables, crops, targets) -> dict:
    """The SGD step (lr TRAIN_CHECK_LR) of the card-vs-CPU check in f64 on
    the CPU, through make_train_step (its features pass through f32 once):
    the near-exact update that sizes f32's own error. Returns the state_dict
    after it."""
    from poserisk_release_tpu_torch.models.spin import HMR
    from poserisk_release_tpu_torch.ops.lbs import smpl_params_to_torch
    from poserisk_release_tpu_torch.train.optim import get_optimizer
    from poserisk_release_tpu_torch.train.step import make_train_step, trainable_tensors

    model = HMR(n_iter=cfg.SPIN.ief_iters)
    model.load_state_dict(variables)
    model = model.double().eval()
    tensors = list(trainable_tensors(model).values())
    for t in tensors:
        t.requires_grad_(True)
    parents = np.asarray(smpl["neutral"].kintree_parents).copy()
    parents[0] = 0
    params = {k: v.double() if v.is_floating_point() else v
              for k, v in smpl_params_to_torch(smpl["neutral"], "cpu").items()}
    step = make_train_step(cfg.SPIN.ief_iters, tuple(int(p) for p in parents),
                           get_optimizer("sgd", TRAIN_CHECK_LR)(tensors), remat=False)
    step(model, params, crops.double().cpu(), targets.double().cpu())
    return {k: v.detach() for k, v in model.state_dict().items()}


def _update_ok(u: dict) -> bool:
    return u["update_worst_rel"] <= TRAIN_UPDATE_RTOL and not u["leaves_not_moved"]


def train_single(device, frames, bboxes, track_frames, variables, smpl, cfg, smi) -> int:
    """TrainState at full width on the card: B = 64 crops of 224x224 made
    by K1 from the tracked frames, targets the port's strict pose-path
    joints of the same frames (root-centred, m) plus seeded noise, adam at
    lr 1e-4. Six steps each with whole-backbone remat on and off: ms per
    step (CUDA events, median of the last 4), max_memory_allocated, the
    loss finite at every step and lower at step 6 than at step 1, the
    parameters finite. Then a checkpoint round trip (save_checkpoint ->
    load_checkpoint -> PoseEstimator(variables=...)) that must give exactly
    the trained model's forward, and one SGD step (lr 10) at B = 2 held
    against the port's CPU step: loss rtol 1e-4, parameters atol 5e-4, and
    each trained leaf's update within 1e-2 of the CPU update's largest
    element, every leaf having moved; beside it, each f32 step against the
    same step in f64 on the CPU. Returns K1's launches."""
    from poserisk_release_tpu_torch.models.convert import flax_to_state_dict
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.train.optim import load_checkpoint, save_checkpoint
    from poserisk_release_tpu_torch.train.step import TrainState

    cuda = torch.device(device).type == "cuda"
    sync(device)
    reset_launch_counts()
    crops = _train_crops(device, frames, bboxes, track_frames, TRAIN_B)
    est = PoseEstimator(cfg, smpl, variables=variables, device=device)
    _e, joint_cam, _aa = est.run_from_frames(frames, track_frames[:TRAIN_B], bboxes[:TRAIN_B],
                                             chunk=TRAIN_B)
    del est
    noise = np.random.RandomState(9).normal(0.0, 0.01, joint_cam.shape)
    targets = torch.as_tensor((joint_cam / 1000.0 + noise).astype(np.float32), device=device)
    sync(device)
    launches = crop_batch_cuda.launches

    runs = {}
    for remat in (True, False):
        state = TrainState.create(cfg, smpl, variables=variables, optimizer_name="adam",
                                  lr=1e-4, remat=remat, device=device)
        sync(device)
        base = peak = None
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        losses, ms = [], []
        for _ in range(TRAIN_STEPS):
            box = {}
            ms.append(elapsed_ms(lambda: box.update(loss=state.step(crops, targets)[1]), device))
            losses.append(box["loss"])
        if cuda:
            peak = torch.cuda.max_memory_allocated(device)
        finite = all(bool(torch.isfinite(v).all()) for v in state.state_dict().values())
        runs[remat] = {"losses": losses, "ms_per_step": float(np.median(ms[-4:])),
                       "ms_all": ms, "max_memory_allocated": peak, "memory_before": base,
                       "params_finite": finite}
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and finite):
            raise AssertionError(f"train_single remat={remat}: losses {losses}, finite {finite}")
        if remat:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
                path = save_checkpoint(state.variables(), epoch=TRAIN_STEPS, checkpoint_dir=ckpt)
                restored = flax_to_state_dict(load_checkpoint(path))
            loaded = PoseEstimator(cfg, smpl, variables=restored, device=device)
            with torch.inference_mode():
                same = all(torch.equal(a, b) for a, b in
                           zip(state.model(crops[:8]), loaded.model(crops[:8])))
            del loaded
            if not same:
                raise AssertionError("the checkpoint's PoseEstimator differs from the trained model")
        del state
        if cuda:
            torch.cuda.empty_cache()

    # One SGD step at B = 2, the card against the port's CPU path.
    small = (crops[:TRAIN_CPU_B], targets[:TRAIN_CPU_B])
    out = {}
    for dev in (device, "cpu"):
        st = TrainState.create(cfg, smpl, variables=variables, optimizer_name="sgd",
                               lr=TRAIN_CHECK_LR, remat=False, device=dev)
        st, loss = st.step(*(x.to(dev) for x in small))
        out[str(dev)] = (loss, st.state_dict())
        del st
    (card_loss, card_sd), (cpu_loss, cpu_sd) = out[str(device)], out["cpu"]
    d_param = _max_param_diff(card_sd, cpu_sd)
    update = _update_check(variables, card_sd, cpu_sd)
    exact = _sgd_step_f64(cfg, smpl, variables, *small)
    update["card_vs_f64_worst_rel"] = _update_check(variables, card_sd, exact)["update_worst_rel"]
    update["cpu_vs_f64_worst_rel"] = _update_check(variables, cpu_sd, exact)["update_worst_rel"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    r, nr = runs[True], runs[False]
    print(json.dumps({
        "phase": "train_single", "nvidia_smi": smi, "batch": TRAIN_B, "crop": [OUT, OUT],
        "optimizer": "adam", "lr": 1e-4, "steps": TRAIN_STEPS, "k1_launches": launches,
        "remat": r, "no_remat": nr,
        "remat_peak_over_no_remat": (r["max_memory_allocated"] / nr["max_memory_allocated"]
                                     if cuda else None),
        "remat_ms_over_no_remat": r["ms_per_step"] / nr["ms_per_step"],
        "checkpoint_forward_equal": True,
        "sgd_b2_vs_cpu": {"lr": TRAIN_CHECK_LR, "loss_card": card_loss, "loss_cpu": cpu_loss,
                          "loss_rel_diff": loss_rel, "param_max_abs_diff": d_param, **update},
        "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}))
    if loss_rel > TRAIN_LOSS_RTOL or d_param > TRAIN_PARAM_ATOL or not _update_ok(update):
        raise AssertionError(f"train step card vs CPU: loss {loss_rel}, params {d_param}, "
                             f"update {update}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the training step left TF32 on")
    if launches <= 0:
        raise AssertionError("train_single launched no crop kernel")
    return launches


def train_mesh_rank(rank: int, root: str, cfg, on_cpu: bool) -> None:
    """One rank of train_mesh: K1 crops of the shared B = 16 frames on this
    rank's device, then one SGD step per layout of TRAIN_MESH_LAYOUTS, each
    a fresh TrainState on its own DeviceMesh. Writes its numbers (and, on
    rank 0, the gathered weights) to root."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.ops.crop import crop_batch
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.parallel.collectives import transport
    from poserisk_release_tpu_torch.parallel.distributed import rank_device
    from poserisk_release_tpu_torch.train.step import TrainState

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // PARALLEL_WORLD))
    device = rank_device(cpu=on_cpu)
    cuda = device.type == "cuda"
    variables = torch.load(os.path.join(root, "weights.pt"))
    batch = np.load(os.path.join(root, "batch.npz"))
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    reset_launch_counts()
    crops = crop_batch(torch.as_tensor(batch["frames"], device=device),
                       torch.as_tensor(batch["boxes"], device=device))
    sync(device)
    out = {"k1": crop_batch_cuda.launches, "device": str(device), "transport": transport()}
    mesh_device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    for name, axes in TRAIN_MESH_LAYOUTS:
        mesh = init_device_mesh(mesh_device, tuple(axes.values()), mesh_dim_names=tuple(axes))
        state = TrainState.create(cfg, smpl, variables=variables, optimizer_name="sgd",
                                  lr=TRAIN_CHECK_LR, remat=False, mesh=mesh, device=device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
        t0 = time.perf_counter()
        state, loss = state.step(crops, batch["targets"])
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"loss": loss, "ms": ms, "param_bytes": state.param_bytes,
               "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None}
        whole = state.state_dict()  # a collective under tp
        if rank == 0:
            torch.save({k: v.cpu() for k, v in whole.items()}, os.path.join(root, f"{name}.pt"))
        out[name] = rec
        del state, whole
        if cuda:
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def train_mesh(device, frames, bboxes, track_frames, variables, cfg, smi) -> int:
    """One spawn of 4 ranks: an SGD step at B = 16 (224x224, K1 crops on
    every rank) under dp 4, then dp 2 x tp 2. Gloo-staged on one card (NCCL
    where there are 4). Each layout's loss, gathered weights and update
    equal this process's single-card step (SGD at lr 10) within the CPU
    tests' limits. Records the
    per-rank parameter bytes and peaks and the slowest rank's ms: host
    staging, no speed claim. Returns K1's launches on the ranks."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.parallel.distributed import run_ranks
    from poserisk_release_tpu_torch.train.step import TrainState

    t_phase = time.perf_counter()
    ids = track_frames[:TRAIN_MESH_B]
    chunk_frames = np.ascontiguousarray(frames[ids])
    chunk_boxes = np.asarray(bboxes[:TRAIN_MESH_B], np.float32)
    targets = (np.random.RandomState(10).normal(0.0, 0.1, (TRAIN_MESH_B, 24, 3))
               .astype(np.float32))
    crops = _train_crops(device, frames, bboxes, track_frames, TRAIN_MESH_B)
    single = TrainState.create(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=variables,
                               optimizer_name="sgd", lr=TRAIN_CHECK_LR, remat=False, device=device)
    single, want_loss = single.step(crops, targets)
    want = {k: v.cpu() for k, v in single.state_dict().items()}
    whole_bytes = single.param_bytes
    del single, crops
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    on_cpu = torch.device(device).type != "cuda"
    backend = "nccl" if not on_cpu and torch.cuda.device_count() >= PARALLEL_WORLD else "gloo"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_mesh_") as root:
        torch.save(variables, os.path.join(root, "weights.pt"))
        np.savez(os.path.join(root, "batch.npz"), frames=chunk_frames, boxes=chunk_boxes,
                 targets=targets)
        t0 = time.perf_counter()
        run_ranks(train_mesh_rank, PARALLEL_WORLD, backend, f"file://{root}/init",
                  args=(root, cfg, on_cpu), timeout=PARALLEL_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(PARALLEL_WORLD)]
        gathered = {name: torch.load(os.path.join(root, f"{name}.pt"))
                    for name, _ in TRAIN_MESH_LAYOUTS}
    k1 = [r["k1"] for r in ranks]
    bad = []
    for name, axes in TRAIN_MESH_LAYOUTS:
        rs = [r[name] for r in ranks]
        loss_rel = max(abs(r["loss"] - want_loss) / abs(want_loss) for r in rs)
        d_param = _max_param_diff(gathered[name], want)
        update = _update_check(variables, gathered[name], want)
        print(json.dumps({
            "phase": f"train_mesh_{name}", "nvidia_smi": smi, "transport": ranks[0]["transport"],
            "mesh": axes, "devices": [r["device"] for r in ranks], "batch": TRAIN_MESH_B,
            "ms_per_step_slowest_rank": max(r["ms"] for r in rs),
            "ms_per_rank": [r["ms"] for r in rs],
            "note": "gloo-staged ranks sharing one card: these times measure host staging, "
                    "and no speed claim rests on them",
            "param_bytes": [r["param_bytes"] for r in rs], "single_card_param_bytes": whole_bytes,
            "max_memory_allocated": [r["max_memory_allocated"] for r in rs],
            "lr": TRAIN_CHECK_LR, "loss_single": want_loss, "loss_rel_diff": loss_rel,
            "param_max_abs_diff": d_param, **update}))
        if loss_rel > TRAIN_LOSS_RTOL or d_param > TRAIN_PARAM_ATOL or not _update_ok(update):
            bad.append((name, loss_rel, d_param, update))
    print(json.dumps({"phase": "train_mesh", "backend": backend, "spawn_s": spawn_s,
                      "seconds": time.perf_counter() - t_phase, "k1_launches": k1}))
    if bad:
        raise AssertionError(f"train_mesh vs the single-card step: {bad}")
    if min(k1) <= 0:
        raise AssertionError(f"a training rank launched no crop kernel: {k1}")
    return sum(k1)


def int8_detector_path(device, frames):
    """--fast_detector: YoloDetector(int8=True, rect=True) on the seed-0
    init, calibrated explicitly on the first CHUNK frames; its int8 heads
    and kept boxes against the port's CPU int8 path on 2 frames (the same
    quantized weights), then the detector path under MultiPersonTracker over
    all frames. Returns (K2 launches, the quantized state_dict)."""
    from poserisk_release_tpu_torch.models.detector import (
        YoloDetector,
        YoloV3,
        fold_bn_params,
        init_yolo_params,
        yolo_forward,
    )
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop_cuda
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker

    sd = fold_bn_params(init_yolo_params(0))
    det = YoloDetector(params=sd, device=device, batch_size=CHUNK, rect=True, int8=True)
    det.calibrate(frames[:CHUNK])
    if det.needs_calibration or not det.model.quantized:
        raise AssertionError("calibrate() left the detector unquantized")
    cpu_det = YoloDetector(params=det.params, device="cpu", batch_size=2, rect=True, int8=True)
    two = frames[:2]
    # Every int8 conv is exact on both sides and every bf16 elementwise op
    # rounds alike, so the heads differ only through the three float bf16
    # head convs (cuDNN's sums against the CPU's, each rounded to bf16
    # once): held to 2**-7 of each head's largest magnitude (2 bf16 ulp).
    with torch.no_grad():
        heads = [h.float() for h, _ in det.model.heads(det.letterbox(
            torch.as_tensor(two, device=device)).permute(0, 3, 1, 2).to(torch.bfloat16))]
        ref = [h.float() for h, _ in cpu_det.model.heads(cpu_det.letterbox(
            torch.as_tensor(two)).permute(0, 3, 1, 2).to(torch.bfloat16))]
    head_rel = max(float((h.cpu() - r).abs().max() / r.abs().max()) for h, r in zip(heads, ref))
    got, want = det(two), cpu_det(two)
    if [g.shape for g in got] != [w.shape for w in want]:
        raise AssertionError(f"int8 kept boxes differ in number: {got} vs {want}")
    box_err = max([float(np.abs(g - w).max()) for g, w in zip(got, want) if g.size] + [0.0])
    if not (head_rel <= 2.0 ** -7 and box_err <= 0.5):
        raise AssertionError(f"int8 detector card vs CPU: heads {head_rel}, boxes {box_err} px")

    det(frames[:CHUNK])  # warm-up
    sync(device)
    counting = CountingDetector(det)
    reset_launch_counts()
    t0 = time.perf_counter()
    tracks = MultiPersonTracker(counting).track_windows(
        (s, frames[s:s + CHUNK]) for s in range(0, len(frames), CHUNK))
    seconds = time.perf_counter() - t0
    launches = fused_letterbox_crop_cuda.launches
    letter = det.letterbox(torch.as_tensor(frames[:CHUNK], device=device))
    int8_ms = time_ms(lambda: yolo_forward(det.model, letter), reps=5, per_rep=1, warmup=2)
    float_model = YoloV3.from_state_dict(sd).to(device, memory_format=torch.channels_last)
    float_ms = time_ms(lambda: yolo_forward(float_model, letter), reps=5, per_rep=1, warmup=2)
    bf16_model = YoloV3.from_state_dict(sd).to(device, torch.bfloat16,
                                               memory_format=torch.channels_last)
    bf16_ms = time_ms(lambda: yolo_forward(bf16_model, letter), reps=5, per_rep=1, warmup=2)
    counts = np.asarray(counting.counts)
    print(json.dumps({
        "phase": "int8_detector_path", "frames": len(frames), "canvas": list(letter.shape[1:3]),
        "k2_launches": launches, "track_s": seconds, "frames_per_s": len(frames) / seconds,
        "yolo_chunk_ms": {"int8": int8_ms, "bf16": bf16_ms, "f32": float_ms},
        "quantized_convs": sum(k.endswith(".qkernel") for k in det.params),
        "detections_per_frame": {"mean": float(counts.mean()), "min": int(counts.min()),
                                 "max": int(counts.max())},
        "tracks": len(tracks), "cpu_ref_frames": 2, "head_max_rel_err": head_rel,
        "box_max_abs_err_px": box_err}))
    if len(counts) != len(frames):
        raise AssertionError(f"detections for {len(counts)} of {len(frames)} frames")
    if launches <= 0:
        raise AssertionError("the int8 detector path launched no letterbox kernel")
    return launches, det.params


def stage_check(device, frames) -> dict:
    """K5 through its experiment tool (tools/exp_fused_stage.stage_ab) at
    the three stage shapes, B = CHUNK, bf16 input, the quantized params of
    the seed-0 detector calibrated on the smoke's frames: the kernel
    against its plain version (target 0) and the A/B against the per-conv
    int8 chain (torch._int_mm), which is the row's library_ms. Prints per
    stage the kernel's ms, TOPS, share of the operations bound, the design's
    byte floor, the chain's ms and the split of one call by kernel."""
    from poserisk_release_tpu_torch.ops.yolo_stage import fused_residual_stage_cuda
    from poserisk_release_tpu_torch.tools.exp_fused_stage import calibrated_qparams, stage_ab

    qparams = calibrated_qparams(frames[:8], device)
    reset_launch_counts()
    rows = stage_ab(qparams, device, batch=CHUNK)
    all_launches = fused_residual_stage_cuda.launches
    # The kernels line counts the tool's one pass (its checked call per
    # stage: a quantize launch, then two launches per block), not its
    # timing loops.
    launches = sum(r["launches"] for r in rows)
    print(json.dumps({"phase": "stage_check", "k5_launches_one_pass": launches,
                      "k5_launches_with_timing": all_launches, "stages": [
                          {k: r[k] for k in ("stage", "ms", "tops", "pct_of_bound", "bound_ms",
                                             "floor_ms", "floor_by", "chain_ms", "kernels")}
                          for r in rows]}))
    err = max(r["max_abs_err"] for r in rows)
    if err != 0.0:
        raise AssertionError(f"fused stage kernel disagrees with its plain version: {rows}")
    if not (all(r["launches"] == 2 * r["blocks"] + 1 for r in rows)
            and all_launches >= launches):
        raise AssertionError(f"the fused stage tool did not launch the stage kernel: {rows}")
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "chain_ms")}
    return {"name": "fused_residual_stage_cuda", "route": "cuda",
            "source": "poserisk_release_tpu_torch/csrc/yolo_stage.cu",
            "replaces": "poserisk_release_tpu/ops/yolo_stage_pallas.py:147",
            "launches": launches, "max_abs_err": err, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations", "library_ms": total["chain_ms"]}


def window_crop_bytes(bboxes: np.ndarray, H: int, W: int, window: int, out_bytes: int) -> int:
    """crop_bytes with K3's window: per frame, each source pixel that a
    nonzero tap inside the window reads, read once; each output written once."""
    from poserisk_release_tpu_torch.ops.crop import (
        WINDOW_CHUNK,
        axis_taps,
        crop_coords,
        window_blocks,
    )

    bb = torch.as_tensor(bboxes, dtype=torch.float32)
    ys, xs = crop_coords(bb, 1.2, OUT)
    lo = window_blocks(bb, 1.2, window, W).to(torch.int64) * WINDOW_CHUNK
    total = bboxes.shape[0] * OUT * OUT * 3 * out_bytes
    for b in range(bboxes.shape[0]):
        rows = _taps_read(*axis_taps(ys[b], H))
        cols = {c for c in _taps_read(*axis_taps(xs[b], W)) if lo[b] <= c < lo[b] + window}
        total += len(rows) * len(cols) * 3
    return total


def window_crop_check(device, main_frames):
    """K3 against its plain version on the card (f32 bit-equal, bf16 within
    4/255) at windows 384 and 512, and bit-equal to K1 on every frame whose
    box crop_window_fits admits; K1m (2 and 4 frames per block) against the
    plain crop (f32 bit-equal, bf16 within 4/255); then their experiment
    tool (tools/exp_window_crop) on CHUNK of the smoke's frames with the
    tool's tracked-person boxes. Returns the K3 and K1m rows."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch_plain, crop_batch_windowed_plain
    from poserisk_release_tpu_torch.ops.resample import (
        crop_batch_cuda,
        crop_batch_multi_cuda,
        crop_batch_windowed_cuda,
    )
    from poserisk_release_tpu_torch.tools.exp_window_crop import tool_boxes, window_crop_ab

    f32 = torch.float32
    frames, bboxes = check_inputs(device, seed=3)
    errs = {}
    for window in (384, 512):
        got32 = crop_batch_windowed_cuda(frames, bboxes, window=window, out_dtype=f32)
        got16 = crop_batch_windowed_cuda(frames, bboxes, window=window)
        want = crop_batch_windowed_plain(frames, bboxes, window=window, out_dtype=f32)
        full = crop_batch_cuda(frames, bboxes)
        fits = (bboxes[:, 2] * 1.2 + 2.0 + 128 <= window).nonzero().flatten()
        sync(device)
        errs[window] = {"f32": float((got32 - want).abs().max()),
                        "bf16_vs_f32": float((got16.float() - want).abs().max()),
                        "vs_k1_where_fits": float((got32[fits] - full[fits]).abs().max()),
                        "frames_fitting": int(fits.numel())}
    want = crop_batch_plain(frames, bboxes)
    multi_errs = {}
    for fpb in (2, 4):
        got32 = crop_batch_multi_cuda(frames, bboxes, fpb, out_dtype=f32)
        got16 = crop_batch_multi_cuda(frames, bboxes, fpb)
        sync(device)
        multi_errs[fpb] = {"f32": float((got32 - want).abs().max()),
                           "bf16_vs_f32": float((got16.float() - want).abs().max())}
    print(json.dumps({"phase": "window_crop_check", "frames": list(frames.shape), "errs": errs,
                      "frames_per_block_errs": multi_errs}))
    for e in errs.values():
        if not (e["f32"] == 0.0 and e["vs_k1_where_fits"] == 0.0 and e["frames_fitting"] > 0):
            raise AssertionError(f"windowed crop kernel disagrees: {errs}")
        if not e["bf16_vs_f32"] <= 4.0 / 255.0:
            raise AssertionError(f"windowed crop kernel bf16 off by more than 4/255: {errs}")
    for e in multi_errs.values():
        if not (e["f32"] == 0.0 and e["bf16_vs_f32"] <= 4.0 / 255.0):
            raise AssertionError(f"multi-frame crop kernel disagrees: {multi_errs}")

    f = torch.as_tensor(main_frames[:CHUNK], device=device)
    boxes, narrow = (torch.as_tensor(b, device=device)
                     for b in tool_boxes(np.random.RandomState(0), CHUNK))
    reset_launch_counts()
    rows = window_crop_ab(f, boxes, narrow)
    k3_all, k1m_all = crop_batch_windowed_cuda.launches, crop_batch_multi_cuda.launches
    # The kernels line counts the tool's one pass (each row's checked call),
    # not its timing loops.
    k3_launches = sum(r["launches"] for n, r in rows.items() if n.startswith("K3"))
    k1m_launches = sum(r["launches"] for n, r in rows.items() if "frames/block" in n)
    # The rows of the kernels line: f32 on the tool's inputs, as K1's row is
    # f32 (window 512 for K3, 2 frames per block for K1m; these calls come
    # after the counts were read).
    ms = time_ms(lambda: crop_batch_windowed_cuda(f, boxes, window=512, out_dtype=f32))
    multi_ms = {fpb: time_ms(lambda fpb=fpb: crop_batch_multi_cuda(f, boxes, fpb, out_dtype=f32))
                for fpb in (2, 4)}
    k1_ms = time_ms(lambda: crop_batch_cuda(f, boxes, out_dtype=f32))
    plain_ms = time_ms(lambda: crop_batch_windowed_plain(f, boxes, window=512, out_dtype=f32),
                       reps=5, per_rep=2)
    k1_plain_ms = time_ms(lambda: crop_batch_plain(f, boxes), reps=5, per_rep=2)
    library_ms = time_ms(grid_sample_crop(f, boxes))
    H, W = FRAME_HW
    n_bytes = window_crop_bytes(boxes.cpu().numpy(), H, W, 512, 4)
    k1_bytes = crop_bytes(boxes.cpu().numpy(), H, W, 4)
    k3 = crop_row("crop_batch_windowed_cuda", "poserisk_release_tpu/ops/resample_pallas.py:336",
                  k3_launches, max(e["f32"] for e in errs.values()), ms, plain_ms, n_bytes,
                  library_ms)
    k1m = crop_row("crop_batch_multi_cuda", "tools/exp_window_crop.py:70", k1m_launches,
                   max(e["f32"] for e in multi_errs.values()), multi_ms[2], k1_plain_ms,
                   k1_bytes, library_ms)
    print(json.dumps({"phase": "window_crop_tool", "k3_launches_one_pass": k3_launches,
                      "k1m_launches_one_pass": k1m_launches, "k3_launches_with_timing": k3_all,
                      "k1m_launches_with_timing": k1m_all, "rows": rows,
                      "f32": {"k3_win512_ms": ms, "k1m_ms": multi_ms, "k1_ms": k1_ms,
                              "k3_plain_ms": plain_ms, "k1_plain_ms": k1_plain_ms,
                              "library_ms": library_ms, "k3_bytes": n_bytes,
                              "k1_bytes": k1_bytes, "k3_bound_ms": k3["bound_ms"],
                              "k1m_bound_ms": k1m["bound_ms"]}}))
    if not (k3_launches == 2 and k1m_launches == 2 and k3_all >= 2 and k1m_all >= 2):
        raise AssertionError(f"the window crop tool did not launch K3 and K1m: {rows}")
    return k3, k1m


# The root bench.py's record keys, and the device keys every result of the
# port's bench carries besides.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "fps_passes", "fps_median",
              "variance_band", "strict_fps", "strict_vs_baseline", "strict_fps_passes",
              "strict_fps_median", "strict_variance_band", "strict_unit"}
BENCH_DEVICE_KEYS = {"device", "power_limit", "peak_bytes", "strict_peak_bytes"}
BENCH_ENV = {"BENCH_BATCH": "128", "BENCH_PASSES": "2", "BENCH_STRICT": "1"}


def bench_phase(device) -> int:
    """The port's bench (poserisk_release_tpu_torch.bench) in-process at its
    defaults but BENCH_ENV: the full-frame step at full width, bf16, int8
    YOLO on the rect canvas, fused K2, strides 8/8 and then 1/1. Its record
    must carry bench.py's keys and the device keys, positive rates, and the
    card's name. Returns K2's launches."""
    import importlib

    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop_cuda

    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("BENCH_")}
    os.environ.update(BENCH_ENV)
    try:
        bench = importlib.reload(importlib.import_module("poserisk_release_tpu_torch.bench"))
        reset_launch_counts()
        t0 = time.perf_counter()
        record = bench.main()
        seconds = time.perf_counter() - t0
        launches = fused_letterbox_crop_cuda.launches
    finally:
        for k in BENCH_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
    print(json.dumps({"phase": "bench_phase", "env": BENCH_ENV, "seconds": seconds,
                      "k2_launches": launches, "record": record}))
    if set(record) != BENCH_KEYS | BENCH_DEVICE_KEYS:
        raise AssertionError(f"bench record keys: {sorted(record)}")
    if not (record["value"] > 0 and record["strict_fps"] > 0):
        raise AssertionError(f"bench rates: {record['value']}, {record['strict_fps']}")
    if record["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench device {record['device']!r}")
    if launches <= 0:
        raise AssertionError("the bench launched no letterbox+crop kernel")
    return launches


TOOLS_PROFILE_BATCH, TOOLS_PROFILE_MEASURE, TOOLS_E2E_FRAMES = 32, 8, 128
E2E_STAGES = {"decode+track (overlapped)", "pose", "score.device", "score"}


def _finite_positive(*values) -> bool:
    return all(np.isfinite(v) and v > 0 for v in values)


def tools_phase(device) -> tuple:
    """The port's measurement tools in-process at reduced sizes, each run
    printing its tables and one line: profile_stages at B = 32 (K1 and K2
    must launch, every row finite and positive); roofline_detector's three
    largest classes with bf16 and the chain mode on its first stage (23
    shape classes); roofline_spin on its first stage, bf16 and int8;
    bench_e2e on synthetic frames without plots (the card's machine has
    neither opencv nor matplotlib): every stage key, fps above 0; and
    graft_entry.entry(), whose fn equals a direct call of
    throughput.make_pose_and_score_step on the same crops (scores exact,
    floats within 1e-6, scores in 1-12 and 1-7). Returns K1's and K2's
    launches over the phase."""
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda, fused_letterbox_crop_cuda
    from poserisk_release_tpu_torch.tools import (
        bench_e2e,
        profile_stages,
        roofline_detector,
        roofline_spin,
    )

    reset_launch_counts()
    t0 = time.perf_counter()
    prof = profile_stages.profile(device, TOOLS_PROFILE_BATCH, measure=TOOLS_PROFILE_MEASURE)
    rows = prof["stages"]["rows"]
    serving = [ms for r in prof["serving"]["rows"] for ms in r["ms"].values()]
    print(json.dumps({"phase": "tools_profile_stages", "batch": TOOLS_PROFILE_BATCH,
                      "rows": len(rows), "k1_launches": prof["k1_launches"],
                      "k2_launches": prof["k2_launches"], "seconds": time.perf_counter() - t0}))
    if not (prof["k1_launches"] > 0 and prof["k2_launches"] > 0):
        raise AssertionError(f"profile_stages launched K1 {prof['k1_launches']} and K2 "
                             f"{prof['k2_launches']} times")
    if len(rows) != 9 or not _finite_positive(*(v for r in rows for v in (r["ms"], r["host_ms"])),
                                                *serving):
        raise AssertionError(f"profile_stages rows: {rows}, serving {serving}")

    t0 = time.perf_counter()
    n_classes = len(roofline_detector.shape_classes())
    det = roofline_detector.classes_table(device, top=3, bf16=True)
    chain = roofline_detector.chain_table(device, bf16=True,
                                          stages=roofline_detector.CHAIN_STAGES[:1])
    print(json.dumps({"phase": "tools_roofline_detector", "classes": n_classes,
                      "rows": det["rows"], "chain": chain["rows"],
                      "seconds": time.perf_counter() - t0}))
    if n_classes != 23 or not _finite_positive(
            *(r[k] for r in det["rows"] for k in ("ms_int8", "ms_bf16"))):
        raise AssertionError(f"roofline_detector: {n_classes} classes, rows {det['rows']}")
    if not all(np.isfinite(r[k]) for r in chain["rows"] for k in ("ms_int8", "ms_pure", "ms_bf16")):
        raise AssertionError(f"roofline_detector chain: {chain['rows']}")

    t0 = time.perf_counter()
    spin = roofline_spin.stage_table(device, int8=True, stages=roofline_spin.STAGES[:1])
    print(json.dumps({"phase": "tools_roofline_spin", "rows": spin["rows"],
                      "seconds": time.perf_counter() - t0}))
    if not all(np.isfinite(r[k]) for r in spin["rows"] for k in ("ms_bf16", "ms_int8")):
        raise AssertionError(f"roofline_spin: {spin['rows']}")

    t0 = time.perf_counter()
    e2e = bench_e2e.main(["--synthetic", "--no_plots", "--frames", str(TOOLS_E2E_FRAMES)])
    print(json.dumps({"phase": "tools_bench_e2e", "frames": TOOLS_E2E_FRAMES, "record": e2e,
                      "seconds": time.perf_counter() - t0}))
    if not (E2E_STAGES <= set(e2e["stage_timings_sec"]) and e2e["value"] > 0
            and e2e["decoder"] == "synthetic"):
        raise AssertionError(f"bench_e2e record: {e2e}")

    t0 = time.perf_counter()
    graft = graft_check(device)
    graft["seconds"] = time.perf_counter() - t0
    print(json.dumps(graft))
    return crop_batch_cuda.launches, fused_letterbox_crop_cuda.launches


def graft_check(device) -> dict:
    """graft_entry.entry(): fn on its example_args and on 8 seeded crops
    against a direct call of make_pose_and_score_step with an estimator of
    the same (default) weights."""
    from poserisk_release_tpu_torch import graft_entry
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_pose_and_score_step,
    )

    fn, example_args = graft_entry.entry()
    cfg = default_config()
    est = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device=device)
    step = make_pose_and_score_step(est.parents)
    infos = [torch.as_tensor(a, device=device) for a in default_packed_infos()]
    crops = torch.rand((8, OUT, OUT, 3), device=device,
                       generator=torch.Generator(device=device).manual_seed(5))
    line = {"phase": "tools_graft_entry", "example_shape": list(example_args[0].shape)}
    for name, x in (("example_args", example_args[0]), ("seeded", crops)):
        got = fn(x)
        with torch.inference_mode():
            want = step(est.model, est.smpl_params, x, *infos)
        reba, rula = got[0].cpu().numpy(), got[1].cpu().numpy()
        same = bool(np.array_equal(reba, want[0].cpu().numpy())
                    and np.array_equal(rula, want[1].cpu().numpy()))
        diff = max(float((g - w).abs().max()) for g, w in zip(got[2:], want[2:]))
        line[name] = {"scores_equal": same, "float_max_abs_diff": diff,
                      "reba": sorted(set(reba.tolist())), "rula": sorted(set(rula.tolist()))}
        if not (same and diff <= 1e-6 and reba.min() >= 1 and reba.max() <= 12
                and rula.min() >= 1 and rula.max() <= 7
                and [tuple(t.shape) for t in got] == [(8,), (8,), (8, 24, 3), (8, 24, 3)]):
            raise AssertionError(f"graft_entry against the direct step: {line}")
    return line


DRYRUN_RANKS = 4
# The dry run's sections that crop or letterbox on every rank (K1 through
# the unfused full steps and the estimators; K2 through every full step's
# letterbox and the resample alone); under pp only stage 0 crops.
DRYRUN_K1 = ("full_step", "int8_step", "pose_stride_step", "tp", "sp", "ep")
DRYRUN_K2 = ("full_step", "int8_step", "pose_stride_step", "fused_resample")


def dryrun_phase() -> tuple:
    """graft_entry.dryrun_multichip(DRYRUN_RANKS): every section's flag true,
    the model axes included, and K1 and K2 launched on every rank of the
    sections that crop (pp: one rank, its first stage). Prints the record
    and the seconds; returns the ranks' K1 and K2 launches."""
    from poserisk_release_tpu_torch import graft_entry

    t0 = time.perf_counter()
    rec = graft_entry.dryrun_multichip(DRYRUN_RANKS)
    s = rec["sections"]
    print(json.dumps({"phase": "dryrun_multichip", "seconds": time.perf_counter() - t0,
                      "section_seconds": {k: v["seconds"] for k, v in s.items()},
                      "record": rec}))
    missing = {"tp", "sp", "pp", "ep", "train"} - set(s)
    if rec["n_devices"] != DRYRUN_RANKS or missing or not all(v["ok"] for v in s.values()):
        raise AssertionError(f"dryrun_multichip: missing {missing}, record {rec}")
    silent = [(k, s[k]["k1"]) for k in DRYRUN_K1 if min(s[k]["k1"]) <= 0]
    silent += [(k, s[k]["k2"]) for k in DRYRUN_K2 if min(s[k]["k2"]) <= 0]
    if sum(n > 0 for n in s["pp"]["k1"]) != 1:
        silent.append(("pp", s["pp"]["k1"]))
    if silent:
        raise AssertionError(f"dryrun_multichip: a rank launched no kernel: {silent}")
    return (sum(sum(v["k1"]) for v in s.values()), sum(sum(v["k2"]) for v in s.values()))


EXP_BATCH, EXP_BIG_BATCH, EXP_MEASURE = 32, 128, 4
EXP_TIMING = {"reps": 3, "per_rep": 1, "warmup": 1}
SESSIONS, SESSION_STREAM_FRAMES, SOAK_SMOKE_FRAMES, HOTLOOP_FRAMES = 2, 8, 512, 16


def experiments_phase(device) -> tuple:
    """The JAX repo's last tools through the port, in-process at reduced
    sizes (EXP_BATCH frames or crops, one pass of EXP_MEASURE host calls,
    EXP_TIMING device samples): each prints its table or JSON line and a
    line with its seconds, and every time it reports must be finite and
    positive. exp_int8_glue's chain on the card must equal its plain
    version on the CPU (every int8 tensor exactly, detections within
    exp_int8_glue.DET_RTOL). validate_real_assets runs with no asset: every
    section skips. Returns K1's and K2's launches over the phase."""
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda, fused_letterbox_crop_cuda
    from poserisk_release_tpu_torch.tools import (
        ab,
        bench_reference_hotloop,
        exp_det_stride,
        exp_int8_glue,
        exp_mixed_int8,
        exp_pose_stride,
        exp_resample,
        exp_spin_early,
        exp_spin_mixed,
        smoke_stream_session,
        soak_streaming,
        validate_real_assets,
    )

    saved, ab.TIMING = ab.TIMING, EXP_TIMING
    reset_launch_counts()
    b, m = EXP_BATCH, EXP_MEASURE
    runs = [
        ("exp_resample", lambda: exp_resample.resample_ab(device, b, 1, m)),
        ("exp_det_stride", lambda: exp_det_stride.det_stride_ab(device, b, 1, m)),
        ("exp_pose_stride",
         lambda: exp_pose_stride.pose_stride_ab(device, b, EXP_BIG_BATCH, 1, m)),
        ("exp_mixed_int8", lambda: exp_mixed_int8.mixed_int8_ab(device, b, 1, m)),
        ("exp_spin_mixed", lambda: exp_spin_mixed.spin_mixed_ab(device, b, 1, m)),
        ("exp_int8_glue", lambda: exp_int8_glue.int8_glue_ab(device, b, 1, m)),
        ("exp_spin_early", lambda: exp_spin_early.spin_early_ab(device, b, m, 1)),
        ("smoke_stream_session",
         lambda: smoke_stream_session.run(device, SESSIONS, SESSION_STREAM_FRAMES, 4)),
        ("soak_streaming", lambda: soak_streaming.run(device, SOAK_SMOKE_FRAMES, 180, 320,
                                                      256, True)),
        ("bench_reference_hotloop", lambda: bench_reference_hotloop.main(
            ["--frames", str(HOTLOOP_FRAMES), "--with-ours"])),
        ("validate_real_assets", lambda: validate_real_assets.main([])),
    ]
    t_phase = time.perf_counter()
    try:
        for name, fn in runs:
            t0 = time.perf_counter()
            rec = fn()
            seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()
            if name == "validate_real_assets":
                times = [seconds]
                ok = rec == {"smpl": None, "spin": None, "yolo": None, "video": {}}
            elif name in ("smoke_stream_session", "soak_streaming"):
                times = [rec["value"], rec["elapsed_sec"]]
                ok = rec["scored" if name == "smoke_stream_session" else "frames_scored"] > 0
            elif name == "bench_reference_hotloop":
                times = [rec["value"], rec["ours_fps"]]
                ok = rec["ours_device"] == torch.cuda.get_device_name(0)
            else:
                rows = rec["rows"] + rec.get("full_step_rows", [])
                times = [r[k] for r in rows for k in ("ms", "host_ms", "graph_ms") if k in r]
                ok = rec["device"] == torch.cuda.get_device_name(0)
            if name == "exp_int8_glue":  # the chain's card branch against its plain one
                ok = ok and rec["card_vs_plain"]["ok"]
            print(json.dumps({"phase": "experiments_phase", "tool": name, "seconds": seconds,
                              "k1_launches": rec.get("k1_launches"),
                              "k2_launches": rec.get("k2_launches"),
                              **({"card_vs_plain": rec["card_vs_plain"]}
                                 if name == "exp_int8_glue" else {})}))
            if not (ok and _finite_positive(*times)):
                raise AssertionError(f"{name}: {rec}")
    finally:
        ab.TIMING = saved
    k1, k2 = crop_batch_cuda.launches, fused_letterbox_crop_cuda.launches
    print(json.dumps({"phase": "experiments_phase", "seconds": time.perf_counter() - t_phase,
                      "k1_launches": k1, "k2_launches": k2}))
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"the experiments launched K1 {k1} and K2 {k2} times")
    return k1, k2


def augment_check(device) -> None:
    """The training augmentation crop (ops/crop.crop_batch_affine, plain
    PyTorch) on the card, on the CHUNK x 450x800 check frames with rotation,
    flip and colour scale, held within 1e-5 of the same call on the CPU."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch_affine

    frames, bboxes = check_inputs(device, seed=2)
    rng = np.random.RandomState(2)
    args = (bboxes, torch.as_tensor(rng.uniform(1.2, 1.5, CHUNK), dtype=torch.float32),
            torch.as_tensor(rng.uniform(-45.0, 45.0, CHUNK), dtype=torch.float32),
            torch.as_tensor(rng.rand(CHUNK) < 0.5),
            torch.as_tensor(rng.uniform(0.8, 1.2, (CHUNK, 3)), dtype=torch.float32))
    dev_args = tuple(a.to(device) for a in args)
    got = crop_batch_affine(frames, *dev_args)
    want = crop_batch_affine(frames.cpu(), *(a.cpu() for a in args))
    err = float((got.cpu() - want).abs().max())
    ms = time_ms(lambda: crop_batch_affine(frames, *dev_args), reps=10, per_rep=2)
    print(json.dumps({"phase": "augment_check", "frames": list(frames.shape),
                      "out": list(got.shape), "max_abs_err_vs_cpu": err, "ms": ms}))
    if not (got.shape == (CHUNK, OUT, OUT, 3) and err <= 1e-5):
        raise AssertionError(f"augmentation crop on the card vs the CPU: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from poserisk_release_tpu_torch import _build
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(json.dumps({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "python": sys.version.split()[0],
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))

    t0 = time.perf_counter()
    sources = ["crop", "letterbox_crop", "skin", "yolo_stage"]
    _build.build(sources)
    print(json.dumps({"phase": "build", "sources": [n + ".cu" for n in sources],
                      "seconds": time.perf_counter() - t0}))

    rng = np.random.RandomState(0)
    frames = synthetic_frames(rng, N_FRAMES)
    cfg = default_config().replace(PARALLEL={"frames_per_step": CHUNK})
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    variables = init_spin_params(torch.Generator().manual_seed(0),
                                 load_mean_params(cfg.SPIN.smpl_mean_params))

    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker, filter_and_select_target

    tracks = MultiPersonTracker(StubDetector())(frames)
    main_bboxes, main_track_frames = filter_and_select_target(tracks, len(frames), 0.33)
    main_bboxes = np.asarray(main_bboxes, np.float32)
    k1 = check_crop_kernel(device, frames, main_bboxes)
    k2 = check_letterbox_crop_kernel(device, frames, main_bboxes)

    def cpu_ref(bboxes, track_frames, card_est, k=4):
        """The port's CPU path on the first k tracked frames, in the card
        estimator's configuration (and with its int8 backbone, if any)."""
        cpu_est = PoseEstimator(cfg, smpl, variables=variables, fast=card_est.fast,
                                device="cpu")
        if card_est.quant_params is not None:
            cpu_est.load_quant_backbone(card_est.quant_params)
        e, j, _ = cpu_est.run_from_frames(frames, track_frames[:k], bboxes[:k], chunk=k)
        return e, j

    k1["launches"], aa, track_frames, _ = main_path(device, frames, False, variables, smpl,
                                                    cfg, cpu_ref)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("strict path left TF32 on")
    print(json.dumps({"phase": "tf32", "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
    main_path(device, frames, True, variables, smpl, cfg)
    k1["launches"] += streaming_path(device, variables, smpl, cfg)
    k1["launches"] += serving_path(device, frames, main_bboxes, main_track_frames, variables,
                                   smpl, cfg)
    k1["launches"] += parallel_path(device, frames, main_bboxes, main_track_frames, variables,
                                    smpl, cfg)
    k1["launches"] += data_prep(device, frames, tracks)
    k1["launches"] += train_single(device, frames, main_bboxes, main_track_frames, variables,
                                   smpl, cfg, smi)
    k1["launches"] += train_mesh(device, frames, main_bboxes, main_track_frames, variables, cfg,
                                 smi)

    k2_launches, yolo_sd = detector_path(device, frames)
    k2_launches += full_frame(device, frames, main_bboxes, yolo_sd, variables, smpl, cfg, False)
    k2_launches += full_frame(device, frames, main_bboxes, yolo_sd, variables, smpl, cfg, True)
    k4 = debug_mesh(device, cfg, smpl, variables, aa, track_frames)

    # The int8 PTQ paths: --fast_detector, --spin_int8, and both in the
    # full-frame step (fast, strides 8/8).
    from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50

    launches, q_yolo = int8_detector_path(device, frames)
    k2_launches += launches
    _, _, _, int8_est = main_path(device, frames, True, variables, smpl, cfg, cpu_ref,
                                  spin_int8=True)
    k2_launches += full_frame(device, frames, main_bboxes, q_yolo, variables, smpl, cfg, True,
                              quant_backbone=prepare_resnet50(int8_est.quant_params, device))
    k2_launches += bench_phase(device)
    tools_k1, tools_k2 = tools_phase(device)
    k1["launches"] += tools_k1
    k2_launches += tools_k2
    for phase_k1, phase_k2 in (dryrun_phase(), experiments_phase(device)):
        k1["launches"] += phase_k1
        k2_launches += phase_k2
    k2["launches"] = k2_launches
    k5 = stage_check(device, frames)
    k3, k1m = window_crop_check(device, frames)
    augment_check(device)

    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k1m]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
