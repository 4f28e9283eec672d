"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/, holds each against its
plain PyTorch version at the main path's shapes (and times kernel, plain
version, one library call and the byte bound), then drives the port's pose
path the way the Predictor does -- StubDetector -> MultiPersonTracker ->
target selection -> PoseEstimator.run_from_frames (64-frame chunks,
ResNet-50 + 3-step IEF at full width, seeded random weights, synthetic SMPL)
-> REBA/RULA scorers -> stats and result txts -- once strict (f32) and once
fast (bf16), with every kernel launch counter set to 0 just before each run
and read just after. The card's strict output is held against the port's
CPU path on a small input. The Predictor's own video decode needs opencv,
which the card's machine need not have, so frames are made with numpy.

Prints one line per phase, then a JSON line with every kernel's numbers,
the nvidia-smi name/power-limit line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0,
no last line). Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, non-tensor-core f32
N_FRAMES, FRAME_HW, CHUNK, OUT = 128, (450, 800), 64, 224


def time_ms(fn, reps: int = 20, per_rep: int = 10, warmup: int = 5) -> float:
    """Device milliseconds of one fn() call: the median over `reps` samples,
    each a CUDA-event pair around `per_rep` back-to-back calls, after
    `warmup` calls. Before each sample the card sleeps ~2 ms, so the host
    enqueues the timed calls while it is busy and they then run back to
    back: the sample holds device time, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


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


def check_crop_kernel(device, main_frames, main_bboxes) -> dict:
    """K1 against its plain version on the card, then timings at the main
    path's shapes (one 64-frame chunk of tracked 450x800 frames)."""
    import torch.nn.functional as F

    from poserisk_release_tpu_torch.ops.crop import crop_batch_plain
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

    rng = np.random.RandomState(0)
    H, W = FRAME_HW
    frames = torch.as_tensor(rng.randint(0, 256, (CHUNK, H, W, 3)).astype(np.uint8), device=device)
    edge = np.array([[400.0, 225.0, 220.0, 220.0], [100.0, 80.0, 60.0, 120.0],
                     [780.0, 440.0, 100.0, 50.0], [-20.0, 10.0, 80.0, 80.0]], np.float32)
    side = rng.uniform(40, 520, CHUNK - 4)
    rand = np.stack([rng.uniform(-60, W + 60, CHUNK - 4), rng.uniform(-60, H + 60, CHUNK - 4),
                     side, side], axis=1).astype(np.float32)
    bboxes = torch.as_tensor(np.concatenate([edge, rand]), device=device)

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
    # Yardstick only (the port never calls it): grid_sample with the same
    # sampling (align_corners=True maps -1/+1 to pixel centres 0 and size-1,
    # zero padding) on frames already converted to float NCHW.
    from poserisk_release_tpu_torch.ops.crop import crop_coords

    ys, xs = crop_coords(bb, 1.2, OUT)
    grid = torch.stack([
        (2.0 * xs / (W - 1) - 1.0)[:, None, :].expand(-1, OUT, -1),
        (2.0 * ys / (H - 1) - 1.0)[:, :, None].expand(-1, -1, OUT)], dim=-1)
    f_nchw = f.permute(0, 3, 1, 2).float() / 255.0

    def library():
        return F.grid_sample(f_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    lib_err = float((library().permute(0, 2, 3, 1) - crop_batch_cuda(f, bb)).abs().max())
    library_ms = time_ms(library)
    n_bytes = crop_bytes(main_bboxes[:CHUNK], H, W, 4)
    n_flops = CHUNK * OUT * OUT * 3 * 10
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S) * 1e3
    row = {"name": "crop_batch_cuda", "route": "cuda",
           "source": "poserisk_release_tpu_torch/csrc/crop.cu",
           "replaces": "poserisk_release_tpu/ops/resample_pallas.py:426",
           "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_flops / FP32_FLOPS_PER_S
           else "operations",
           "library_ms": library_ms}
    print(json.dumps({"phase": "crop_timing", "shape": [CHUNK, H, W, 3],
                      "bytes": n_bytes, "ms_f32": ms, "ms_bf16": ms16,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "library_max_abs_err": lib_err, "bound_ms": bound_ms}))
    return row


def main_path(device, frames, fast: bool, variables, smpl, cfg, cpu_ref=None):
    """Drive the pose path once; returns (launches, result dict)."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.outputs.stats import post_process_scores, write_result_txt
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_add_info
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker, filter_and_select_target

    est = PoseEstimator(cfg, smpl, variables=variables, fast=fast, device=device)
    est.run_from_frames(frames, np.arange(CHUNK), np.tile([[400.0, 225.0, 400.0, 400.0]],
                                                           (CHUNK, 1)))  # warm-up
    torch.cuda.synchronize()

    crop_batch_cuda.launches = 0
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
        chunk_ms = {"crop": time_ms(lambda: crop_batch(f, bb, out_dtype=crops.dtype)),
                    "hmr": time_ms(lambda: est.model(crops), per_rep=2),
                    "pose_step": time_ms(lambda: est._pose_step_from_frames(f, bb), per_rep=2)}
    chunk_ms["rotations+joints"] = chunk_ms["pose_step"] - chunk_ms["hmr"] - chunk_ms["crop"]
    line = {"phase": "main_path_fast" if fast else "main_path_strict",
            "frames": len(frames), "tracked": n, "crop_launches": launches,
            "pose_frames_per_s": n / t["pose"], "stage_s": t, "chunk_ms": chunk_ms,
            "reba_mode": int(np.bincount(scores["REBA"]).argmax()),
            "rula_mode": int(np.bincount(scores["RULA"]).argmax())}
    if cpu_ref is not None:
        ref_euler, ref_joints = cpu_ref(bboxes, track_frames)
        k = ref_euler.shape[0]
        d_e = np.abs(euler[:k] - ref_euler)
        d_e = float(np.minimum(d_e, 360.0 - d_e).max())
        d_j = float(np.abs(joint_cam[:k] - ref_joints).max())
        line.update(cpu_ref_frames=k, euler_max_abs_diff_deg=d_e, joint_max_abs_diff_mm=d_j)
        if not (d_e < 0.05 and d_j < 0.05):
            raise AssertionError(f"card vs CPU path: euler {d_e} deg, joints {d_j} mm")
    print(json.dumps(line))
    if launches <= 0:
        raise AssertionError("the main path launched no crop kernel")
    return launches


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
    _build.build(["crop"])
    print(json.dumps({"phase": "build", "sources": ["crop.cu"],
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
    main_bboxes, _ = filter_and_select_target(tracks, len(frames), 0.33)
    kernel = check_crop_kernel(device, frames, np.asarray(main_bboxes, np.float32))

    cpu_est = PoseEstimator(cfg, smpl, variables=variables, device="cpu")

    def cpu_ref(bboxes, track_frames, k=4):
        e, j, _ = cpu_est.run_from_frames(frames, track_frames[:k], bboxes[:k], chunk=k)
        return e, j

    kernel["launches"] = main_path(device, frames, False, variables, smpl, cfg, cpu_ref)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("strict path left TF32 on")
    print(json.dumps({"phase": "tf32", "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
    main_path(device, frames, True, variables, smpl, cfg)

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
