"""Throughput benchmark of the port: end-to-end device pipeline frames/s on
one card.

    python3 -m poserisk_release_tpu_torch.bench
    BENCH_INT8=0 python3 -m poserisk_release_tpu_torch.bench

The counterpart of the repository's root bench.py, with the same knobs
under the same names, defaults and validation. It measures the steady-state
per-frame device path of throughput.make_full_frame_step -- detector letterbox
+ YOLOv3 @ 416 on the rectangular canvas, crop, SPIN (ResNet-50 + IEF),
rotation conversions, SMPL joints, REBA + RULA scores -- on BENCH_BATCH
random uint8 frames of 450x800 drawn on the card. Video decode and host-side
SORT are outside it, as in bench.py.

Timing follows bench.py: WARMUP_STEPS synchronised steps, then
BENCH_PASSES passes that each enqueue MEASURE_STEPS steps, sum every step's
REBA scores and detector best scores on the card, read that sum back once
and stop the host clock. fps = MEASURE_STEPS * BENCH_BATCH / seconds; the
headline is the fastest pass, and every pass is kept. The strict_* fields
measure the same configuration at detection and pose stride 1 (the
reference's detect + pose every frame contract), unless the strides already
are 1/1 or BENCH_STRICT=0.

It runs on CUDA only: without a card it raises (device.resolve_device);
there is no CPU path and no retry. A failure, an out-of-memory error
included, surfaces.

Prints ONE JSON line: bench.py's keys (metric, value, unit, vs_baseline,
fps_passes, fps_median, variance_band and their strict_* counterparts) plus
device, power_limit, peak_bytes and strict_peak_bytes
(torch.cuda.max_memory_allocated over each configuration's run).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

REFERENCE_FPS_ESTIMATE = 30.0
BENCH_DTYPE = os.environ.get("BENCH_DTYPE", "bfloat16")
if BENCH_DTYPE not in ("bfloat16", "float32"):
    # Anything else would select float32 while the unit echoed the typo.
    raise SystemExit(
        f"BENCH_DTYPE must be 'bfloat16' or 'float32', got {BENCH_DTYPE!r}")
BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
BENCH_INT8 = os.environ.get("BENCH_INT8", "1") == "1"
BENCH_INT8_MIN_DS = int(os.environ.get("BENCH_INT8_MIN_DS", "1"))
BENCH_Q8 = os.environ.get("BENCH_Q8", "0") == "1"
BENCH_SPIN_INT8 = os.environ.get("BENCH_SPIN_INT8", "0") == "1"
BENCH_FUSED = os.environ.get("BENCH_FUSED", "1") == "1"
BENCH_DET_STRIDE = int(os.environ.get("BENCH_DET_STRIDE", "8"))
BENCH_POSE_STRIDE = int(os.environ.get("BENCH_POSE_STRIDE", "8"))
WARMUP_STEPS = 2
MEASURE_STEPS = 24
FRAME_HW = (450, 800)  # reference ingest cap (funcs_utils.py:26-31)
BENCH_STRICT = os.environ.get("BENCH_STRICT", "1") == "1"
BENCH_PASSES = max(2, int(os.environ.get("BENCH_PASSES", "3")))

UNIT = (
    "frames/sec/chip (detector+crop+SPIN+angles+joints+REBA+RULA, "
    f"{BENCH_DTYPE}{', int8 detector' if BENCH_INT8 else ''}"
    f"{', int8 SPIN' if BENCH_SPIN_INT8 else ''}, rect canvas"
    f"{', fused resample' if BENCH_FUSED else ''}"
    f"{f', det stride {BENCH_DET_STRIDE}' if BENCH_DET_STRIDE > 1 else ''}"
    f"{f', pose stride {BENCH_POSE_STRIDE}' if BENCH_POSE_STRIDE > 1 else ''})"
)
# bench.py's text, plus the batch: a card that cannot hold the strict
# configuration at the default batch is measured at a smaller one.
STRICT_UNIT = (
    "same config at det/pose stride 1 (the reference's detect+pose "
    "EVERY frame contract, lib/core/base.py:211-240); the headline "
    f"strides are an approximation policy on top; batch {BATCH}"
)


def band_fields(passes, prefix: str = "") -> dict:
    """Every pass (ascending), their median and (max - min) / median,
    rounded as bench.py rounds them."""
    med = statistics.median(passes)
    return {
        f"{prefix}fps_passes": [round(p, 1) for p in passes],
        f"{prefix}fps_median": round(med, 2),
        f"{prefix}variance_band": round((passes[-1] - passes[0]) / med, 4),
    }


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except FileNotFoundError:
        return "not measured"
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    """Run the benchmark on the card, print its record and return it."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.models.detector import (
        YoloV3,
        calibrate_yolo_activations,
        fold_bn_params,
        init_yolo_params,
        quantize_yolo_params,
    )
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_spin_variables
    from poserisk_release_tpu_torch.throughput import default_packed_infos, make_full_frame_step

    device = resolve_device()
    compute_dtype = torch.bfloat16 if BENCH_DTYPE == "bfloat16" else torch.float32
    cfg = default_config()
    variables = load_spin_variables(cfg)
    # fast=True stores the backbone in bf16 (HMR.cast_backbone); strict
    # f32 turns TF32 off, as the port's strict path does.
    estimator = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=variables,
                              fast=compute_dtype == torch.bfloat16, device=device)
    info_reba, info_rula = (torch.as_tensor(a, device=device) for a in default_packed_infos())
    quant_backbone = None
    if BENCH_SPIN_INT8:
        from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50
        from poserisk_release_tpu_torch.models.spin import quantize_spin_backbone

        calib_crops = torch.rand((8, 224, 224, 3), device=device,
                                 generator=torch.Generator(device=device).manual_seed(1))
        quant_backbone = prepare_resnet50(quantize_spin_backbone(variables, calib_crops), device)

    # Frames are drawn on the card, as bench.py draws them on the device.
    frames = torch.randint(0, 256, (BATCH, *FRAME_HW, 3), dtype=torch.uint8, device=device,
                           generator=torch.Generator(device=device).manual_seed(0))
    folded = fold_bn_params(init_yolo_params())
    if BENCH_INT8:
        float_model = YoloV3.from_state_dict(folded).to(device, memory_format=torch.channels_last)
        absmax = calibrate_yolo_activations(float_model, letterbox_device_rect(frames[:16], 416))
        del float_model
        # A quantized tower is built in its compute dtype (bf16).
        yolo = YoloV3.from_state_dict(quantize_yolo_params(
            folded, absmax, min_downsample=BENCH_INT8_MIN_DS, q8_handoff=BENCH_Q8))
        yolo = yolo.to(device, memory_format=torch.channels_last)
    else:
        yolo = YoloV3.from_state_dict(folded).to(device, compute_dtype,
                                                 memory_format=torch.channels_last)
    del folded
    bboxes = torch.tensor([400.0, 225.0, 220.0, 220.0], device=device).repeat(BATCH, 1)

    def build_step(det_stride: int, pose_stride: int):
        return make_full_frame_step(
            estimator.parents, yolo_model=yolo, img_size=416, compute_dtype=compute_dtype,
            rect=True, fused_resample=BENCH_FUSED, det_stride=det_stride,
            pose_stride=pose_stride, quant_backbone=quant_backbone)

    def measure_fps(step):
        """(the passes' fps, ascending; the configuration's peak bytes)."""
        def run_once():
            return step(estimator.model, estimator.smpl_params, frames, bboxes,
                        info_reba, info_rula)

        torch.cuda.reset_peak_memory_stats(device)
        for _ in range(WARMUP_STEPS):
            reba, rula, det_best = run_once()
            float(reba.sum() + rula.sum() + det_best.float().sum())

        def measure_pass() -> float:
            t0 = time.perf_counter()
            outs = [run_once() for _ in range(MEASURE_STEPS)]
            # One sum over every step's outputs on the card, then a single
            # readback: float() returns only after every step finished.
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for reba, _rula, det_best in outs:
                acc = acc + reba.sum() + det_best.float().sum()
            float(acc)
            return time.perf_counter() - t0

        passes = sorted(MEASURE_STEPS * BATCH / measure_pass() for _ in range(BENCH_PASSES))
        return passes, torch.cuda.max_memory_allocated(device)

    passes, peak = measure_fps(build_step(BENCH_DET_STRIDE, BENCH_POSE_STRIDE))
    fps = passes[-1]
    record = {
        "metric": "e2e_device_pipeline_fps_per_chip",
        "value": round(fps, 2),
        **band_fields(passes),
        "unit": UNIT,
        "vs_baseline": round(fps / REFERENCE_FPS_ESTIMATE, 2),
    }
    strict_peak = None
    if (BENCH_DET_STRIDE, BENCH_POSE_STRIDE) == (1, 1):
        # The headline is the strict contract already.
        strict_passes, strict_peak = passes, peak
    elif BENCH_STRICT:
        strict_passes, strict_peak = measure_fps(build_step(1, 1))
    else:
        strict_passes = None
    if strict_passes is not None:
        strict_fps = strict_passes[-1]
        record["strict_fps"] = round(strict_fps, 2)
        record["strict_vs_baseline"] = round(strict_fps / REFERENCE_FPS_ESTIMATE, 2)
        record.update(band_fields(strict_passes, prefix="strict_"))
        record["strict_unit"] = STRICT_UNIT
    record.update({"device": torch.cuda.get_device_name(device), "power_limit": power_limit(),
                   "peak_bytes": peak, "strict_peak_bytes": strict_peak})
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
