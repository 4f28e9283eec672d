"""A/B of the pose stride on the product full-frame step, on one card.

    python -m poserisk_release_tpu_torch.tools.exp_pose_stride [--batch 128] [--big-batch 512] [--cpu]

The counterpart of the JAX repo's tools/exp_pose_stride.py:
throughput.make_full_frame_step (letterbox + YOLOv3 on frames[::D] + crop
and SPIN on frames[::P] + slerp + scores; rect canvas, the int8 YOLOv3,
the bf16 SPIN backbone, bf16 outputs of the fused resample, K2, in its
frame-stride mode) in the JAX tool's eight configurations (CONFIGS): the
pose-stride sweep at detection stride 8, pose stride alone at detection
stride 1, and the largest configuration with the int8 SPIN backbone
(quantized and bias-corrected on 8 uniform crops), also at 512 frames so
the anchor batch stays at 64. B uniform uint8 450x800 frames drawn on the
card (the b512 row's 512 frames, 553 MB of uint8, beside them), every box
[400, 225, 220, 220], seeded full-width weights.

Interleaved in one process over two passes (tools/ab.interleaved); the
JAX tool's columns on the host clock (24 enqueued steps, one readback) and
the device ms beside them. Prints the card's max_memory_allocated over the
run, the b512 row included. Runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from poserisk_release_tpu_torch.tools import ab

B2 = 512
# name, detection stride, pose stride, int8 SPIN, the big batch
CONFIGS = (
    ("det1/pose1", 1, 1, False, False),
    ("det1/pose8", 1, 8, False, False),
    ("det8/pose1", 8, 1, False, False),
    ("det8/pose2", 8, 2, False, False),
    ("det8/pose4", 8, 4, False, False),
    ("det8/pose8", 8, 8, False, False),
    ("det8/pose8/int8spin", 8, 8, True, False),
    ("det8/pose8/int8spin/b512", 8, 8, True, True),
)


def pose_stride_ab(device, batch: int = ab.B, big_batch: int = B2, passes: int = ab.PASSES,
                   measure: int = ab.MEASURE) -> dict:
    """Times every configuration; prints the table and returns the record."""
    from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50
    from poserisk_release_tpu_torch.models.spin import quantize_spin_backbone
    from poserisk_release_tpu_torch.throughput import make_full_frame_step

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k0 = ab.launches()
    m = ab.estimators(device)
    est, (ir, iu) = m["fast"], m["infos"]
    frames, boxes = ab.uniform_frames(device, batch), ab.tile_boxes(device, batch)
    big_frames, big_boxes = ab.uniform_frames(device, big_batch, seed=2), ab.tile_boxes(
        device, big_batch)
    yolo = ab.int8_yolo(ab.folded_yolo(), frames)
    quant = prepare_resnet50(
        quantize_spin_backbone(m["variables"], ab.uniform_crops(device, 8, seed=1)), device)
    steps, sizes = {}, {}
    for name, det_s, pose_s, spin_q, big in CONFIGS:
        step = make_full_frame_step(est.parents, yolo, compute_dtype=torch.bfloat16,
                                    fused_resample=True, det_stride=det_s, pose_stride=pose_s,
                                    quant_backbone=quant if spin_q else None)
        f, b = (big_frames, big_boxes) if big else (frames, boxes)
        steps[name] = lambda step=step, f=f, b=b: step(est.model, est.smpl_params, f, b, ir, iu)
        sizes[name] = f.shape[0]
    print(f"device {device}; batch {batch} (+{big_batch} variant); full step (int8 detector, "
          "rect, bf16, fused resample), interleaved", flush=True)
    times = ab.interleaved(steps, device, passes, measure)
    print("\n| config | ms / batch | fps/chip | vs det8/pose1 | device ms |")
    print("|---|---|---|---|---|")
    base = times["det8/pose1"]["host_ms"] / batch
    rows = []
    for name, t in times.items():
        n = sizes[name]
        rows.append({"config": name, "batch": n, "fps": n / t["host_ms"] * 1e3,
                     "vs_det8_pose1": base / (t["host_ms"] / n), **t})
        print(f"| {name} | {t['host_ms']:.2f} | {n / t['host_ms'] * 1e3:.0f} | "
              f"{base / (t['host_ms'] / n):.2f}x | {t['ms']:.2f} |", flush=True)
    rec = ab.record("exp_pose_stride", device, rows, k0, batch=batch, big_batch=big_batch,
                    passes=passes, measure=measure)
    print(f"peak device memory: {rec['max_memory_allocated']} B", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=ab.B)
    ap.add_argument("--big-batch", type=int, default=B2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return pose_stride_ab(ab.tool_device(args.cpu), args.batch, args.big_batch)


if __name__ == "__main__":
    main()
