"""A/B of the detection stride on the product full-frame step, on one card.

    python -m poserisk_release_tpu_torch.tools.exp_det_stride [--batch 128] [--cpu]

The counterpart of the JAX repo's tools/exp_det_stride.py:
throughput.make_full_frame_step (letterbox + YOLOv3 on frames[::N] + crop +
SPIN + scores; rect canvas, the int8 YOLOv3 calibrated on the first 16
frames' letterbox, the bf16 SPIN backbone, bf16 resample outputs) at
detection strides STRIDES, fused (K2 letterboxing every Nth frame in its
one pass) and, above stride 1, unfused (K2's letterbox-only mode on
frames[::N] + K1 on every frame). B uniform uint8 450x800 frames drawn on
the card, every box [400, 225, 220, 220], seeded full-width weights.

Every configuration is interleaved in one process over two passes
(tools/ab.interleaved). The table has the JAX tool's columns on the host
clock (24 enqueued steps, one readback, the faster pass) and the device
ms (CUDA events) beside them. Runs on the card unless --cpu is given (a
rehearsal on the plain versions).
"""

from __future__ import annotations

import argparse
import json

import torch

from poserisk_release_tpu_torch.tools import ab

STRIDES = (1, 2, 4, 8)


def config_names(strides=STRIDES) -> list:
    """The JAX tool's configurations in its order: "{s}/fused", and
    "{s}/unfused" above stride 1."""
    names = []
    for s in strides:
        names.append(f"{s}/fused")
        if s > 1:
            names.append(f"{s}/unfused")
    return names


def det_stride_ab(device, batch: int = ab.B, passes: int = ab.PASSES,
                  measure: int = ab.MEASURE, strides=STRIDES) -> dict:
    """Times every configuration; prints the table and returns the record."""
    from poserisk_release_tpu_torch.throughput import make_full_frame_step

    k0 = ab.launches()
    m = ab.estimators(device)
    est, (ir, iu) = m["fast"], m["infos"]
    frames, boxes = ab.uniform_frames(device, batch), ab.tile_boxes(device, batch)
    yolo = ab.int8_yolo(ab.folded_yolo(), frames)
    steps = {}
    for name in config_names(strides):
        s, mode = name.split("/")
        step = make_full_frame_step(est.parents, yolo, compute_dtype=torch.bfloat16,
                                    fused_resample=mode == "fused", det_stride=int(s))
        steps[name] = lambda step=step: step(est.model, est.smpl_params, frames, boxes, ir, iu)
    det = {}
    print(f"device {device}; batch {batch}; full step (int8 detector, rect, bf16), "
          "interleaved", flush=True)
    times = ab.interleaved(steps, device, passes, measure,
                           warm=lambda name, out: det.__setitem__(name, int(out[2].shape[0])))
    print(f"\n| det stride | ms / {batch} frames | fps/chip | vs stride 1 | device ms |")
    print("|---|---|---|---|---|")
    base = times[f"{strides[0]}/fused"]["host_ms"]
    rows = []
    for name, t in times.items():
        rows.append({"config": name, "det_best_frames": det[name],
                     "fps": batch / t["host_ms"] * 1e3, "vs_stride_1": base / t["host_ms"], **t})
        print(f"| {name} | {t['host_ms']:.2f} | {batch / t['host_ms'] * 1e3:.0f} | "
              f"{base / t['host_ms']:.2f}x | {t['ms']:.2f} |", flush=True)
    rec = ab.record("exp_det_stride", device, rows, k0, batch=batch, passes=passes,
                    measure=measure)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=ab.B)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return det_stride_ab(ab.tool_device(args.cpu), args.batch)


if __name__ == "__main__":
    main()
