"""A/B of the mixed-precision and int8-handoff YOLOv3 configurations, on one card.

    python -m poserisk_release_tpu_torch.tools.exp_mixed_int8 [--batch 128] [--skip-full-step] [--cpu]

The counterpart of the JAX repo's tools/exp_mixed_int8.py, on the product
graph: models/detector.yolo_forward over the rect (288x416) bf16 letterbox
of B uniform uint8 450x800 frames drawn on the card, the seed-0 YOLOv3
BN-folded and calibrated on the first 16 letterboxed frames, in the JAX
tool's configurations (CONFIGS; quantize_yolo_params' min_downsample and
q8_handoff):

  full      int8 over the whole tower (min_downsample 1, no handoff)
  mixed     int8 only at input downsample >= 8 (the early tower bf16)
  mixed+q8  mixed, and each int8 conv whose one consumer is the next int8
            conv emits that conv's int8 input
  bf16      no quantization (cuDNN), for context

then the full-frame step (throughput.make_full_frame_step: bf16, fused K2,
strides 1/1, the bf16 SPIN backbone) with the full and the mixed+q8
towers, unless --skip-full-step. The int8 convs are ops/qconv's
(torch._int_mm on the card). Interleaved in one process over two passes;
the JAX tool's columns on the host clock (24 enqueued calls, one readback)
with the device ms beside them. Runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from poserisk_release_tpu_torch.tools import ab

# name: quantize_yolo_params keywords (the JAX tool's)
CONFIGS = {
    "full": {"min_downsample": 1, "q8_handoff": False},
    "mixed": {"min_downsample": 8, "q8_handoff": False},
    "mixed+q8": {"min_downsample": 8, "q8_handoff": True},
}
FULL_STEP_RUNS = (("step/full-int8", "full"), ("step/mixed+q8", "mixed+q8"))


def mixed_int8_ab(device, batch: int = ab.B, passes: int = ab.PASSES,
                  measure: int = ab.MEASURE, full_step: bool = True) -> dict:
    """Both tables; prints them and returns the record."""
    from poserisk_release_tpu_torch.models.detector import quantize_yolo_params, yolo_forward
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect

    k0 = ab.launches()
    frames = ab.uniform_frames(device, batch)
    with torch.inference_mode():
        letter = letterbox_device_rect(frames, 416, out_dtype=torch.bfloat16)
    folded = ab.folded_yolo()
    absmax = ab.yolo_absmax(folded, letter[:16])
    towers = {name: ab.yolo_module(quantize_yolo_params(folded, absmax, **kw), device)
              for name, kw in CONFIGS.items()}
    towers["bf16"] = ab.yolo_module(folded, device, torch.bfloat16)
    print(f"device {device}; batch {batch}; rect canvas {tuple(letter.shape[1:3])}; "
          "detector forward, interleaved", flush=True)
    times = ab.interleaved({name: (lambda t=t: yolo_forward(t, letter))
                            for name, t in towers.items()}, device, passes, measure)
    print(f"\n| config | ms / {batch} frames | vs full | device ms |")
    print("|---|---|---|---|")
    base = times["full"]["host_ms"]
    rows = []
    for name, t in times.items():
        rows.append({"config": name, "vs_full": base / t["host_ms"], **t})
        print(f"| {name} | {t['host_ms']:.2f} | {base / t['host_ms']:.2f}x | {t['ms']:.2f} |",
              flush=True)
    step_rows = []
    if full_step:
        from poserisk_release_tpu_torch.throughput import make_full_frame_step

        m = ab.estimators(device)
        est, (ir, iu) = m["fast"], m["infos"]
        boxes = ab.tile_boxes(device, batch)
        steps = {}
        for name, tower in FULL_STEP_RUNS:
            step = make_full_frame_step(est.parents, towers[tower], compute_dtype=torch.bfloat16,
                                        fused_resample=True)
            steps[name] = lambda step=step: step(est.model, est.smpl_params, frames, boxes, ir, iu)
        stimes = ab.interleaved(steps, device, passes, measure)
        print(f"\n| full step | ms / {batch} frames | fps/chip | device ms |")
        print("|---|---|---|---|")
        for name, t in stimes.items():
            step_rows.append({"config": name, "fps": batch / t["host_ms"] * 1e3, **t})
            print(f"| {name} | {t['host_ms']:.2f} | {batch / t['host_ms'] * 1e3:.0f} | "
                  f"{t['ms']:.2f} |", flush=True)
    rec = ab.record("exp_mixed_int8", device, rows, k0, full_step_rows=step_rows, batch=batch,
                    canvas=list(letter.shape[1:3]), passes=passes, measure=measure)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=ab.B)
    ap.add_argument("--skip-full-step", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return mixed_int8_ab(ab.tool_device(args.cpu), args.batch,
                         full_step=not args.skip_full_step)


if __name__ == "__main__":
    main()
