"""A/B of the fused letterbox + crop (K2) against the two resamples apart.

    python -m poserisk_release_tpu_torch.tools.exp_resample [batch] [--cpu]

The counterpart of the JAX repo's tools/exp_resample.py, on B (128) uniform
uint8 450x800 frames drawn on the card, every box [400, 225, 220, 220]:

  A  ops/crop.letterbox_device_rect (bf16; K2's letterbox-only mode on the
     card) + ops/crop.crop_batch (bf16; K1 on the card): the unfused path
  B  ops/resample.fused_letterbox_crop (bf16; K2, one read of each frame)

Prints the bf16 deltas between the arms (in 1/255 steps), each arm's
device ms (CUDA events) and host ms (24 enqueued calls, one readback,
interleaved, the faster of two passes) and the speedup. Runs on the card
unless --cpu is given (the plain versions, host clock only: a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import torch

from poserisk_release_tpu_torch.tools import ab


def resample_ab(device, batch: int = ab.B, passes: int = ab.PASSES,
                measure: int = ab.MEASURE) -> dict:
    """Both arms' deltas and times; prints them and returns the record."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch, letterbox_device_rect
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop

    k0 = ab.launches()
    bf16 = torch.bfloat16
    frames, boxes = ab.uniform_frames(device, batch), ab.tile_boxes(device, batch)
    steps = {
        "A letterbox + crop (bf16, K2 letterbox-only + K1)": lambda: (
            letterbox_device_rect(frames, 416, out_dtype=bf16),
            crop_batch(frames, boxes, scale=1.2, out_size=224, out_dtype=bf16)),
        "B fused letterbox+crop (K2)": lambda: fused_letterbox_crop(frames, boxes,
                                                                     out_dtype=bf16),
    }
    with torch.inference_mode():
        (lt_a, cr_a), (lt_b, cr_b) = (fn() for fn in steps.values())
        dl = float((lt_a.float() - lt_b.float()).abs().max())
        dc = float((cr_a.float() - cr_b.float()).abs().max())
    print(f"bf16 deltas: letterbox {dl * 255:.2f}/255, crop {dc * 255:.2f}/255", flush=True)
    times = ab.interleaved(steps, device, passes, measure)
    rows = []
    for name, t in times.items():
        rows.append({"arm": name, **t})
        print(f"{name}: {t['host_ms']:.3f} ms host, {t['ms']:.4f} ms device / {batch} frames",
              flush=True)
    a, b = (t["host_ms"] for t in times.values())
    da, db = (t["ms"] for t in times.values())
    print(f"speedup: {a / b:.3f}x host, {da / db:.3f}x device", flush=True)
    rec = ab.record("exp_resample", device, rows, k0, batch=batch,
                    letterbox_delta_255=dl * 255, crop_delta_255=dc * 255,
                    speedup_host=a / b, speedup_device=da / db)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=ab.B)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return resample_ab(ab.tool_device(args.cpu), args.batch)


if __name__ == "__main__":
    main()
