"""A/B of kernel K3, the windowed crop, against the full-width crop kernel K1.

    python -m poserisk_release_tpu_torch.tools.exp_window_crop [batch] [--cpu]

The counterpart of the JAX package's tools/exp_window_crop.py: seeded
uint8 450x800 frames and tracked-person boxes (centres drifting across the
frame, widths 180-220 px, which crop_window_fits admits at window 512; the
window-384 row uses narrower boxes, 140-210 px), timed in one process:

  plain   ops/crop.crop_batch_plain (torch ops, bf16 output)
  K1      ops/resample.crop_batch_cuda (full width)
  K3      ops/resample.crop_batch_windowed_cuda, windows 512 and 384
  K1 x2, x4   ops/resample.crop_batch_multi_cuda (K1m): K1 with 2 and 4
              frames per block (the JAX tool's frames-per-program probe)

with each row's output delta against K1. Runs on the card unless --cpu is
given (then only the plain versions run, timed by the host clock).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

OUT = 224


def tool_boxes(rng: np.random.RandomState, B: int, H: int = 450, W: int = 800):
    """(boxes fitting window 512, narrow boxes fitting window 384), (B, 4)
    float32 [cx, cy, w, h], as the JAX tool draws them."""
    from poserisk_release_tpu_torch.ops.crop import crop_window_fits

    boxes = np.stack([rng.uniform(150, 650, B), rng.uniform(180, 270, B),
                      rng.uniform(180, 220, B), rng.uniform(300, 430, B)],
                     axis=1).astype(np.float32)
    narrow = boxes.copy()
    narrow[:, 2] = rng.uniform(140, 210, B)
    assert crop_window_fits(boxes, window=512) and crop_window_fits(narrow, window=384)
    return boxes, narrow


def _launch_count() -> int:
    """Launches of K1, K3 and K1m in this process."""
    from poserisk_release_tpu_torch.ops import resample

    return (resample.crop_batch_cuda.launches + resample.crop_batch_windowed_cuda.launches
            + resample.crop_batch_multi_cuda.launches)


def window_crop_ab(frames: torch.Tensor, boxes: torch.Tensor,
                   narrow: torch.Tensor) -> Dict[str, dict]:
    """Times and output deltas of every row (see the module docstring);
    returns {row: {"ms", "max_abs_diff_vs_k1", "mean_abs_diff_vs_k1",
    "launches"}} and prints the table. `launches` counts the kernel launches
    of the row's one checked call, not of its timing loop."""
    from poserisk_release_tpu_torch.ops.crop import (
        crop_batch,
        crop_batch_plain,
        crop_batch_windowed,
    )
    from poserisk_release_tpu_torch.tools.timing import time_ms

    device = frames.device
    bf16 = torch.bfloat16
    rows = {
        "plain": (lambda: crop_batch_plain(frames, boxes, out_dtype=bf16), boxes),
        "K1 full": (lambda: crop_batch(frames, boxes, out_dtype=bf16), boxes),
        "K3 win512": (lambda: crop_batch_windowed(frames, boxes, window=512), boxes),
        "K3 win384 (narrow)": (lambda: crop_batch_windowed(frames, narrow, window=384), narrow),
    }
    if device.type == "cuda":
        from poserisk_release_tpu_torch.ops.resample import crop_batch_multi_cuda

        for fpb in (2, 4):
            rows[f"K1 {fpb} frames/block"] = (
                lambda fpb=fpb: crop_batch_multi_cuda(frames, boxes, fpb), boxes)
    refs = {id(b): crop_batch(frames, b, out_dtype=bf16).float() for b in (boxes, narrow)}
    out = {}
    with torch.inference_mode():
        for name, (fn, bb) in rows.items():
            n0 = _launch_count()
            d = (fn().float() - refs[id(bb)]).abs()
            launches = _launch_count() - n0
            slow = name == "plain"
            ms = time_ms(fn, device, reps=5 if slow else 20, per_rep=2 if slow else 10)
            out[name] = {"ms": ms, "max_abs_diff_vs_k1": float(d.max()),
                         "mean_abs_diff_vs_k1": float(d.mean()), "launches": launches}
    base = out["K1 full"]["ms"]
    print(f"device {device}; {frames.shape[0]} frames {tuple(frames.shape[1:3])}; "
          "bf16 crops; windowed (K3) vs full-width (K1)")
    print("| row | ms | vs K1 | max abs diff vs K1 | mean abs diff vs K1 |")
    print("|---|---|---|---|---|")
    for name, r in out.items():
        print(f"| {name} | {r['ms']:.4f} | {base / r['ms']:.2f}x | "
              f"{r['max_abs_diff_vs_k1']:.5f} | {r['mean_abs_diff_vs_k1']:.6f} |", flush=True)
    return out


def main(argv=None) -> int:
    from poserisk_release_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        from poserisk_release_tpu_torch import _build

        _build.build(["crop"])
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (args.batch, 450, 800, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    boxes, narrow = (torch.as_tensor(b, device=device) for b in tool_boxes(rng, args.batch))
    window_crop_ab(frames, boxes, narrow)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
