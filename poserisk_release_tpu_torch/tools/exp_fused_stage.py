"""A/B of kernel K5, the fused int8 residual stage, against the per-conv int8 chain.

    python -m poserisk_release_tpu_torch.tools.exp_fused_stage [--stages 256 512 1024]
        [--batch 64] [--cpu]

The counterpart of the JAX package's tools/exp_fused_stage.py: the seed-0
YOLOv3 init, BN-folded, calibrated on seeded frames and quantized whole
tower; then on each residual stage of the 288x416 rect canvas (C256 36x52
8 blocks, C512 18x26 8 blocks, C1024 9x13 4 blocks) a bf16 stage input
drawn from a seed goes through ops/yolo_stage.fused_residual_stage (K5 on
the card) and through the per-conv int8 chain (ops/qconv, torch._int_mm on
the card, bf16 between convs as the JAX tool's chain), interleaved in one
process. Prints the A/B table and K5's agreement with its plain version,
with each stage's time beside its operations bound (stage_bound) and the
kernel design's byte floor (stage_floor); on the card each row also splits
one K5 call's device time by kernel (kernel_split, torch.profiler). Runs on
the card unless --cpu is given (then both sides are plain torch on the
host, timed by the host clock).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from poserisk_release_tpu_torch.tools.timing import HBM_BYTES_PER_S, INT8_OPS_PER_S

# stage -> (spec index of its first 1x1 conv, blocks, H, W on the rect canvas)
STAGE_GEOM = {256: (13, 8, 36, 52), 512: (38, 8, 18, 26), 1024: (63, 4, 9, 13)}


def calibrated_qparams(frames_u8: np.ndarray, device) -> Dict[str, np.ndarray]:
    """The seed-0 YOLOv3 init, BN-folded, calibrated on the rect-416
    letterbox of `frames_u8` on `device`, quantized whole tower."""
    from poserisk_release_tpu_torch.models import detector as det
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect

    folded = det.fold_bn_params(det.init_yolo_params(0))
    model = det.YoloV3.from_state_dict(folded).to(device, memory_format=torch.channels_last)
    letter = letterbox_device_rect(torch.as_tensor(frames_u8, device=device), 416)
    return det.quantize_yolo_params(folded, det.calibrate_yolo_activations(model, letter))


def conv_chain(qparams: Dict, start: int, n_blocks: int, device):
    """The per-conv int8 chain over one stage's blocks (QConv2d layers built
    once), on a bf16 stream: h (B, H, W, C) -> (B, H, W, C)."""
    from poserisk_release_tpu_torch.models.detector import qconv_block, quantized_layer

    def block(i):
        return qconv_block(quantized_layer(qparams, f"conv_{i}"), i).to(device)

    pairs = [(block(start + 3 * j), block(start + 3 * j + 1)) for j in range(n_blocks)]

    def run(h: torch.Tensor) -> torch.Tensor:
        x = h.permute(0, 3, 1, 2)
        for b1, b3 in pairs:
            x = x + b3(b1(x, torch.bfloat16), torch.bfloat16)
        return x.permute(0, 2, 3, 1)

    return run


def stage_bound(B: int, H: int, W: int, C: int, n_blocks: int, in_bytes: int):
    """(bound ms, 'bytes' | 'operations', ops): 10*H*W*C^2 int8 operations
    per block and frame; bytes: the stream read once and written once, plus
    the int8 weights and the f32 epilogue vectors."""
    ops = 10 * H * W * C * C * n_blocks * B
    n_bytes = 2 * B * H * W * C * in_bytes + n_blocks * (5 * C * C + 4 * 3 * C + 8)
    t_ops, t_bytes = ops / INT8_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops


def stage_floor(B: int, H: int, W: int, C: int, n_blocks: int, io_bytes: int):
    """(floor ms, 'bytes' | 'operations') of K5's design, which keeps the
    f32 stream in device memory between launches. Bytes: the stage's input
    (io_bytes an element) read by the quantize launch and by the first 3x3,
    its output written once at the same width, the f32 stream written and
    read between blocks (n - 1 times each), the int8 handoff q (M x C)
    written n times (the quantize launch, then every 3x3 but the last) and
    read n times, aq (M x C/2) written once a block (its 3x3 gathers hit
    L2), and the weights and epilogue vectors read once, as in stage_bound.
    Or the operations, if they take longer (at C1024 the stream fits the 50
    MB L2)."""
    M = B * H * W
    n_bytes = (M * C * (3 * io_bytes + 2 * 4 * (n_blocks - 1))
               + n_blocks * (2 * M * C + M * C // 2 + 5 * C * C + 4 * 3 * C + 8))
    t_ops = 10 * H * W * C * C * n_blocks * B / INT8_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_split(fn) -> Dict[str, list]:
    """One fn() call on the card under torch.profiler: for each kernel it
    launched, [device ms summed over its launches, launches] (empty if the
    profiler sees no device time)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            # "void (anonymous namespace)::conv3x3_kernel(...)" -> conv3x3_kernel
            name = re.sub(r"\(.*$", "", e.key.replace("(anonymous namespace)::", ""))
            name = name.split("::")[-1].replace("void ", "")
            out[name] = [us / 1e3, e.count]
    return out


def stage_ab(qparams: Dict, device, stages=(256, 512, 1024), batch: int = 64,
             seed: int = 0) -> List[dict]:
    """For each stage: K5 against its plain version (max abs error in f32)
    and the A/B timings. Returns one row per stage, whose `launches` counts
    K5's kernel launches in the one checked call (not in the timing loops);
    prints the table. On the card each row's `kernels` is kernel_split of
    one K5 call (empty on the CPU)."""
    from poserisk_release_tpu_torch.ops.yolo_stage import (
        device_pack,
        fused_residual_stage,
        fused_residual_stage_cuda,
        fused_residual_stage_plain,
        pack_yolo_stage,
    )
    from poserisk_release_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for c in stages:
        start, n, H, W = STAGE_GEOM[c]
        h = (torch.rand((batch, H, W, c), generator=gen, device=device) * 2.5 - 0.5).to(
            torch.bfloat16)
        pack = pack_yolo_stage(qparams, start, n)
        on_card = torch.device(device).type == "cuda"
        if on_card:
            pack = device_pack(pack, device)
        chain = conv_chain(qparams, start, n, device)
        with torch.inference_mode():
            n0 = fused_residual_stage_cuda.launches
            got = fused_residual_stage(h, pack, n)
            launches = fused_residual_stage_cuda.launches - n0
            want = fused_residual_stage_plain(h, pack, n)
            err = float((got.float() - want.float()).abs().max())
            chain_err = float((chain(h).float() - want.float()).abs().max())
            fused_ms = time_ms(lambda: fused_residual_stage(h, pack, n), device)
            chain_ms = time_ms(lambda: chain(h), device)
            plain_ms = time_ms(lambda: fused_residual_stage_plain(h, pack, n), device, reps=3,
                               per_rep=1, warmup=1)
            split = kernel_split(lambda: fused_residual_stage(h, pack, n)) if on_card else {}
        bound_ms, bound_by, ops = stage_bound(batch, H, W, c, n, 2)
        floor_ms, floor_by = stage_floor(batch, H, W, c, n, 2)
        rows.append({"stage": c, "hw": [H, W], "blocks": n, "batch": batch, "launches": launches,
                     "max_abs_err": err, "chain_max_abs_err": chain_err, "ms": fused_ms,
                     "chain_ms": chain_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "pct_of_bound": 100 * bound_ms / fused_ms, "floor_ms": floor_ms,
                     "floor_by": floor_by, "tops": ops / fused_ms / 1e9, "kernels": split})
    print(f"device {torch.device(device)}; batch {batch}; fused stage (K5) vs the per-conv "
          "int8 chain (rect-canvas geometry)")
    print("| stage | HxW | blocks | chain ms | fused ms | speedup | TOPS | bound ms | "
          "% of bound | floor ms | K5 vs plain |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| C{r['stage']} | {r['hw'][0]}x{r['hw'][1]} | {r['blocks']} | "
              f"{r['chain_ms']:.3f} | {r['ms']:.3f} | {r['chain_ms'] / r['ms']:.2f}x | "
              f"{r['tops']:.1f} | {r['bound_ms']:.4f} | "
              f"{r['pct_of_bound']:.1f}% | {r['floor_ms']:.4f} ({r['floor_by']}) | "
              f"{r['max_abs_err']:.3g} |", flush=True)
        for name, (ms, count) in r["kernels"].items():
            print(f"  C{r['stage']} {name}: {ms:.4f} ms in {count} launches", flush=True)
    return rows


def main(argv=None) -> int:
    from poserisk_release_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", type=int, nargs="*", default=[256, 512, 1024])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        from poserisk_release_tpu_torch import _build

        _build.build(["yolo_stage"])
    frames = np.random.RandomState(0).randint(0, 200, (8, 450, 800, 3)).astype(np.uint8)
    stage_ab(calibrated_qparams(frames, device), device, args.stages, args.batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
