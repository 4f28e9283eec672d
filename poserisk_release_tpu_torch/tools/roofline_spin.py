"""Per-stage roofline of SPIN's ResNet-50 backbone (chain-slope mode), on one card.

    python -m poserisk_release_tpu_torch.tools.roofline_spin [--no-int8] [--cpu]

The counterpart of the JAX repo's tools/roofline_spin.py. For each ResNet
stage it chains the bottleneck block body (1x1 C->C/4, 3x3 C/4->C/4 pad 1,
1x1 C/4->C, residual add, ReLU) at depths 2 and 6 on a seeded batch of 128
and reports the slope, the marginal ms of one block with the fixed cost of
a call cancelled:

* in bf16 on cuDNN (channels-last, no bias, as the JAX tool);
* in int8 with the arithmetic of the port's models/resnet_int8 backbone:
  ops/qconv.QConv2d with a static per-tensor activation scale (1/127),
  per-channel weight scales, the dequant epilogue in float32 inside the
  block, and a bf16 carry between blocks, as the JAX tool's _chain_int8.

Rates are against the H100's peaks (tools/timing: 989 TFLOP/s bf16, 1,979
TOPS int8). Device times are CUDA-event medians (tools/timing.time_ms). It
runs on the card unless --cpu is given (then on the CPU, timed by the host
clock: a rehearsal, no device number). Prints a markdown table and one
JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from poserisk_release_tpu_torch.tools.roofline_detector import class_input, slope_ms
from poserisk_release_tpu_torch.tools.timing import (
    BF16_FLOPS_PER_S,
    INT8_OPS_PER_S,
    device_name,
    peak_bytes,
)

B = 128
# (H, W, C, blocks) of ResNet-50 at 224 input; the counts include the
# stride/projection blocks whose body convs share these shapes.
STAGES = [
    (56, 56, 256, 3),
    (28, 28, 512, 4),
    (14, 14, 1024, 6),
    (7, 7, 2048, 3),
]
DEPTHS = (2, 6)
IN_SCALE = np.float32(1.0 / 127.0)


def block_flops(h: int, w: int, c: int) -> int:
    """Operations of one bottleneck block body for one crop."""
    q = c // 4
    return 2 * h * w * (c * q + 9 * q * q + q * c)


def stage_kernels(c: int, seed: int = 0):
    """The JAX tool's seeded HWIO kernels N(0, 0.05): 1x1 C->C/4, 3x3
    C/4->C/4, 1x1 C/4->C."""
    rng = np.random.RandomState(seed)
    q = c // 4
    return [rng.normal(0, 0.05, s).astype(np.float32)
            for s in ((1, 1, c, q), (3, 3, q, q), (1, 1, q, c))]


def int8_layers(kernels, device):
    """QConv2d per kernel (models/resnet_int8's int8 convs: no activation
    in the layer, the block applies ReLU), zero bias, input scale 1/127."""
    from poserisk_release_tpu_torch.ops.qconv import QConv2d, quantize_kernel

    layers = []
    for k in kernels:
        qkernel, w_scale = quantize_kernel(k)
        layers.append(QConv2d(qkernel, w_scale, IN_SCALE, np.zeros(k.shape[3], np.float32),
                              1, (k.shape[0] - 1) // 2, act=None).to(device))
    return layers


def int8_block(layers, h: torch.Tensor) -> torch.Tensor:
    """One int8 bottleneck body: f32 between its convs, bf16 in and out."""
    l1, l3, l2 = layers
    y = torch.relu(l1(h, torch.float32))
    y = torch.relu(l3(y, torch.float32))
    y = l2(y, torch.float32)
    return torch.relu(h.float() + y).to(torch.bfloat16)


def bf16_block(weights, h: torch.Tensor) -> torch.Tensor:
    """One bf16 bottleneck body on cuDNN."""
    k1, k3, k2 = weights
    y = torch.relu(F.conv2d(h, k1))
    y = torch.relu(F.conv2d(y, k3, padding=1))
    return torch.relu(h + F.conv2d(y, k2))


def stage_chain(h: int, w: int, c: int, batch: int, device, int8: bool, seed: int = 0):
    """chain(m) -> m blocks of the stage on its seeded input."""
    kernels = stage_kernels(c, seed)
    x = class_input(batch, h, w, c, device, seed)
    if int8:
        layers = int8_layers(kernels, device)
        block = lambda t: int8_block(layers, t)  # noqa: E731
    else:
        weights = [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(
            device, torch.bfloat16, memory_format=torch.channels_last) for k in kernels]
        block = lambda t: bf16_block(weights, t)  # noqa: E731

    def chain(m):
        y = x
        for _ in range(m):
            y = block(y)
        return y

    return chain


def stage_table(device, int8: bool = True, batch: int = B, stages=STAGES) -> dict:
    """The per-stage slopes; prints the table and returns the record."""
    print(f"device {device}; batch {batch}; chain-slope per bottleneck block (1x1 C->C/4, "
          f"3x3 C/4->C/4, 1x1 C/4->C), depths {DEPTHS}", flush=True)
    hdr = f"| HxW | C | blocks | ms/block bf16 | TF/s | % of {BF16_FLOPS_PER_S / 1e12:.0f}T |"
    if int8:
        hdr += f" ms/block int8 | TOPS | % of {INT8_OPS_PER_S / 1e12:.0f}T | speedup |"
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    rows = []
    for h, w, c, n in stages:
        ops = block_flops(h, w, c) * batch
        ms = slope_ms(stage_chain(h, w, c, batch, device, False), device, DEPTHS)
        row = {"hw": [h, w], "c": c, "blocks": n, "ms_bf16": ms, "tflops": ops / ms / 1e9}
        row["pct_bf16_peak"] = 100 * row["tflops"] * 1e12 / BF16_FLOPS_PER_S
        text = (f"| {h}x{w} | {c} | {n} | {ms:.3f} | {row['tflops']:.1f} | "
                f"{row['pct_bf16_peak']:.1f}% |")
        if int8:
            msi = slope_ms(stage_chain(h, w, c, batch, device, True), device, DEPTHS)
            row.update(ms_int8=msi, tops=ops / msi / 1e9, speedup=ms / msi)
            row["pct_int8_peak"] = 100 * row["tops"] * 1e12 / INT8_OPS_PER_S
            text += (f" {msi:.3f} | {row['tops']:.1f} | {row['pct_int8_peak']:.1f}% | "
                     f"{ms / msi:.2f}x |")
        rows.append(row)
        print(text, flush=True)
    record = {"tool": "roofline_spin", "device": device_name(device), "batch": batch,
              "depths": list(DEPTHS), "rows": rows,
              "total_ms_bf16": sum(r["ms_bf16"] * r["blocks"] for r in rows),
              "max_memory_allocated": peak_bytes(device)}
    line = f"\nblock bodies total / {batch} crops: bf16 {record['total_ms_bf16']:.2f} ms"
    if int8:
        record["total_ms_int8"] = sum(r["ms_int8"] * r["blocks"] for r in rows)
        line += f", int8 {record['total_ms_int8']:.2f} ms"
    print(line)
    return record


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-int8", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    record = stage_table(device, not args.no_int8)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
