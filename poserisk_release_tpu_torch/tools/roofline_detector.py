"""Per-conv int8 roofline of the YOLOv3 detector on the rect canvas, on one card.

    python -m poserisk_release_tpu_torch.tools.roofline_detector [--top N] [--bf16]
        [--chain] [--cpu]

The counterpart of the JAX repo's tools/roofline_detector.py. It groups the
75 convs of models/detector.YOLOV3_SPEC on the 288x416 rect canvas into
their 23 shape classes (H, W, Cin, Cout, k, stride) and times one conv of
each class at batch 128 with the product's int8 arithmetic (all but the
three float heads, which the product keeps float): the QConv2d
that models/detector.qconv_block builds (quantize, im2col, torch._int_mm,
dequant + bias + leaky epilogue, all of ops/qconv), on seeded weights. With
--bf16 it also times the cuDNN bf16 conv + bias + leaky (the float
ConvBlock) of each class. Each row gives the class's share of the tower's
operations, ms for all its convs, and the rate against the H100's peaks
(tools/timing: 1,979 TOPS int8, 989 TFLOP/s bf16).

--chain times the body of each residual stage instead: pairs of (1x1
C->C/2, 3x3 C/2->C) convs chained at depths 3 and 9, whose slope is the
marginal ms of one pair with the fixed cost of a call cancelled. Per stage:
the product int8 pair (QConv2d, bf16 between convs), the bare s8 pair
(ops/qconv.int_conv_nhwc alone, its int32 sums shifted back to int8 as the
JAX tool does, no quantize or epilogue), and with --bf16 the cuDNN pair.
The glue share is (int8 - pure) / int8: what quantize, dequant and the
layout copies cost beside the products.

Device times are CUDA-event medians (tools/timing.time_ms). It runs on the
card unless --cpu is given (then on the CPU's plain versions, timed by the
host clock: a rehearsal, no device number). Prints a markdown table and
one JSON line with every row.
"""

from __future__ import annotations

import argparse
import json
from collections import OrderedDict

import numpy as np
import torch

from poserisk_release_tpu_torch.tools.timing import (
    BF16_FLOPS_PER_S,
    INT8_OPS_PER_S,
    device_name,
    peak_bytes,
)

B = 128
CANVAS = (288, 416)  # ops/crop.rect_canvas_geometry(450, 800, 416)
# (H, W, C, pairs in the tower, the heads' reuse of the shapes included)
CHAIN_STAGES = ((72, 104, 128, 2), (36, 52, 256, 11), (18, 26, 512, 11), (9, 13, 1024, 7))
CHAIN_DEPTHS = (3, 9)
TIMING = {"reps": 7, "per_rep": 2, "warmup": 2}


def _conv_walk(canvas=CANVAS):
    """(spec index, (H, W, Cin, Cout, k, stride), FLOPs of the conv for one
    frame) of every conv of YOLOV3_SPEC, with the JAX tool's route and
    upsample rules."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    hw, ch, hist = tuple(canvas), 3, []
    for i, e in enumerate(YOLOV3_SPEC):
        kind = e[0]
        if kind == "conv":
            _, f, k, s, _bn = e
            ho, wo = hw[0] // s, hw[1] // s
            yield i, (hw[0], hw[1], ch, f, k, s), 2 * ho * wo * k * k * ch * f
            hw, ch = (ho, wo), f
        elif kind == "route":
            refs = [r if r >= 0 else i + r for r in e[1]]
            hw = hist[refs[0]][:2]
            ch = sum(hist[r][2] for r in refs)
        elif kind == "upsample":
            hw = (hw[0] * 2, hw[1] * 2)
        hist.append((hw[0], hw[1], ch))


def shape_classes(canvas=CANVAS) -> "OrderedDict[tuple, list]":
    """The 23 conv shape classes of the tower: (H, W, Cin, Cout, k, stride)
    -> [count, FLOPs of one conv of the class for one frame], in spec order."""
    shapes: "OrderedDict[tuple, list]" = OrderedDict()
    for _i, key, flops in _conv_walk(canvas):
        shapes.setdefault(key, [0, flops])[0] += 1
    return shapes


def int8_classes(canvas=CANVAS) -> set:
    """The classes the product runs in int8: all but the three bias-only
    heads (Cout 255), which models/detector.quantize_yolo_params keeps
    float."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    return {key for i, key, _f in _conv_walk(canvas) if YOLOV3_SPEC[i][4]}


def spec_index(k: int, s: int) -> int:
    """The first spec conv with kernel k and stride s: the index that makes
    qconv_block build a conv of that geometry."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    return next(i for i, e in enumerate(YOLOV3_SPEC) if e[0] == "conv" and e[2:4] == (k, s))


def class_weights(cin: int, cout: int, k: int, seed: int = 0):
    """The JAX tool's seeded draws: an HWIO kernel N(0, 0.05) and a bias
    N(0, 0.01), float32."""
    rng = np.random.RandomState(seed)
    kern = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.01, (cout,)).astype(np.float32)
    return kern, bias


def int8_block(kern: np.ndarray, bias: np.ndarray, stride: int, device):
    """The product's int8 conv block of this geometry (models/detector.
    qconv_block): per-channel int8 weights (ops/qconv.quantize_kernel), the
    input scale 1/127 of the JAX tool, bias, leaky."""
    from poserisk_release_tpu_torch.models.detector import qconv_block
    from poserisk_release_tpu_torch.ops.qconv import quantize_kernel

    qkernel, w_scale = quantize_kernel(kern)
    layer = {"qkernel": qkernel, "w_scale": w_scale, "in_scale": np.float32(1.0 / 127.0),
             "q_bias_leaky": bias}
    return qconv_block(layer, spec_index(kern.shape[0], stride)).to(device)


def bf16_block(kern: np.ndarray, bias: np.ndarray, stride: int, device, leaky: bool = True):
    """The float conv block (models/detector.ConvBlock, BN folded) in bf16:
    cuDNN conv + bias + leaky (a head: conv + bias)."""
    from poserisk_release_tpu_torch.models.detector import ConvBlock

    k, cin, cout = kern.shape[0], kern.shape[2], kern.shape[3]
    block = ConvBlock(cin, cout, k, stride, bn=leaky, folded=True)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()))
        block.conv.bias.copy_(torch.from_numpy(bias))
    return block.to(device, torch.bfloat16, memory_format=torch.channels_last).eval()


def class_input(batch: int, h: int, w: int, c: int, device, seed: int = 0) -> torch.Tensor:
    """(batch, c, h, w) bf16 uniform in [-1, 1), channels-last in memory
    (the tower's layout), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((batch, h, w, c), generator=gen, device=device) * 2 - 1
    return x.to(torch.bfloat16).permute(0, 3, 1, 2)


def int8_conv_step(key, batch: int, device, seed: int = 0):
    """(fn, block, x): one conv of shape class `key` through the product's
    int8 QConv2d on seeded weights and a seeded bf16 input; fn() -> the
    block's bf16 NCHW output."""
    h, w, cin, cout, k, s = key
    kern, bias = class_weights(cin, cout, k, seed)
    block = int8_block(kern, bias, s, device)
    x = class_input(batch, h, w, cin, device, seed)
    return (lambda: block(x, torch.bfloat16)), block, x


def bf16_conv_step(key, batch: int, device, seed: int = 0, leaky: bool = True):
    h, w, cin, cout, k, s = key
    kern, bias = class_weights(cin, cout, k, seed)
    block = bf16_block(kern, bias, s, device, leaky)
    x = class_input(batch, h, w, cin, device, seed)
    return lambda: block(x)


def _ms(fn, device) -> float:
    from poserisk_release_tpu_torch.tools.timing import time_ms

    with torch.inference_mode():
        return time_ms(fn, device, **TIMING)


def classes_table(device, top: int = 0, bf16: bool = False, batch: int = B) -> dict:
    """Time each shape class (the `top` largest by share of operations, or
    all); prints the table and returns the record. A head class has no
    int8 time: the product keeps it float, and its Cout of 255 is no
    multiple of 8, which torch._int_mm needs."""
    shapes = shape_classes()
    int8 = int8_classes()
    total = sum(n * f for n, f in shapes.values())
    ranked = sorted(shapes.items(), key=lambda kv: -kv[1][0] * kv[1][1])
    if top:
        ranked = ranked[:top]
    print(f"device {device}; batch {batch}; canvas {CANVAS}; {len(ranked)}/{len(shapes)} "
          f"classes; total {total / 1e9:.1f} GFLOP/frame", flush=True)
    hdr = ("| HxW | Cin->Cout | k | s | n | share | ms(all,int8) | TOPS "
           f"| % of {INT8_OPS_PER_S / 1e12:.0f}T |")
    if bf16:
        hdr += f" ms(all,bf16) | bf16 TF/s | % of {BF16_FLOPS_PER_S / 1e12:.0f}T | int8 speedup |"
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    rows = []
    for key, (n, f1) in ranked:
        h, w, cin, cout, k, s = key
        row = {"key": list(key), "n": n, "share": n * f1 / total, "int8": key in int8}
        text = f"| {h}x{w} | {cin}->{cout} | {k} | {s} | {n} | {100 * row['share']:.1f}% | "
        if row["int8"]:
            fn, _block, _x = int8_conv_step(key, batch, device)
            ms1 = _ms(fn, device)
            del fn, _block, _x
            tops = f1 * batch / (ms1 / 1e3) / 1e12
            row.update(ms_int8=ms1 * n, tops=tops, pct_int8_peak=100 * tops * 1e12 / INT8_OPS_PER_S)
            text += f"{ms1 * n:.3f} | {tops:.1f} | {row['pct_int8_peak']:.1f}% |"
        else:
            text += "float head | - | - |"
        if bf16:
            msb1 = _ms(bf16_conv_step(key, batch, device, leaky=row["int8"]), device)
            tfs = f1 * batch / (msb1 / 1e3) / 1e12
            row.update(ms_bf16=msb1 * n, bf16_tflops=tfs,
                       pct_bf16_peak=100 * tfs * 1e12 / BF16_FLOPS_PER_S)
            text += f" {msb1 * n:.3f} | {tfs:.1f} | {row['pct_bf16_peak']:.1f}% |"
            if row["int8"]:
                row["int8_speedup"] = msb1 / ms1
                text += f" {msb1 / ms1:.2f}x |"
            else:
                text += " - |"
        rows.append(row)
        print(text, flush=True)
    record = {"tool": "roofline_detector", "mode": "classes", "device": device_name(device),
              "batch": batch, "classes": len(shapes), "rows": rows,
              "sum_ms_int8": sum(r["ms_int8"] for r in rows if r["int8"]),
              "max_memory_allocated": peak_bytes(device)}
    if bf16:
        record["sum_ms_bf16"] = sum(r["ms_bf16"] for r in rows)
        record["sum_ms_bf16_int8_classes"] = sum(r["ms_bf16"] for r in rows if r["int8"])
    print(f"\nsum of isolated int8 classes: {record['sum_ms_int8']:.2f} ms / {batch} frames"
          + (f"; bf16 {record['sum_ms_bf16_int8_classes']:.2f} ms on the same classes, "
             f"{record['sum_ms_bf16']:.2f} ms with the heads" if bf16 else ""))
    return record


def pair_weights(c: int, seed: int = 0):
    """The JAX chain's seeded draws: (k1 (1,1,C,C/2), k3 (3,3,C/2,C), b1, b3)."""
    rng = np.random.RandomState(seed)
    half = c // 2
    k1 = rng.normal(0, 0.05, (1, 1, c, half)).astype(np.float32)
    k3 = rng.normal(0, 0.05, (3, 3, half, c)).astype(np.float32)
    b1 = rng.normal(0, 0.01, (half,)).astype(np.float32)
    b3 = rng.normal(0, 0.01, (c,)).astype(np.float32)
    return k1, k3, b1, b3


def int8_pair_chain(h: int, w: int, c: int, batch: int, device, seed: int = 0):
    """chain(m) -> m product int8 pairs (QConv2d 1x1 then 3x3, bf16 between
    convs) on a seeded (batch, C, h, w) bf16 input."""
    k1, k3, b1, b3 = pair_weights(c, seed)
    one, three = int8_block(k1, b1, 1, device), int8_block(k3, b3, 1, device)
    x = class_input(batch, h, w, c, device, seed)

    def chain(m):
        y = x
        for _ in range(m):
            y = three(one(y, torch.bfloat16), torch.bfloat16)
        return y

    return chain


def pure_pair_chain(h: int, w: int, c: int, batch: int, device, seed: int = 0):
    """chain(m) -> m bare s8 pairs: ops/qconv.int_conv_nhwc (im2col +
    torch._int_mm) on seeded int8 activations and kernels, each int32 sum
    shifted right by 8 and cast back to int8 (the JAX tool's stand-in for
    a handoff)."""
    from poserisk_release_tpu_torch.ops.qconv import int_conv_nhwc, weight_matrix

    rng = np.random.RandomState(seed)
    half = c // 2
    gen = torch.Generator(device=device).manual_seed(seed)
    x8 = torch.randint(-127, 128, (batch, h, w, c), generator=gen, device=device,
                       dtype=torch.int8)
    w1 = torch.as_tensor(weight_matrix(rng.randint(-127, 128, (1, 1, c, half)).astype(np.int8)),
                         device=device)
    w3 = torch.as_tensor(weight_matrix(rng.randint(-127, 128, (3, 3, half, c)).astype(np.int8)),
                         device=device)

    def chain(m):
        y = x8
        for _ in range(m):
            y = (int_conv_nhwc(y, w1, 1, 1, 1, 0) >> 8).to(torch.int8)
            y = (int_conv_nhwc(y, w3, 3, 3, 1, 1) >> 8).to(torch.int8)
        return y

    return chain


def bf16_pair_chain(h: int, w: int, c: int, batch: int, device, seed: int = 0):
    k1, k3, b1, b3 = pair_weights(c, seed)
    one, three = bf16_block(k1, b1, 1, device), bf16_block(k3, b3, 1, device)
    x = class_input(batch, h, w, c, device, seed)

    def chain(m):
        y = x
        for _ in range(m):
            y = three(one(y))
        return y

    return chain


def slope_ms(chain, device, depths=CHAIN_DEPTHS) -> float:
    """Marginal ms of one chain link: the slope between two depths."""
    lo, hi = depths
    return (_ms(lambda: chain(hi), device) - _ms(lambda: chain(lo), device)) / (hi - lo)


def pair_flops(h: int, w: int, c: int) -> int:
    """Operations of one (1x1 C->C/2, 3x3 C/2->C) pair for one frame."""
    return 2 * h * w * (c * (c // 2) + 9 * (c // 2) * c)


def chain_table(device, bf16: bool = False, batch: int = B, stages=CHAIN_STAGES) -> dict:
    """The chain-slope table over `stages`; prints it and returns the record."""
    print(f"device {device}; batch {batch}; chain-slope mode (per residual pair: "
          f"1x1 C->C/2 + 3x3 C/2->C, depths {CHAIN_DEPTHS})", flush=True)
    hdr = ("| HxW | C | pairs | ms/pair int8 | pair TOPS | % of peak | ms/pair pure-s8 "
           "| pure TOPS | glue share |")
    if bf16:
        hdr += " ms/pair bf16 | bf16 TF/s | int8 speedup |"
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    rows = []
    for h, w, c, n in stages:
        ops = pair_flops(h, w, c) * batch
        ms = slope_ms(int8_pair_chain(h, w, c, batch, device), device)
        msp = slope_ms(pure_pair_chain(h, w, c, batch, device), device)
        row = {"hw": [h, w], "c": c, "pairs": n, "ms_int8": ms, "tops": ops / ms / 1e9,
               "ms_pure": msp, "pure_tops": ops / msp / 1e9, "glue_share": (ms - msp) / ms}
        row["pct_int8_peak"] = 100 * row["tops"] * 1e12 / INT8_OPS_PER_S
        text = (f"| {h}x{w} | {c} | {n} | {ms:.3f} | {row['tops']:.1f} | "
                f"{row['pct_int8_peak']:.1f}% | {msp:.3f} | {row['pure_tops']:.1f} | "
                f"{100 * row['glue_share']:.0f}% |")
        if bf16:
            msb = slope_ms(bf16_pair_chain(h, w, c, batch, device), device)
            row.update(ms_bf16=msb, bf16_tflops=ops / msb / 1e9, int8_speedup=msb / ms)
            text += f" {msb:.3f} | {row['bf16_tflops']:.1f} | {msb / ms:.2f}x |"
        rows.append(row)
        print(text, flush=True)
    record = {"tool": "roofline_detector", "mode": "chain", "device": device_name(device),
              "batch": batch, "depths": list(CHAIN_DEPTHS), "rows": rows,
              "total_ms_int8": sum(r["ms_int8"] * r["pairs"] for r in rows),
              "total_ms_pure": sum(r["ms_pure"] * r["pairs"] for r in rows),
              "max_memory_allocated": peak_bytes(device)}
    if bf16:
        record["total_ms_bf16"] = sum(r["ms_bf16"] * r["pairs"] for r in rows)
    print(f"\nbody pairs total: int8 {record['total_ms_int8']:.2f} ms, pure-s8 "
          f"{record['total_ms_pure']:.2f} ms"
          + (f", bf16 {record['total_ms_bf16']:.2f} ms" if bf16 else "")
          + f" / {batch} frames")
    return record


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=0,
                    help="only the N classes with the largest share of operations (0 = all)")
    ap.add_argument("--bf16", action="store_true", help="also time the bf16 conv")
    ap.add_argument("--chain", action="store_true",
                    help="chain-slope mode: marginal ms per residual pair")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.chain:
        record = chain_table(device, args.bf16)
    else:
        record = classes_table(device, args.top, args.bf16)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
