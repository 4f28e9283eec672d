"""A/B of the SPIN early tower (stem + maxpool + 56x56 stage) in situ, on one card.

    EXP_B=128 EXP_MEASURE=24 python -m poserisk_release_tpu_torch.tools.exp_spin_early [--cpu]

The counterpart of the JAX repo's tools/exp_spin_early.py: one in-situ
A/B per candidate on the product pose + score step
(throughput.make_pose_and_score_step, bf16 backbone, EXP_B uniform
224x224 crops drawn on the card), interleaved in one process over three
passes:

  baseline              the product step (the plain 7x7/s2 stem)
  s2d-stem              the same weights with the stem computed as
                        space-to-depth(2) + a 4x4/s1 conv whose kernel is
                        an exact rearrangement of the 7x7 one (s2d_stem_conv;
                        the JAX package's StemConv(s2d=True), which the port
                        leaves out of the product: it lives here alone)
  layer1-ablated(2blk)  layer1 cut to its projection block (ResNet-50 with
                        layers (1, 4, 6, 3); the two dropped blocks' weights
                        go unused), so (t_base - t_ablated) / 2 is the
                        in-situ cost of one 56x56 block

Each row has the JAX tool's columns on the host clock (EXP_MEASURE
enqueued steps, one readback, the fastest pass), the device ms (CUDA
events) and the ms of one replay of the step captured as a CUDA graph
(tools/ab.graphs_ms: the eager step at B = 128 is paced by the host's
~1,430 launches, which hides a block's cost; a graph, like the JAX tool's
compiled step, does not), and the median |Euler delta| against the
baseline. The last line sets the in-situ 56x56 block cost on each clock
beside its bounds on this card (the block's bytes over the HBM rate, its
operations over the bf16 peak; from tools/timing). Runs on the card
unless --cpu is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from poserisk_release_tpu_torch.tools import ab

PASSES = 3
ROWS = ("baseline", "s2d-stem", "layer1-ablated(2blk)")  # the JAX tool's, in its order


def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The 7x7 OIHW stem kernel (F, C, 7, 7) as the 4x4 kernel (F, 4C, 4, 4)
    over space-to-depth(2) input: the 7x7 taps sit at offset (1, 1) of an
    8x8 grid (row 0 is the zero-weight tap at full-resolution offset -4), and
    half-resolution tap (m, n) of channel (dr * 2 + dc) * C + c reads grid
    tap (2m + dr, 2n + dc) of channel c."""
    f, c = weight.shape[:2]
    k8 = weight.new_zeros((f, c, 8, 8))
    k8[:, :, 1:, 1:] = weight
    return k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)


def s2d_stem_conv(x: torch.Tensor, weight: torch.Tensor, k4: torch.Tensor | None = None):
    """The 7x7 / stride-2 / pad-3 conv of NCHW x (even H and W) computed as
    space-to-depth(2) (channel (dr * 2 + dc) * C + c holds pixel (2i + dr,
    2j + dc) of channel c) and a stride-1 4x4 conv padded (2, 1) on each
    axis: the same convolution in another loop order."""
    b, c, h, w = x.shape
    y = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(
        b, 4 * c, h // 2, w // 2)
    return F.conv2d(F.pad(y, (2, 1, 2, 1)), s2d_kernel(weight) if k4 is None else k4)


class S2DStem(nn.Module):
    """The HMR's conv1 (7x7 / s2 / pad 3, no bias) through s2d_stem_conv,
    holding the original kernel as `weight` (the HMR reads its dtype)."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.weight = conv.weight
        self.register_buffer("k4", s2d_kernel(conv.weight.detach()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return s2d_stem_conv(x, self.weight, self.k4)


def with_s2d_stem(model):
    """A copy of the HMR whose stem runs through S2DStem."""
    model = copy.deepcopy(model)
    model.conv1 = S2DStem(model.conv1)
    return model


def layer1_ablated(model):
    """A copy of the HMR with layer1 cut to its first (projection) block."""
    model = copy.deepcopy(model)
    model.layer1 = nn.Sequential(model.layer1[0])
    return model


def block_bounds_ms(batch: int) -> tuple:
    """(bytes bound, operations bound) of one 56x56x256 bottleneck block in
    bf16 at `batch` crops: its input and output (256 channels) and its two
    64-channel intermediates written and read once, over the HBM rate; its
    three convs' operations over the bf16 peak."""
    from poserisk_release_tpu_torch.tools import timing
    from poserisk_release_tpu_torch.tools.roofline_spin import block_flops

    n_bytes = (256 + 256 + 2 * 2 * 64) * 56 * 56 * 2 * batch
    return (n_bytes / timing.HBM_BYTES_PER_S * 1e3,
            block_flops(56, 56, 256) * batch / timing.BF16_FLOPS_PER_S * 1e3)


def spin_early_ab(device, batch: int | None = None, measure: int | None = None,
                  passes: int = PASSES) -> dict:
    """Times and drifts of the three rows; prints the table and returns the
    record."""
    from poserisk_release_tpu_torch.throughput import make_pose_and_score_step

    batch = int(os.environ.get("EXP_B", ab.B)) if batch is None else batch
    measure = int(os.environ.get("EXP_MEASURE", ab.MEASURE)) if measure is None else measure
    k0 = ab.launches()
    m = ab.estimators(device)
    est, (ir, iu) = m["fast"], m["infos"]
    crops = ab.uniform_crops(device, batch).to(torch.bfloat16)
    step = make_pose_and_score_step(est.parents)
    models = dict(zip(ROWS, (est.model, with_s2d_stem(est.model), layer1_ablated(est.model))))
    euler = {}

    def warm(name, out):
        euler[name] = out[2].double().cpu().numpy()

    print(f"device {device}; batch {batch}; product pose+score step, interleaved", flush=True)
    steps = {name: (lambda mod=mod: step(mod, est.smpl_params, crops, ir, iu))
             for name, mod in models.items()}
    times = ab.interleaved(steps, device, passes, measure, warm=warm)
    graphs = ab.graphs_ms(steps, device, passes)
    print(f"\n| config | ms / {batch} crops | fps/chip | vs baseline | med |d euler| deg | "
          "device ms | graph ms |")
    print("|---|---|---|---|---|---|---|")
    base = times["baseline"]["host_ms"]
    rows = []
    for name, t in times.items():
        drift = float(np.median(np.abs(euler[name] - euler["baseline"])))
        rows.append({"config": name, "fps": batch / t["host_ms"] * 1e3,
                     "vs_baseline": base / t["host_ms"], "median_euler_drift_deg": drift,
                     "graph_ms": graphs[name], **t})
        print(f"| {name} | {t['host_ms']:.2f} | {batch / t['host_ms'] * 1e3:.0f} | "
              f"{base / t['host_ms']:.2f}x | {drift:.4f} | {t['ms']:.2f} | "
              f"{graphs[name] or float('nan'):.2f} |", flush=True)
    abl = times[ROWS[2]]
    block = {"host": (base - abl["host_ms"]) / 2,
             "device": (times["baseline"]["ms"] - abl["ms"]) / 2,
             "graph": (None if graphs[ROWS[0]] is None
                       else (graphs[ROWS[0]] - graphs[ROWS[2]]) / 2)}
    bytes_ms, ops_ms = block_bounds_ms(batch)
    print(f"\nin-situ 56x56 marginal cost, ms/block: {block['host']:.3f} host, "
          f"{block['device']:.3f} device, {block['graph'] or float('nan'):.3f} graph "
          f"(bounds: bytes {bytes_ms:.3f}, operations {ops_ms:.3f})", flush=True)
    rec = ab.record("exp_spin_early", device, rows, k0, batch=batch, passes=passes,
                    measure=measure, block_ms=block,
                    block_bound_ms={"bytes": bytes_ms, "operations": ops_ms})
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return spin_early_ab(ab.tool_device(args.cpu))


if __name__ == "__main__":
    main()
