"""A/B of the mixed-stage int8 SPIN backbones on the product pose step, on one card.

    python -m poserisk_release_tpu_torch.tools.exp_spin_mixed [--batch 128] [--cpu]

The counterpart of the JAX repo's tools/exp_spin_mixed.py:
throughput.make_pose_and_score_step at B (128) uniform 224x224 crops drawn
on the card, bf16, with the backbone in bf16 (cuDNN) or int8 from
SpinConfig.int8_min_stage on (CONFIGS: the whole tower, the deep stages
3-4, the last stage), each quantized with bias correction on the first 8
crops (models/spin.quantize_spin_backbone). For each: ms per batch
(interleaved in one process over two passes; the host clock over 24
enqueued steps with one readback, the device ms beside it, and one replay
of the step captured as a CUDA graph, tools/ab.graphs_ms) and the median
|Euler delta| against the f32 backbone (TF32 off) on the same crops.
Runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from poserisk_release_tpu_torch.tools import ab

CONFIGS = {"int8-whole": 0, "int8-deep": 3, "int8-last": 4}  # name: min_stage


def spin_mixed_ab(device, batch: int = ab.B, passes: int = ab.PASSES,
                  measure: int = ab.MEASURE) -> dict:
    """Times and drifts of every configuration; prints the table and
    returns the record."""
    from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50
    from poserisk_release_tpu_torch.models.spin import quantize_spin_backbone
    from poserisk_release_tpu_torch.throughput import make_pose_and_score_step
    from poserisk_release_tpu_torch.tools.profile_stages import tf32_off

    k0 = ab.launches()
    with tf32_off():
        m = ab.estimators(device, strict=True)
    fast, strict, (ir, iu) = m["fast"], m["strict"], m["infos"]
    crops = ab.uniform_crops(device, batch)
    crops_bf16 = crops.to(torch.bfloat16)
    steps = {"bf16": make_pose_and_score_step(fast.parents)}
    for name, min_stage in CONFIGS.items():
        quant = quantize_spin_backbone(m["variables"], crops[:8], min_stage=min_stage)
        steps[name] = make_pose_and_score_step(fast.parents,
                                               quant_backbone=prepare_resnet50(quant, device))
    with torch.inference_mode(), tf32_off():
        euler_ref = make_pose_and_score_step(strict.parents)(
            strict.model, strict.smpl_params, crops, ir, iu)[2].cpu().numpy()
    drift = {}

    def warm(name, out):
        drift[name] = float(np.median(np.abs(out[2].float().cpu().numpy() - euler_ref)))

    print(f"device {device}; batch {batch}; pose+score step, interleaved", flush=True)
    calls = {name: (lambda step=step: step(fast.model, fast.smpl_params, crops_bf16, ir, iu))
             for name, step in steps.items()}
    times = ab.interleaved(calls, device, passes, measure, warm=warm)
    graphs = ab.graphs_ms(calls, device, passes)
    print(f"\n| config | ms / {batch} crops | fps/chip | vs bf16 | med |d euler| deg | "
          "device ms | graph ms |")
    print("|---|---|---|---|---|---|---|")
    base = times["bf16"]["host_ms"]
    rows = []
    for name, t in times.items():
        rows.append({"config": name, "min_stage": CONFIGS.get(name), "fps":
                     batch / t["host_ms"] * 1e3, "vs_bf16": base / t["host_ms"],
                     "median_euler_drift_deg": drift[name], "graph_ms": graphs[name], **t})
        print(f"| {name} | {t['host_ms']:.2f} | {batch / t['host_ms'] * 1e3:.0f} | "
              f"{base / t['host_ms']:.2f}x | {drift[name]:.3f} | {t['ms']:.2f} | "
              f"{graphs[name] or float('nan'):.2f} |", flush=True)
    rec = ab.record("exp_spin_mixed", device, rows, k0, batch=batch, passes=passes,
                    measure=measure)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=ab.B)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return spin_mixed_ab(ab.tool_device(args.cpu), args.batch)


if __name__ == "__main__":
    main()
