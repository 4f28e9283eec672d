"""Device times of kernels K2 and K4 at the main path's shapes.

    python -m poserisk_release_tpu_torch.tools.exp_k2_k4 [--label NAME]

K2 (ops/resample.fused_letterbox_crop_cuda) on 64 seeded uint8 450x800
frames with tracked-person boxes (tools/exp_window_crop.tool_boxes), in the
four shapes the main paths give it:

  f32 1/1       fused letterbox + crop, strides 1/1, rect canvas (the strict
                full-frame step)
  bf16 1/1      the same in bf16
  bf16 fs8      bf16 with frame_stride 8 (the fast full-frame step)
  f32 square    letterbox-only, square 416 canvas (the float detector)

and K4 (ops/skin.skin_vertices_cuda) on the synthetic SMPL body at B = 1
(the debug mesh) and B = 64. Every case is first checked against its plain
version (K2 bit-equal, K4 within 1e-5 m), then timed with tools/timing.time_ms
(`ms`: a call among back-to-back calls) and torch.profiler (`kernel_ms`:
the kernel alone, tools/exp_fused_stage.kernel_split). Prints one JSON
line per case. The tool uses only the wrappers' public
signatures, so the same file times an older tree of the package beside this
one in one call (copy it into that tree's tools/ and run it from there).
Runs on the card only: the kernels have no CPU mode.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

CHUNK, FRAME_HW = 64, (450, 800)


def k2_cases(frames: torch.Tensor, bboxes: torch.Tensor) -> dict:
    """{case: (kwargs of fused_letterbox_crop_cuda, bboxes or None)}: the
    four shapes of the module docstring."""
    bf16 = torch.bfloat16
    return {
        "f32 1/1": ({}, bboxes),
        "bf16 1/1": ({"out_dtype": bf16}, bboxes),
        "bf16 fs8": ({"out_dtype": bf16, "frame_stride": 8}, bboxes),
        "f32 square": ({"rect": False}, None),
    }


def kernel_ms(fn) -> float:
    """Device milliseconds of the kernels one fn() call launches, from the
    profiler (0.0 if it sees no device time)."""
    from poserisk_release_tpu_torch.tools.exp_fused_stage import kernel_split

    return sum(ms for ms, _ in kernel_split(fn).values())


def k2_times(frames: torch.Tensor, bboxes: torch.Tensor, **timing) -> dict:
    """{case: {"ms", "kernel_ms", "max_abs_err", "launches"}} of K2 on frames (B, H, W, 3)
    uint8 and bboxes (B, 4) f32 on the card; raises if a case is not
    bit-equal to the plain version."""
    from poserisk_release_tpu_torch.ops.resample import (
        fused_letterbox_crop_cuda,
        fused_letterbox_crop_plain,
    )
    from poserisk_release_tpu_torch.tools.timing import time_ms

    out = {}
    for case, (kw, bb) in k2_cases(frames, bboxes).items():
        n0 = fused_letterbox_crop_cuda.launches
        got = fused_letterbox_crop_cuda(frames, bb, **kw)
        launches = fused_letterbox_crop_cuda.launches - n0
        want = fused_letterbox_crop_plain(frames, bb, **kw)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want) if a is not None)
        if err != 0.0:
            raise AssertionError(f"K2 {case} differs from its plain version by {err}")

        def call(kw=kw, bb=bb):
            return fused_letterbox_crop_cuda(frames, bb, **kw)

        out[case] = {"ms": time_ms(call, frames.device, **timing), "kernel_ms": kernel_ms(call),
                     "max_abs_err": err, "launches": launches}
    return out


def k4_times(device, batches=(1, CHUNK), **timing) -> dict:
    """{B: {"ms", "kernel_ms", "max_abs_err_m", "launches"}} of K4 on the synthetic SMPL
    body with seeded poses and betas (every third frame all-zero betas)."""
    from poserisk_release_tpu_torch.body.smpl import SMPLModel, synthetic_smpl_arrays
    from poserisk_release_tpu_torch.ops.lbs import LBS, skin_inputs
    from poserisk_release_tpu_torch.ops.skin import skin_vertices_cuda, skin_vertices_plain
    from poserisk_release_tpu_torch.tools.timing import time_ms

    lbs = LBS(SMPLModel.from_arrays(synthetic_smpl_arrays(seed=0)), device)
    p = lbs.params
    tables = (p["v_template"], p["shapedirs"], p["posedirs"], p["weights"])
    rng = np.random.RandomState(2)
    out = {}
    for B in batches:
        pose = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, 72)).astype(np.float32), device=device)
        betas = torch.as_tensor(rng.normal(0, 0.5, (B, 10)).astype(np.float32), device=device)
        betas[::3] = 0.0
        with torch.no_grad():
            eff_betas, pose_map, affines, _ = skin_inputs(p, pose, betas, lbs.parents)
            args = (eff_betas.contiguous(), pose_map.contiguous(), affines.contiguous()) + tables
            n0 = skin_vertices_cuda.launches
            got = skin_vertices_cuda(*args)
            launches = skin_vertices_cuda.launches - n0
            err = float((got - skin_vertices_plain(*args)).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"K4 at B={B} differs from its plain version by {err} m")
            out[B] = {"ms": time_ms(lambda: skin_vertices_cuda(*args), device, **timing),
                      "kernel_ms": kernel_ms(lambda: skin_vertices_cuda(*args)),
                      "max_abs_err_m": err, "launches": launches}
    return out


def main(argv=None) -> int:
    from poserisk_release_tpu_torch import _build
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.tools.exp_window_crop import tool_boxes

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name printed on every line (e.g. the tree)")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    _build.build(["letterbox_crop", "skin"])
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (CHUNK,) + FRAME_HW + (3,), generator=gen, device=device,
                           dtype=torch.uint8)
    boxes = torch.as_tensor(tool_boxes(np.random.RandomState(0), CHUNK)[0], device=device)
    name = torch.cuda.get_device_name(0)
    for case, r in k2_times(frames, boxes).items():
        print(json.dumps({"label": args.label, "kernel": "K2", "case": case, **r, "card": name}),
              flush=True)
    for B, r in k4_times(device).items():
        print(json.dumps({"label": args.label, "kernel": "K4", "case": f"B={B}", **r,
                          "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
