"""Per-stage device times of the full-frame step in one process, on one card.

    python -m poserisk_release_tpu_torch.tools.profile_stages [--batch 128] [--cpu]

The counterpart of the JAX repo's tools/profile_stages.py, with its rows,
labels and order, on B uniform uint8 450x800 frames drawn on the card,
every box [400, 225, 220, 220], and seeded weights at full width (YOLOv3
seed 0, BN-folded; SPIN's seeded init; synthetic SMPL):

  letterbox rect (bf16)             ops/crop.letterbox_device_rect
  crop 224 (bf16 ops/crop)          ops/crop.crop_batch
  fused letterbox+crop (K2)         ops/resample.fused_letterbox_crop
  crop 224 (K1)                     ops/resample.crop_batch_cuda
  YOLOv3 fwd rect (bf16)            the folded tower in bf16 (cuDNN)
  YOLOv3 fwd rect (int8)            the tower quantized on letterbox[:16]
                                    (ops/qconv)
  pose+score step (bf16)            throughput.make_pose_and_score_step
  FULL step (strict strides 1/1)    throughput.make_full_frame_step, bf16,
                                    int8 YOLO, fused K2
  FULL step (bench default det8/pose8)  the same at strides 8/8

Each row has its device time (tools/timing.time_ms, CUDA-event medians)
and the host clock over MEASURE calls enqueued back to back and ended by
one scalar readback of the sum of every output, the faster of two passes:
the gap is what the host costs that stage. Then the serving table: the
full step at batches 1/8/32 in the fast configuration (bf16 + int8 +
fused, strides 1/1) and in the strict f32 default (f32 YOLO and SPIN, no
fused resample, TF32 off), each 16 steps enqueued back to back with every
output (reba, rula, det) summed into one device accumulator, read back
once; the faster of two passes over 16. Eager PyTorch hoists nothing out
of a loop, so the JAX tool's loop-index perturbation has no counterpart.

Prints the two markdown tables and one JSON line for each, with K1's and
K2's launches over the run and max_memory_allocated. It runs on the card
unless --cpu is given (then on the CPU's plain versions, timed by the host
clock: a rehearsal, no device number).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

B = 128
MEASURE = 24
SERVING_STEPS = 16
SERVING_BATCHES = (1, 8, 32)
FRAME_HW = (450, 800)
BOX = (400.0, 225.0, 220.0, 220.0)
TIMING = {"reps": 7, "per_rep": 2, "warmup": 2}
# The JAX tool's rows in its order; its XLA crop is the port's ops/crop and
# its Pallas kernels are K2 and K1.
STAGE_LABELS = (
    "letterbox rect (bf16)",
    "crop 224 (bf16 ops/crop)",
    "fused letterbox+crop (K2)",
    "crop 224 (K1)",
    "YOLOv3 fwd rect (bf16)",
    "YOLOv3 fwd rect (int8)",
    "pose+score step (bf16)",
    "FULL step (strict strides 1/1)",
    "FULL step (bench default det8/pose8)",
)


def host_ms(fn, steps: int = MEASURE) -> float:
    """Host milliseconds a call: `steps` calls enqueued back to back, their
    outputs summed on the device and read back once; the faster of two
    passes (tools/ab.host_pass_ms) after one call."""
    from poserisk_release_tpu_torch.tools.ab import host_pass_ms, sum_outputs

    float(sum_outputs(fn()))
    return min(host_pass_ms(fn, steps), host_pass_ms(fn, steps))


@contextlib.contextmanager
def tf32_off():
    """The strict path's numerics: TF32 off for cuDNN and matmuls, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def build(device, batch: int):
    """Everything the rows need, on `device`: frames, boxes, the fast and
    strict estimators, packed infos, the bf16, int8 and f32 towers."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.models.detector import (
        YoloV3,
        calibrate_yolo_activations,
        fold_bn_params,
        init_yolo_params,
        quantize_yolo_params,
    )
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_spin_variables
    from poserisk_release_tpu_torch.throughput import default_packed_infos

    cfg = default_config()
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    variables = load_spin_variables(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (batch, *FRAME_HW, 3), dtype=torch.uint8, device=device,
                           generator=gen)
    bboxes = torch.tensor(BOX, device=device).repeat(batch, 1)
    folded = fold_bn_params(init_yolo_params())
    cl = torch.channels_last
    yolo_f32 = YoloV3.from_state_dict(folded).to(device, memory_format=cl)
    yolo_bf16 = YoloV3.from_state_dict(folded).to(device, torch.bfloat16, memory_format=cl)
    with torch.inference_mode():
        letter = letterbox_device_rect(frames, 416, out_dtype=torch.bfloat16)
        absmax = calibrate_yolo_activations(yolo_f32, letter[:16].float())
    yolo_int8 = YoloV3.from_state_dict(quantize_yolo_params(folded, absmax)).to(
        device, memory_format=cl)
    fast = PoseEstimator(cfg, smpl, variables=variables, fast=True, device=device)
    with tf32_off():
        strict = PoseEstimator(cfg, smpl, variables=variables, fast=False, device=device)
    infos = tuple(torch.as_tensor(a, device=device) for a in default_packed_infos())
    return {"frames": frames, "bboxes": bboxes, "letter": letter, "fast": fast,
            "strict": strict, "infos": infos, "yolo_f32": yolo_f32, "yolo_bf16": yolo_bf16,
            "yolo_int8": yolo_int8}


def stage_rows(device, m) -> list:
    """[(label, fn)] in the JAX tool's order."""
    from poserisk_release_tpu_torch.models.detector import yolo_forward
    from poserisk_release_tpu_torch.ops.crop import (
        crop_batch,
        crop_batch_plain,
        letterbox_device_rect,
    )
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda, fused_letterbox_crop
    from poserisk_release_tpu_torch.throughput import (
        make_full_frame_step,
        make_pose_and_score_step,
    )

    bf16 = torch.bfloat16
    frames, bboxes, fast = m["frames"], m["bboxes"], m["fast"]
    ir, iu = m["infos"]
    k1 = crop_batch_cuda if device.type == "cuda" else crop_batch_plain
    with torch.inference_mode():
        crops = crop_batch(frames, bboxes, out_dtype=bf16)
    pose_step = make_pose_and_score_step(fast.parents)

    def full(det_stride, pose_stride):
        step = make_full_frame_step(fast.parents, yolo_model=m["yolo_int8"], img_size=416,
                                    compute_dtype=bf16, rect=True, fused_resample=True,
                                    det_stride=det_stride, pose_stride=pose_stride)
        return lambda: step(fast.model, fast.smpl_params, frames, bboxes, ir, iu)

    fns = [
        lambda: letterbox_device_rect(frames, 416, out_dtype=bf16),
        lambda: crop_batch(frames, bboxes, out_dtype=bf16),
        lambda: fused_letterbox_crop(frames, bboxes, out_dtype=bf16),
        lambda: k1(frames, bboxes, 1.2, 224, bf16),
        lambda: yolo_forward(m["yolo_bf16"], m["letter"]),
        lambda: yolo_forward(m["yolo_int8"], m["letter"]),
        lambda: pose_step(fast.model, fast.smpl_params, crops, ir, iu),
        full(1, 1),
        full(8, 8),
    ]
    return list(zip(STAGE_LABELS, fns))


def serving_configs(m) -> list:
    """[(name, step(frames, bboxes), strict)]: the fast configuration and
    the strict f32 default of the JAX tool's serving table."""
    from poserisk_release_tpu_torch.throughput import make_full_frame_step

    fast, strict = m["fast"], m["strict"]
    ir, iu = m["infos"]
    fast_step = make_full_frame_step(fast.parents, yolo_model=m["yolo_int8"],
                                     compute_dtype=torch.bfloat16, rect=True,
                                     fused_resample=True)
    strict_step = make_full_frame_step(strict.parents, yolo_model=m["yolo_f32"],
                                       compute_dtype=torch.float32, rect=True,
                                       fused_resample=False)
    return [
        ("fast (bf16+int8+fused)",
         lambda f, b: fast_step(fast.model, fast.smpl_params, f, b, ir, iu), False),
        ("strict f32 default",
         lambda f, b: strict_step(strict.model, strict.smpl_params, f, b, ir, iu), True),
    ]


def profile(device, batch: int = B, measure: int = MEASURE) -> dict:
    """Both tables; prints them and returns the record."""
    from poserisk_release_tpu_torch.tools.ab import launches
    from poserisk_release_tpu_torch.tools.timing import device_name, peak_bytes, time_ms

    dev_name = device_name(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k1_0, k2_0 = launches()
    m = build(device, batch)
    print(f"profiling on {dev_name}, batch {batch}", flush=True)
    clock = "device" if device.type == "cuda" else "cpu"  # time_ms's clock
    stages = []
    for label, fn in stage_rows(device, m):
        with torch.inference_mode():
            ms = time_ms(fn, device, **TIMING)
            hms = host_ms(fn, measure)
        stages.append({"stage": label, "ms": ms, "host_ms": hms,
                       "fps": batch / ms * 1e3})
        print(f"  {label}: {ms:.3f} ms {clock}, {hms:.3f} ms host / {batch} frames", flush=True)
    stage_peak = peak_bytes(device)
    print(f"\n| stage | ms / {batch} frames ({clock}) | host ms | host - {clock} | fps |")
    print("|---|---|---|---|---|")
    for r in stages:
        print(f"| {r['stage']} | {r['ms']:.3f} | {r['host_ms']:.3f} | "
              f"{r['host_ms'] - r['ms']:.3f} | {r['fps']:.0f} |")
    k1_1, k2_1 = launches()
    stage_record = {"tool": "profile_stages", "table": "stages", "device": dev_name,
                    "batch": batch, "measure": measure, "rows": stages,
                    "k1_launches": k1_1 - k1_0, "k2_launches": k2_1 - k2_0,
                    "max_memory_allocated": stage_peak}
    print(json.dumps(stage_record), flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    configs = serving_configs(m)
    serving = []
    print("\n| serving latency (full step, 16 enqueued) | "
          + " | ".join(name for name, *_ in configs) + " |")
    print("|" + "---|" * (len(configs) + 1))
    for b in SERVING_BATCHES:
        if b > batch:
            print(f"| batch {b} | (skipped: the tool's batch is {batch}) |")
            continue
        fr, bb = m["frames"][:b], m["bboxes"][:b]
        cols = {}
        for name, step, strict in configs:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                if strict:
                    stack.enter_context(tf32_off())
                    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                        raise AssertionError("the strict column runs with TF32 on")
                cols[name] = host_ms(lambda: step(fr, bb), SERVING_STEPS)
        serving.append({"batch": b, "ms": cols})
        print(f"| batch {b} | " + " | ".join(f"{cols[n]:.3f}" for n, *_ in configs) + " |",
              flush=True)
    k1_2, k2_2 = launches()
    serving_record = {"tool": "profile_stages", "table": "serving", "device": dev_name,
                      "steps": SERVING_STEPS, "rows": serving,
                      "k1_launches": k1_2 - k1_1, "k2_launches": k2_2 - k2_1,
                      "max_memory_allocated": peak_bytes(device)}
    print(json.dumps(serving_record), flush=True)
    return {"stages": stage_record, "serving": serving_record,
            "k1_launches": k1_2 - k1_0, "k2_launches": k2_2 - k2_0}


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        from poserisk_release_tpu_torch import _build

        _build.build(["crop", "letterbox_crop"])
    return profile(device, args.batch)


if __name__ == "__main__":
    main()
