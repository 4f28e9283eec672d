"""What the port's A/B tools share: the card, the seeded full-width models,
the bench's frames and boxes, and interleaved timing in one process.

The JAX tools time each configuration by the host clock over MEASURE calls
enqueued back to back and ended by one readback, interleaving the
configurations over passes so drift hits all of them alike. The port keeps
that clock (host_pass_ms) and puts the device time beside it
(tools/timing.time_ms, CUDA events) and, where the step can be captured,
the time of one CUDA-graph replay (graphs_ms); each configuration's number
is the fastest pass.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

B = 128
MEASURE = 24
PASSES = 2
FRAME_HW = (450, 800)
BOX = (400.0, 225.0, 220.0, 220.0)
TIMING = {"reps": 5, "per_rep": 2, "warmup": 1}  # tools/timing.time_ms, a pass


def tool_device(cpu: bool) -> torch.device:
    """The card (K1 and K2 built), or the CPU when the caller names it;
    without a card and without cpu it raises (device.resolve_device)."""
    from poserisk_release_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if cpu else None)
    if device.type == "cuda":
        from poserisk_release_tpu_torch import _build

        _build.build(["crop", "letterbox_crop"])
    return device


def uniform_frames(device, n: int, seed: int = 0) -> torch.Tensor:
    """n uniform uint8 450x800 frames drawn on the device (the bench's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, *FRAME_HW, 3), dtype=torch.uint8, device=device,
                         generator=gen)


def tile_boxes(device, n: int) -> torch.Tensor:
    """The JAX tools' box, [400, 225, 220, 220], for every frame."""
    return torch.tensor(BOX, device=device).repeat(n, 1)


def uniform_crops(device, n: int, seed: int = 0) -> torch.Tensor:
    """n uniform f32 224x224 crops in [0, 1) drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, 224, 224, 3), device=device, generator=gen)


def estimators(device, strict: bool = False) -> dict:
    """The seeded full-width SPIN (load_spin_variables), synthetic SMPL and
    the packed infos: {"cfg", "variables", "infos", "fast", "strict"} with
    the bf16 estimator and, on request, the strict f32 one (built with TF32
    off, which it leaves off on the card)."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_spin_variables
    from poserisk_release_tpu_torch.throughput import default_packed_infos

    cfg = default_config()
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    variables = load_spin_variables(cfg)
    out = {"cfg": cfg, "variables": variables, "strict": None,
           "infos": tuple(torch.as_tensor(a, device=device) for a in default_packed_infos())}
    if strict:
        out["strict"] = PoseEstimator(cfg, smpl, variables=variables, device=device)
    out["fast"] = PoseEstimator(cfg, smpl, variables=variables, fast=True, device=device)
    return out


def folded_yolo() -> dict:
    """The seed-0 YOLOv3 state_dict, BN-folded (numpy)."""
    from poserisk_release_tpu_torch.models.detector import fold_bn_params, init_yolo_params

    return fold_bn_params(init_yolo_params(0))


def yolo_module(sd: dict, device, dtype=None):
    """A YoloV3 of a (folded or quantized) state_dict on the device,
    channels-last, its float convs cast to `dtype` when given."""
    from poserisk_release_tpu_torch.models.detector import YoloV3

    model = YoloV3.from_state_dict(sd)
    kw = {"memory_format": torch.channels_last}
    return model.to(device, dtype, **kw) if dtype is not None else model.to(device, **kw)


def yolo_absmax(folded: dict, letter: torch.Tensor) -> dict:
    """Per-conv input absmax of the f32 tower on letterboxed frames."""
    from poserisk_release_tpu_torch.models.detector import calibrate_yolo_activations

    with torch.inference_mode():
        return calibrate_yolo_activations(yolo_module(folded, letter.device), letter.float())


def int8_yolo(folded: dict, frames: torch.Tensor, **quant_kw):
    """The int8 PTQ tower calibrated, as the JAX tools do, on the rect
    letterbox (416) of the first 16 frames."""
    from poserisk_release_tpu_torch.models.detector import quantize_yolo_params
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect

    with torch.inference_mode():
        letter = letterbox_device_rect(frames[:16], 416)
    return yolo_module(quantize_yolo_params(folded, yolo_absmax(folded, letter), **quant_kw),
                       frames.device)


def sum_outputs(out) -> torch.Tensor:
    """Every tensor of `out` summed into one f32 scalar on its device."""
    leaves = [out] if isinstance(out, torch.Tensor) else [t for t in out if t is not None]
    acc = leaves[0].float().sum()
    for t in leaves[1:]:
        acc = acc + t.float().sum()
    return acc


def host_pass_ms(fn: Callable, measure: int = MEASURE) -> float:
    """Host milliseconds a call: `measure` calls enqueued back to back,
    their outputs summed on the device and read back once (one pass of the
    JAX tools' one_pass)."""
    t0 = time.perf_counter()
    outs = [fn() for _ in range(measure)]
    acc = sum_outputs(outs[0])
    for o in outs[1:]:
        acc = acc + sum_outputs(o)
    float(acc)
    return (time.perf_counter() - t0) / measure * 1e3


def interleaved(steps: Dict[str, Callable], device, passes: int = PASSES,
                measure: int = MEASURE, warm: Callable | None = None) -> Dict[str, dict]:
    """Each step once (its first call: autotuning, graph building; `warm`
    sees (name, output)), then `passes` rounds over every step in order,
    each timing the device (timing.time_ms) and the host (host_pass_ms).
    Returns {name: {"ms": fastest device ms, "host_ms": fastest host ms,
    "ms_passes": [...], "host_ms_passes": [...]}}."""
    from poserisk_release_tpu_torch.tools.timing import time_ms

    with torch.inference_mode():
        for name, fn in steps.items():
            out = fn()
            float(sum_outputs(out))
            if warm is not None:
                warm(name, out)
        times = {name: ([], []) for name in steps}
        for _ in range(passes):
            for name, fn in steps.items():
                times[name][0].append(time_ms(fn, device, **TIMING))
                times[name][1].append(host_pass_ms(fn, measure))
    return {name: {"ms": min(d), "host_ms": min(h), "ms_passes": d, "host_ms_passes": h}
            for name, (d, h) in times.items()}


def graphs_ms(steps: Dict[str, Callable], device, passes: int = PASSES) -> Dict[str, float]:
    """On the card, the device ms of one replay of each step captured as a
    CUDA graph, fastest of `passes` interleaved rounds (timing.time_ms): the
    step's kernels without the host's enqueue between them, the closest
    eager PyTorch comes to timing a compiled XLA program. None for every
    step off the card. The steps must be capturable (no host copies)."""
    if torch.device(device).type != "cuda":
        return {name: None for name in steps}
    from poserisk_release_tpu_torch.tools.timing import time_ms

    stream = torch.cuda.Stream(device)
    graphs = {}
    for name, fn in steps.items():
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), torch.inference_mode():
            for _ in range(2):
                fn()
        stream.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graphs[name], stream=stream,
                                                      capture_error_mode="thread_local"):
            fn()
    times = {name: [] for name in steps}
    for _ in range(passes):
        for name, graph in graphs.items():
            times[name].append(time_ms(graph.replay, device, **TIMING))
    for graph in graphs.values():
        graph.reset()
    return {name: min(t) for name, t in times.items()}


def launches() -> tuple:
    """K1's and K2's launches in this process so far."""
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda, fused_letterbox_crop_cuda

    return crop_batch_cuda.launches, fused_letterbox_crop_cuda.launches


def record(tool: str, device, rows, k0: tuple, **extra) -> dict:
    """A tool's JSON record: its rows, the card's name, K1's and K2's
    launches since k0 and max_memory_allocated."""
    from poserisk_release_tpu_torch.tools.timing import device_name, peak_bytes

    k1, k2 = launches()
    return {"tool": tool, "device": device_name(device), "rows": rows,
            "k1_launches": k1 - k0[0], "k2_launches": k2 - k0[1],
            "max_memory_allocated": peak_bytes(device), **extra}
