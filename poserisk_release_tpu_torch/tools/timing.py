"""Device time of a call, and the card's peak rates, for the tools and chip_smoke.py."""

from __future__ import annotations

import statistics
import time

import torch

# One NVIDIA H100 SXM at its 700 W limit, dense rates (NVIDIA data sheet).
# Every bound and share of peak in the port divides by these.
BF16_FLOPS_PER_S = 989e12  # tensor cores, bf16
INT8_OPS_PER_S = 1979e12  # tensor cores, int8
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, device, reps: int = 20, per_rep: int = 10, warmup: int = 5) -> float:
    """Milliseconds of one fn() call: on a CUDA device the median over
    `reps` samples of a CUDA-event pair around `per_rep` back-to-back calls,
    each sample enqueued while the card sleeps ~2 ms so it holds device time
    rather than launch overhead; elsewhere the host clock over the same
    loop."""
    for _ in range(warmup):
        fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            start.record()
            for _ in range(per_rep):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_rep)
        else:
            t0 = time.perf_counter()
            for _ in range(per_rep):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / per_rep)
    return statistics.median(times)


def peak_bytes(device):
    """torch.cuda.max_memory_allocated on a CUDA device, else None."""
    device = torch.device(device)
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def device_name(device) -> str:
    """The card's name for a CUDA device, else the device type: what a
    tool's record names its numbers by."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
