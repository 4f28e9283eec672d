"""Device time of a call, for the experiment tools and chip_smoke.py."""

from __future__ import annotations

import statistics
import time

import torch


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
