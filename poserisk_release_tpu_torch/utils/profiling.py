"""Tracing and profiling utilities.

Port of the JAX package's utils/profiling.py:

  * StageTimer -- accumulating named wall-clock stages (successor of the
    reference's `timer` class, funcs_utils.py:113-128), copied;
  * trace() -- torch.profiler over the CPU and, where there is one, the
    CUDA device, with a Chrome trace (chrome://tracing, Perfetto) written
    to the log directory;
  * device_sync() -- a completion barrier: a device-side sum of the given
    tensors and one scalar read back, which on CUDA waits for the stream;
  * enable_persistent_cache() -- the port's only persistent compile cache
    is the directory of the built CUDA kernels (_build.BUILD_DIR); this
    sets it and returns it.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    def __init__(self):
        self.acc: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.acc.values())
        lines = [f"{'stage':<16}{'sec':>10}{'calls':>8}{'share':>8}"]
        for name, sec in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            share = (sec / total * 100) if total else 0.0
            lines.append(f"{name:<16}{sec:>10.3f}{self.counts[name]:>8}{share:>7.1f}%")
        lines.append(f"{'total':<16}{total:>10.3f}")
        return "\n".join(lines)


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """The directory the port's CUDA kernels are built into and reused from
    (a library is keyed by its source, headers and flags: _build.py).
    cache_dir moves it; without one it stays where it is (`_build/` in the
    package). Returns the directory used."""
    from poserisk_release_tpu_torch import _build

    if cache_dir:
        _build.BUILD_DIR = osp.abspath(cache_dir)
    return _build.BUILD_DIR


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around the body (CPU activity, and CUDA activity when
    a card is present); on exit the Chrome trace is written to
    log_dir/trace.json. A failure of the body or of the profiler raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


def device_sync(*tensors) -> float:
    """Force completion of the device work feeding `tensors`; returns a
    checksum (the sum of all their elements, as float32)."""
    acc = None
    for t in tensors:
        s = torch.as_tensor(t).sum().to(torch.float32)
        acc = s if acc is None else acc + s.to(acc.device)
    return 0.0 if acc is None else float(acc)
