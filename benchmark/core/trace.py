"""The traced stretch: torch.profiler over a steady part of the window.

`Stretch` starts the profiler, marks the stretch with a record_function
span and reduces the trace to what the per-layer metrics and the result's
`device` and `breakdown` read: the stretch's length, the union of device
activity (kernels, copies, fills) and of kernels alone, each kernel name's
launches and seconds, and the longest idle gaps of the device, each named
by the harness span the host was in when the gap began. Nothing is written
to disk.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

MARK = "bench.stretch"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    gaps: List[Tuple[str, float]]

    def kernel_time(self, match) -> Tuple[int, float]:
        """(launches, seconds) summed over the kernel names `match` accepts."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if match(name):
                n += k
                s += t
        return n, s

    def breakdown(self) -> Dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[name, t] for name, (_, t) in top],
                "idle_gaps": [[label, s] for label, s in self.gaps[:10]]}


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    total, merged = 0.0, []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    for a, b in merged:
        total += b - a
    return total, merged


def prime() -> None:
    """Start and stop the profiler once on a small operation: its first
    start sets up the device tracing, which takes seconds, so a traced run
    pays it in set-up rather than inside its window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        x = torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu")
        (x + x).sum().item()


class Stretch:
    """start() ... end() marks the stretch; stop() ends the profiler, which
    may come later (stopping gathers the trace, which takes a while); then
    summary(): None when never started or when the trace holds no device
    activity."""

    def __init__(self):
        self.prof = None
        self.active = False
        self._mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self.active = True

    def end(self) -> None:
        if self.active:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._mark.__exit__(None, None, None)
            self.active = False

    def stop(self) -> None:
        if self.prof is not None and self._mark is not None:
            self.end()
            self.prof.stop()
            self._mark = None

    def summary(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        events = self.prof.events()
        mark = [e for e in events if e.name == MARK
                and getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
        if not mark:
            return None
        t0, t1 = mark[0].time_range.start, mark[0].time_range.end
        device, kernel_iv, kernels, spans = [], [], {}, []
        for e in events:
            dev = getattr(e, "device_type", None)
            if e.name.startswith("bench."):  # the harness's annotations, on both timelines
                if dev != torch.autograd.DeviceType.CUDA and e.name != MARK:
                    spans.append((e.time_range.start, e.time_range.end, e.name[6:]))
                continue
            if dev is not None and dev == torch.autograd.DeviceType.CUDA:
                a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
                if b <= a:
                    continue
                device.append((a, b))
                low = e.name.lower()
                if not ("memcpy" in low or "memset" in low):
                    kernel_iv.append((a, b))
                    n, s = kernels.get(e.name, (0, 0.0))
                    kernels[e.name] = (n + 1, s + (b - a) * 1e-6)
        if not device:
            return None
        busy, merged = _union(device)
        kbusy, _ = _union(kernel_iv)
        gaps = []
        edges = [(t0, t0)] + merged + [(t1, t1)]
        for (_, end), (start, _) in zip(edges[:-1], edges[1:]):
            if start > end:
                label = "no harness span"
                inner = [s for s in spans if s[0] <= end < s[1]]
                if inner:
                    label = min(inner, key=lambda s: s[1] - s[0])[2]
                gaps.append((label, (start - end) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        return TraceSummary((t1 - t0) * 1e-6, busy * 1e-6, kbusy * 1e-6, kernels, gaps)


def span(name: str, on: bool):
    """A harness span in the trace (record_function 'bench.<name>') when on."""
    return torch.profiler.record_function("bench." + name) if on else contextlib.nullcontext()
