"""Finds a cell's files by name, prepares the process, and prints the result.

BENCHMARK.json names the cell; the cell names its configuration (a file
under benchmark/configs/), its traffic mix (benchmark/traffic/<mix>.json,
whose "runner" picks the video or serve runner) and, through the metric
entries, the readers under benchmark/metrics/<metric>.py. Nothing here
knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import os.path as osp
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
ROOT = osp.dirname(BENCH_DIR)
WORK_DIR = osp.join(ROOT, ".bench_work")
FORBIDDEN = ("jax", "jaxlib", "flax", "poserisk_release_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def note(what: str) -> None:
    """Set-up's progress on stderr: the process's age when `what` is done."""
    print(f"[bench] set-up: {what} done at {process_age_s():.2f} s", file=sys.stderr)


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX or Flax pulled in
    by a library."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", osp.join(WORK_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", osp.join(WORK_DIR, "triton"))
    os.makedirs(WORK_DIR, exist_ok=True)


def load_benchmark() -> Dict:
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def resolve(bench: Dict, workload: str) -> Cell:
    from benchmark.core.traffic import load_mix

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(osp.join(ROOT, conf["file"])) as f:
        config = json.load(f)

    def here(m):
        return workload in m.get("workloads", [w["name"]])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(workload, int(w["chips"]), config, load_mix(w["traffic"]), e2e, per_layer)


def reader(metric: str):
    """The per-layer metric's reader module, benchmark/metrics/<metric>.py."""
    path = osp.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class RunRecord:
    """What a runner hands back: the end-to-end readings, what the readers
    read, and what the comparison judges."""
    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    spans: Dict[str, List] = field(default_factory=dict)
    trace: Optional[object] = None
    stretch: Dict = field(default_factory=dict)
    serve: Dict = field(default_factory=dict)
    check: Optional[object] = None  # (control=False) -> (numbers, limits)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def check_cards(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: the benchmark runs on a CUDA card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, {torch.cuda.device_count()} are visible"
    return None


def finish(cell: Cell, rec: RunRecord, trace: bool, device) -> int:
    """Reads the metrics, runs the comparison and prints the result: every
    compared number beside its limit last on stderr, the JSON object last
    on stdout. Returns the exit code."""
    import torch

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    metrics: Dict[str, Dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"]).read(rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            value = rec.setup_s if m["name"] == "setup_s" else rec.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    result = {"correct": False, "attempted": int(rec.attempted), "failed": int(rec.failed),
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    t0 = time.perf_counter()
    numbers, limits = rec.check()
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in numbers}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    result["correct"] = bool(ok and rec.failed == 0 and rec.attempted > 0)
    result["checks"] = checks
    print(f"[bench] comparison took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"check failed_requests: {rec.failed} (limit 0)", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
