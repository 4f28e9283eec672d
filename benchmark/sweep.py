"""Find the highest camera rate a serve cell's server sustains.

    python3 benchmark/sweep.py --workload <serve cell> --seed <n> --seconds <s> --cameras 16 24 32 ...

Builds the cell's server once, then for each camera count runs the cell's
open loop for --seconds and prints one JSON line: offered and completed
requests per second, latency p50/p95 (from the due time), how late the
generator ran, and the ratio of the last third's median latency to the
first third's (over ~1.5 the queue grows through the window: the rate is
above what the server sustains). The serve cells fix their camera count at
about 0.8 of the highest sustained rate found this way.
"""

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if osp.abspath(sys.path[0]) == osp.dirname(osp.abspath(__file__)):
    sys.path[0] = ROOT


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--cameras", type=int, nargs="+", required=True)
    args = p.parse_args()

    import numpy as np

    from benchmark.core import harness, serve, traffic

    harness.prepare_environment()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    problem = harness.check_cards(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    server, _ = serve.build(cell, cell.mix, args.seed, "cuda:0")
    try:
        for n in args.cameras:
            mix = dict(cell.mix, cameras=n)
            sched = traffic.camera_schedule(mix, args.seed + n, args.seconds)
            serve.warm(server, sched, int(mix["buckets"][-1]))
            lat, _, late, _, s0, s1 = serve.window(server, sched, args.seconds, False, 0.0)
            ok = np.isfinite(lat)
            third = len(lat) // 3
            head, tail = lat[:third], lat[-third:]
            print(json.dumps({
                "cameras": n, "offered_per_s": len(lat) / args.seconds,
                "completed": int(ok.sum()), "attempted": len(lat),
                "p50_ms": float(np.percentile(lat[ok], 50) * 1e3),
                "p95_ms": float(np.percentile(lat[ok], 95) * 1e3),
                "late_p99_ms": float(np.percentile(late, 99) * 1e3),
                "growth": float(np.nanmedian(tail) / np.nanmedian(head)),
                "requests_per_batch": (s1["requests"] - s0["requests"])
                / max(1, s1["batches"] - s0["batches"])}), flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
