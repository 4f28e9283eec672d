"""Read a cell's compared numbers for sound runs and for the control.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> <n> ...

For each seed, in one process: a run of the cell as the benchmark runs it
(window of --seconds, the cell's own load and sizes), then its comparison
(the program's numbers: the lower readings), then the same comparison with
the reference in TF32 put in the program's place (the control's numbers:
the upper readings). One JSON line per seed. The limits in a
configuration's file are set between the largest program reading over a
dozen seeds or more and the smallest control reading (PERF.md).
"""

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if osp.abspath(sys.path[0]) == osp.dirname(osp.abspath(__file__)):
    sys.path[0] = ROOT


def readings(cell, seed: int, seconds: float, device, overrides=None):
    """(program numbers, control numbers, limits, the run's record)."""
    from benchmark.core import serve, video

    runner = video if cell.mix["runner"] == "video" else serve
    rec = runner.run(cell, seed, seconds, False, device, overrides)
    program, limits = rec.check()
    control, _ = rec.check(control=True)
    return program, control, limits, rec


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()

    import torch

    from benchmark.core import harness

    harness.prepare_environment()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    problem = harness.check_cards(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        program, control, limits, rec = readings(cell, seed, args.seconds, "cuda:0")
        print(json.dumps({"workload": cell.name, "seed": seed, "program": program,
                          "control": control, "limits": limits, "e2e": rec.e2e,
                          "attempted": rec.attempted, "failed": rec.failed}), flush=True)
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
