"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell, its configuration, its traffic mix and its per-layer metrics are
found by name from BENCHMARK.json (benchmark/README.md). The last line on
standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), device, with --trace 1 breakdown, and last `checks`, every
number the comparison held beside its limit. Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2.
"""

import argparse
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if sys.path and osp.abspath(sys.path[0]) == osp.dirname(osp.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None, device=None, overrides=None) -> int:
    """device and overrides are for rehearsals on the CPU (tests); the
    command line always runs on the card."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.core import harness

    harness.prepare_environment()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    if device is None:
        problem = harness.check_cards(cell.chips)
        if problem:
            print(problem, file=sys.stderr)
            return 2
        device = "cuda:0"
        print(f"[bench] card: {harness.power_limit()}", file=sys.stderr)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell.mix["runner"] == "video":
        from benchmark.core import video as runner
    else:
        from benchmark.core import serve as runner
    rec = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, overrides)
    print(f"[bench] {cell.name} seed {args.seed}: setup_s {rec.setup_s:.3f}, {rec.e2e}, "
          f"attempted {rec.attempted}, failed {rec.failed}, peak {rec.memory_peak_bytes}",
          file=sys.stderr)
    return harness.finish(cell, rec, bool(args.trace), device)


if __name__ == "__main__":
    sys.exit(main())
