"""The comparison separates sound runs from broken ones.

On the CPU, at tiny sizes with the kernels' plain versions: a sound run
of each runner stays within its configuration's limits, the control (the
reference in TF32, emulated by rounding the operands of every convolution
and linear layer) breaks at least one, and a run with a fault planted under
its timed path prints `correct: false`. Marked `cuda`: the control on the
card at each cell's own sizes and load, on three seeds.
"""

import contextlib
import io
import json

import pytest

from benchmark import control, run
from benchmark.core import faults, harness
from benchmark.tests import small

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
RUNNER_CELLS = ["yolo-spin.f32.video", "spin.f32.serve-cameras"]
SEED = 3_000_000_017


def _over(numbers, limits):
    return [k for k in numbers if numbers[k] > limits[k]]


@pytest.mark.parametrize("workload", RUNNER_CELLS)
def test_sound_run_passes_and_the_control_fails(workload):
    cell = harness.resolve(BENCH, workload)
    program, ctrl, limits, _ = control.readings(cell, SEED, 1.5, "cpu", small.overrides(cell))
    assert not _over(program, limits), program
    assert _over(ctrl, limits), ctrl


def _result(workload, extra):
    cell = harness.resolve(BENCH, workload)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "1.5",
                       "--trace", "0"], device="cpu", overrides=small.overrides(cell, **extra))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("workload", RUNNER_CELLS)
def test_a_planted_fault_turns_correct_false(workload, fault):
    res = _result(workload, {"fault": fault})
    assert res["correct"] is False
    assert list(res)[-1] == "checks"
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own sizes runs on the card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(workload, card):
    cell = harness.resolve(BENCH, workload)
    for seed in (SEED, SEED + 1, SEED + 2):
        program, ctrl, limits, _ = control.readings(cell, seed, 3.0, card)
        assert not _over(program, limits), (seed, program)
        assert _over(ctrl, limits), (seed, ctrl)
