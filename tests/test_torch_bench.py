"""The port's bench (poserisk_release_tpu_torch/bench.py) against the root
bench.py, on the CPU: the same knobs with the same defaults and validation,
the same record formulas, and no CPU fallback. The root bench.py imports
jax only inside its main(), so both modules import here; each test sets
the environment and reloads them, since the knobs are read at import.

The measurement itself runs only on a card:

    python3 -m poserisk_release_tpu_torch.bench
"""

import importlib

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

KNOBS = ("BENCH_DTYPE", "BENCH_BATCH", "BENCH_INT8", "BENCH_INT8_MIN_DS", "BENCH_Q8",
         "BENCH_SPIN_INT8", "BENCH_FUSED", "BENCH_DET_STRIDE", "BENCH_POSE_STRIDE",
         "BENCH_STRICT", "BENCH_PASSES")
CONSTANTS = ("BENCH_DTYPE", "BATCH", "BENCH_INT8", "BENCH_INT8_MIN_DS", "BENCH_Q8",
             "BENCH_SPIN_INT8", "BENCH_FUSED", "BENCH_DET_STRIDE", "BENCH_POSE_STRIDE",
             "BENCH_STRICT", "BENCH_PASSES", "WARMUP_STEPS", "MEASURE_STEPS", "FRAME_HW",
             "REFERENCE_FPS_ESTIMATE")


def _load(monkeypatch, **env):
    """(the root bench module, the port's), reloaded under exactly `env`."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    return tuple(importlib.reload(importlib.import_module(name))
                 for name in ("bench", "poserisk_release_tpu_torch.bench"))


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_DTYPE": "float32", "BENCH_INT8": "0", "BENCH_DET_STRIDE": "1",
     "BENCH_POSE_STRIDE": "1", "BENCH_PASSES": "1", "BENCH_STRICT": "0"},
    {"BENCH_BATCH": "128", "BENCH_Q8": "1", "BENCH_INT8_MIN_DS": "8", "BENCH_SPIN_INT8": "1",
     "BENCH_FUSED": "0", "BENCH_PASSES": "5"},
], ids=["defaults", "strict_f32", "others"])
def test_knobs_read_like_bench_py(monkeypatch, env):
    root, port = _load(monkeypatch, **env)
    for name in CONSTANTS:
        assert getattr(port, name) == getattr(root, name), name
    if not env:
        assert (port.BENCH_DTYPE, port.BATCH, port.BENCH_PASSES, port.FRAME_HW) == (
            "bfloat16", 1024, 3, (450, 800))
        assert (port.WARMUP_STEPS, port.MEASURE_STEPS) == (2, 24)


def test_bad_dtype_exits_in_both(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("BENCH_DTYPE", "bf16")
    for name in ("bench", "poserisk_release_tpu_torch.bench"):
        module = importlib.import_module(name)
        with pytest.raises(SystemExit, match="BENCH_DTYPE must be"):
            importlib.reload(module)
    monkeypatch.delenv("BENCH_DTYPE")
    _load(monkeypatch)


def test_main_raises_without_cuda(monkeypatch):
    _, port = _load(monkeypatch, BENCH_BATCH="2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main()


def test_band_fields_follow_bench_py(monkeypatch):
    """bench.py's band_fields lives inside its main(); its formula: every
    pass rounded to 0.1, the median to 0.01, (max - min) / median to 1e-4."""
    _, port = _load(monkeypatch)
    assert port.band_fields([5012.345, 5120.0, 5333.789]) == {
        "fps_passes": [5012.3, 5120.0, 5333.8], "fps_median": 5120.0,
        "variance_band": 0.0628}
    assert port.band_fields([431.26, 444.449], prefix="strict_") == {
        "strict_fps_passes": [431.3, 444.4], "strict_fps_median": 437.85,
        "strict_variance_band": 0.0301}


@pytest.mark.parametrize("env, unit", [
    ({}, "frames/sec/chip (detector+crop+SPIN+angles+joints+REBA+RULA, bfloat16, int8 "
         "detector, rect canvas, fused resample, det stride 8, pose stride 8)"),
    ({"BENCH_INT8": "0", "BENCH_DTYPE": "float32", "BENCH_DET_STRIDE": "1",
      "BENCH_POSE_STRIDE": "1"},
     "frames/sec/chip (detector+crop+SPIN+angles+joints+REBA+RULA, float32, rect canvas, "
     "fused resample)"),
], ids=["defaults", "strict_f32"])
def test_unit_is_bench_py_string(monkeypatch, env, unit):
    """The exact string bench.py's f-string gives for these knobs."""
    _, port = _load(monkeypatch, **env)
    assert port.UNIT == unit
    assert port.STRICT_UNIT.endswith(f"; batch {port.BATCH}")
