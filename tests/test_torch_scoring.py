"""The port's REBA/RULA engines against the JAX package's.

Both scorers take the same Euler angles: the random, boundary and epsilon
sweeps of tests/test_scoring.py and tests/test_reference_differential.py
(angles on every rule threshold, and nudged off it by 1e-6 and 1e-3), in
float64 and float32. Each engine scores at its input's precision, so the
two see the same values against the same integer thresholds. Scores are
integers and the logs are strings: every score, every `log_score` entry and
every debug angle log must be exactly equal. There is no tolerance.

The engines are also capturable by a CUDA graph (the serving buckets): they
make no tensor from host data once their rule tables are on the device. The
last tests hold that change to the engine it replaced, bit for bit.
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu.scoring.reba import REBAScorer as JaxREBAScorer
from poserisk_release_tpu.scoring.rula import RULAScorer as JaxRULAScorer
from poserisk_release_tpu_torch.scoring import common, reba, rula, tables
from poserisk_release_tpu_torch.scoring.reba import REBAScorer
from poserisk_release_tpu_torch.scoring.rula import RULAScorer
from tests.test_scoring import (
    BOUNDARY_VALUES,
    DEFAULT_REBA,
    DEFAULT_RULA,
    EXAMPLE_REBA,
    NONZERO_REBA,
    NONZERO_RULA,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENGINES = {"REBA": (JaxREBAScorer, REBAScorer), "RULA": (JaxRULAScorer, RULAScorer)}


def _sweep(seed, n, dtype):
    rng = np.random.RandomState(seed)
    uniform = rng.uniform(-180, 180, size=(n // 3, 24, 3))
    boundary = rng.choice(BOUNDARY_VALUES, size=(n // 3, 24, 3))
    eps = rng.choice([-1e-3, -1e-6, 1e-6, 1e-3], size=(n - 2 * (n // 3), 24, 3))
    epsilon = rng.choice(BOUNDARY_VALUES, size=eps.shape) + eps
    return np.concatenate([uniform, boundary, epsilon]).astype(dtype)


def _plain(frame):
    return [x if isinstance(x, str) else int(x) for x in frame["log_score"]]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("title, info", [
    ("REBA", DEFAULT_REBA), ("REBA", EXAMPLE_REBA), ("REBA", NONZERO_REBA),
    ("RULA", DEFAULT_RULA), ("RULA", NONZERO_RULA),
])
def test_scorer_matches_jax(title, info, dtype):
    poses = _sweep(11, 1200, dtype)
    joint_cams = np.random.RandomState(12).normal(scale=200.0, size=poses.shape)
    add_info = {title: info}
    jax_cls, port_cls = ENGINES[title]
    want_scorer, got_scorer = jax_cls(debug=True), port_cls(debug=True, device="cpu")
    want = want_scorer(poses, joint_cams, add_info)
    got = got_scorer(poses, joint_cams, add_info)
    assert len(got) == len(want) == len(poses)
    for i, (g, w) in enumerate(zip(got, want)):
        assert int(g["score"]) == int(w["score"]), f"frame {i}: {poses[i].tolist()}"
        assert _plain(g) == _plain(w), f"frame {i} log_score"
    assert got_scorer.log == want_scorer.log
    assert got_scorer.eval_items == want_scorer.eval_items


def test_empty_clip_and_action_levels():
    for title, (jax_cls, port_cls) in ENGINES.items():
        info = {"REBA": DEFAULT_REBA, "RULA": DEFAULT_RULA}
        assert port_cls(device="cpu")(np.zeros((0, 24, 3)), None, info) == []
        for s in np.arange(0.0, 16.5, 0.5):
            assert port_cls.action_level(s) == jax_cls.action_level(s), (title, s)


def _host_tensor_chain(branches, default):
    """The select chain as the engines had it before they became capturable
    by a CUDA graph: the default and every int value made into a tensor on
    the host, then copied to the conditions' device."""
    cond0 = branches[0][0]
    out = torch.as_tensor(default, dtype=torch.int32, device=cond0.device).expand(cond0.shape)
    for cond, value in reversed(branches):
        value = torch.as_tensor(value, dtype=torch.int32, device=cond0.device)
        out = torch.where(cond, value, out)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("title", ["REBA", "RULA"])
def test_capturable_engine_equals_the_host_tensor_engine(title, dtype, monkeypatch):
    """Fills and scalar selects in place of host-made tensors, and rule
    tables cached on their device, change no output bit on a seeded sweep."""
    module = {"REBA": reba, "RULA": rula}[title]
    engine = getattr(module, f"{title.lower()}_frame_scores")
    poses = torch.as_tensor(_sweep(21, 600, dtype))
    info = torch.as_tensor(module.pack_info(
        {"REBA": NONZERO_REBA, "RULA": NONZERO_RULA}[title]))
    got = engine(poses, info)
    monkeypatch.setattr(module, "chain", _host_tensor_chain)
    monkeypatch.setattr(module, "device_table", lambda t, d: torch.as_tensor(t, device=d))
    want = engine(poses, info)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.int32, key
        assert torch.equal(got[key], want[key]), key


def test_rule_tables_are_built_once_per_device(monkeypatch):
    """After a first call the engines copy no table (or anything else) from
    the host: a second call with torch.as_tensor refused succeeds, and the
    per-device cache does not grow."""
    poses = torch.as_tensor(_sweep(22, 30, np.float32))
    add_info = {"REBA": DEFAULT_REBA, "RULA": DEFAULT_RULA}
    runs = [(reba.reba_frame_scores, torch.as_tensor(reba.pack_info(add_info))),
            (rula.rula_frame_scores, torch.as_tensor(rula.pack_info(add_info)))]
    first = [engine(poses, info) for engine, info in runs]
    cached = dict(common._DEVICE_TABLES)
    assert {d for _, d in cached} == {torch.device("cpu")} and len(cached) >= 6

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made on the host inside the engine")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    for (engine, info), want in zip(runs, first):
        got = engine(poses, info)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert common._DEVICE_TABLES == cached
    assert common.device_table(tables.REBA_TABLE_A, "cpu") is cached[
        (id(tables.REBA_TABLE_A), torch.device("cpu"))]
