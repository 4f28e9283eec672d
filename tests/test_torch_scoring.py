"""The port's REBA/RULA engines against the JAX package's.

Both scorers take the same Euler angles: the random, boundary and epsilon
sweeps of tests/test_scoring.py and tests/test_reference_differential.py
(angles on every rule threshold, and nudged off it by 1e-6 and 1e-3), in
float64 and float32. Each engine scores at its input's precision, so the
two see the same values against the same integer thresholds. Scores are
integers and the logs are strings: every score, every `log_score` entry and
every debug angle log must be exactly equal. There is no tolerance.
"""

import numpy as np
import pytest

from poserisk_release_tpu.scoring.reba import REBAScorer as JaxREBAScorer
from poserisk_release_tpu.scoring.rula import RULAScorer as JaxRULAScorer
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
        assert port_cls()(np.zeros((0, 24, 3)), None, info) == []
        for s in np.arange(0.0, 16.5, 0.5):
            assert port_cls.action_level(s) == jax_cls.action_level(s), (title, s)
