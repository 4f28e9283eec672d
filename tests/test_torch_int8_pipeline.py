"""The port's Predictor and CLI with --spin_int8 and --fast_detector against
the JAX package's, end to end on the CPU.

The synthetic clip of tests/test_torch_pipeline.py (24 frames of 240x320, a
moving bright block) goes through both Predictors with the same SPIN weights
(the JAX package's, through the weight bridge), 16-frame pose chunks, the
int8 SPIN backbone, and the --fast_detector configuration (rect canvas +
int8 detector). This image has no detector weights, so both packages take
the full-frame stub detector, as the JAX package does: the int8 detector
itself is held by tests/test_torch_detector_int8.py. The int8 backbone is
calibrated explicitly from an .npy calibration source (DETECTOR.calibration:
8 frames drawn evenly, boxes from the detector, crops of them).

Each package calibrates its backbone by its own f32 walk, and those walks
sum in another order: the activation scales agree within 1e-5 relative,
not bit for bit, and an ulp of scale moves the many activations that sit
at .5 ties by one int8 step, which these random weights amplify to about a
degree of Euler angle. So the calibration the port's CLI derives is held to
the JAX scales (qkernel and w_scale exact, in_scale within 1e-5), and the
Euler angles and scores are compared with the port running the JAX
package's quantized backbone (PoseEstimator.load_quant_backbone), where
every int8 conv is exact. Even so the f32 epilogues around them may round
an ulp apart (XLA may contract the multiply-add), and an activation that
lies at a .5 tie of the next conv's quantization then lands one int8 step
apart, which 53 convs of random weights amplify: about half the frames of
this clip see such a flip (measured up to 1.1 deg), the rest agree to
~1e-4 deg. So: a third of the frames at least must agree within 0.05 deg,
every frame within 1.5 deg, and every frame's REBA and RULA score must be
equal or lie across a rule threshold from the JAX one: the JAX package's
own scorer, applied to the port's angles, gives the port's score (the rule
of tests/test_e2e_parity.py).
"""

import json

import jax
import numpy as np
import pytest

from poserisk_release_tpu.config import default_config as jax_default_config
from poserisk_release_tpu.pipeline import Predictor as JaxPredictor
from poserisk_release_tpu.scoring.reba import REBAScorer as JaxREBAScorer
from poserisk_release_tpu.scoring.rula import RULAScorer as JaxRULAScorer
from poserisk_release_tpu_torch import cli
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.io.video import load_calibration_frames, write_video
from poserisk_release_tpu_torch.models.convert import (
    flax_to_state_dict,
    resnet_params_from_jax,
    save_flax_variables,
)
from poserisk_release_tpu_torch.pipeline import Predictor
from tests.test_torch_pipeline import INFO, _record
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _clip_frames():
    frames = []
    for i in range(24):
        img = np.full((240, 320, 3), 30, np.uint8)
        x = 100 + 2 * i
        img[60:201, x:x + 61] = (180, 150, 120)
        frames.append(img)
    return frames


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_int8_clip")
    frames = _clip_frames()
    write_video(frames, fps=12.0, file_path=str(root / "input.mp4"))
    (root / "info.json").write_text(json.dumps(INFO))
    np.save(root / "calib.npy", np.stack(frames[::3]))
    np.save(root / "calib_f32.npy", np.stack(frames[:4]).astype(np.float32) / 255.0)
    return root


def _detector_cfg(clip):
    return {"rect_letterbox": True, "int8": True, "calibration": str(clip / "calib.npy"),
            "calibration_frames": 8}


@pytest.fixture(scope="module")
def runs(clip):
    video, info = str(clip / "input.mp4"), str(clip / "info.json")
    jax_cfg = jax_default_config().replace(PARALLEL={"frames_per_step": 16},
                                           DETECTOR=_detector_cfg(clip))
    jax_pred = _record(JaxPredictor(cfg=jax_cfg, visualize=False, spin_int8=True))
    jax_pred(video, info, str(clip / "jax"))
    variables = jax.tree_util.tree_map(np.asarray, jax_pred.pose_estimator.variables)
    cfg = default_config().replace(PARALLEL={"frames_per_step": 16},
                                   DETECTOR=_detector_cfg(clip))
    port_pred = _record(Predictor(cfg=cfg, visualize=False, spin_int8=True,
                                  spin_variables=flax_to_state_dict(variables), device="cpu"))
    jax_q = resnet_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_pred.pose_estimator._quant_backbone))
    port_pred.pose_estimator.load_quant_backbone(jax_q)
    port_pred(video, info, str(clip / "torch"))
    return jax_pred, port_pred, variables, jax_q


@pytest.mark.parametrize("title, jax_scorer", [("REBA", JaxREBAScorer), ("RULA", JaxRULAScorer)])
def test_spin_int8_predictor_matches_jax(runs, title, jax_scorer):
    jax_pred, port_pred, _, _ = runs
    assert not port_pred.pose_estimator.spin_needs_calibration
    want_rec, got_rec = getattr(jax_pred, title.lower()), getattr(port_pred, title.lower())
    d = np.abs(got_rec.poses - want_rec.poses)
    d = np.minimum(d, 360.0 - d).reshape(len(d), -1).max(axis=1)
    assert (d < 0.05).sum() >= len(d) // 3 and d.max() < 1.5, d
    want = [int(r["score"]) for r in want_rec.results]
    got = [int(r["score"]) for r in got_rec.results]
    assert len(got) == len(want) == 24
    for i in np.flatnonzero(np.asarray(got) != np.asarray(want)):
        excuse = jax_scorer()(got_rec.poses[i:i + 1], None, INFO)[0]["score"]
        assert int(excuse) == got[i], f"{title} frame {i}: port {got[i]}, JAX {want[i]}"


def test_cli_fast_detector_spin_int8_calibration(runs, clip, monkeypatch):
    """The CLI with --fast_detector --spin_int8 --calibration x.npy (the same
    weights, as a .flax.npz cache beside a checkpoint path named in a YAML
    override) calibrates from the .npy source as the JAX Predictor did and
    writes the result files."""
    from poserisk_release_tpu_torch import pipeline

    _, _, variables, jax_q = runs
    made = []

    class Recorded(pipeline.Predictor):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            made.append(self)

    monkeypatch.setattr(pipeline, "Predictor", Recorded)
    ckpt = clip / "weights" / "model_checkpoint.pt"
    ckpt.parent.mkdir()
    save_flax_variables(variables, str(ckpt) + ".flax.npz")
    (clip / "override.yaml").write_text(
        f"SPIN:\n  checkpoint: {ckpt}\nPARALLEL:\n  frames_per_step: 16\n")
    out = clip / "torch_cli"
    assert cli.main(["--cpu", "--input", str(clip / "input.mp4"), "--info",
                     str(clip / "info.json"), "--output", str(out), "--cfg",
                     str(clip / "override.yaml"), "--fast_detector", "--spin_int8",
                     "--calibration", str(clip / "calib.npy"), "--calibration_frames", "8",
                     "--no_visualize"]) == 0
    est = made[0].pose_estimator
    assert made[0].cfg.DETECTOR.rect_letterbox and made[0].cfg.DETECTOR.int8
    q = est.quant_params
    assert sorted(q) == sorted(jax_q)
    for name in jax_q:
        np.testing.assert_array_equal(q[name]["qkernel"], jax_q[name]["qkernel"])
        np.testing.assert_array_equal(q[name]["w_scale"], jax_q[name]["w_scale"])
        rel = abs(float(q[name]["in_scale"]) / float(jax_q[name]["in_scale"]) - 1.0)
        assert rel < 1e-5, (name, rel)
    for name in ("reba_result.txt", "rula_result.txt"):
        assert (out / name).stat().st_size > 0, name


def test_cli_rejects_a_float_calibration_array(clip):
    with pytest.raises(ValueError, match="uint8"):
        cli.main(["--cpu", "--input", str(clip / "input.mp4"), "--output",
                  str(clip / "torch_f32"), "--spin_int8", "--calibration",
                  str(clip / "calib_f32.npy"), "--no_visualize"])


def test_load_calibration_frames_matches_jax(clip, tmp_path):
    from poserisk_release_tpu.io.video import load_calibration_frames as jax_load

    for n in (3, 8, 20):
        np.testing.assert_array_equal(load_calibration_frames(str(clip / "calib.npy"), n),
                                      jax_load(str(clip / "calib.npy"), n))
    video = str(clip / "input.mp4")
    np.testing.assert_array_equal(load_calibration_frames(video, 5), jax_load(video, 5))
    np.save(tmp_path / "bad.npy", np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match="N, H, W, 3"):
        load_calibration_frames(str(tmp_path / "bad.npy"))
    with pytest.raises(ValueError, match="no images"):
        load_calibration_frames(str(tmp_path))
