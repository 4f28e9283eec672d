"""The port's Predictor against the JAX package's, end to end on the CPU.

One synthetic clip (24 frames of 240x320, a moving bright 'person' block,
as in tests/test_pipeline.py) goes through both Predictors with the
full-frame StubDetector, 16-frame pose chunks, debug CSVs for two joints,
and the same SPIN weights (the JAX package's, through the weight bridge).

What must agree:
  * the per-frame REBA and RULA scores. A frame may differ only where the
    JAX package's own scorer, applied to the port's Euler angles, gives the
    port's score: a rule threshold that lies between the two packages'
    angles, which differ by float rounding (tests/test_e2e_parity.py uses
    the same rule);
  * the bytes of reba_result.txt, rula_result.txt and every debug CSV;
  * the scores block of run_summary.json.

The port's CLI runs the same clip with the same weights, handed over as a
`.flax.npz` cache beside a checkpoint path named in a YAML override, and
must write the same bytes.
"""

import filecmp
import json
import os.path as osp

import jax
import numpy as np
import pytest

from poserisk_release_tpu.models.detector import StubDetector as JaxStubDetector
from poserisk_release_tpu.pipeline import Predictor as JaxPredictor
from poserisk_release_tpu.scoring.reba import REBAScorer as JaxREBAScorer
from poserisk_release_tpu.scoring.rula import RULAScorer as JaxRULAScorer
from poserisk_release_tpu_torch import cli
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.io.video import write_video
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict, save_flax_variables
from poserisk_release_tpu_torch.models.detector import StubDetector
from poserisk_release_tpu_torch.pipeline import Predictor

OUTPUT_FILES = (
    "reba_result.txt", "rula_result.txt", "debug/pose_log.csv",
    "debug/REBA_score_log.csv", "debug/REBA_eval_pose_log.csv",
    "debug/RULA_score_log.csv", "debug/RULA_eval_pose_log.csv",
)
INFO = {
    "REBA": {
        "Legs_bilateral_weight_bearing/walking": 1, "Sitting": 1,
        "Load/Force Score": 0, "Arm_supported_leaning_L": 0,
        "Arm_supported_leaning_R": 0, "Coupling": 0, "Activity_Score": 0,
    },
    "RULA": {
        "Arm_supported_leaning_L": 0, "Arm_supported_leaning_R": 0,
        "A_Muscle_use_L": 0, "A_Muscle_use_R": 0, "A_Load/Force_L": 0,
        "A_Load/Force_R": 0, "Legs_bilateral_weight_bearing": 0,
        "B_Muscle_use": 0, "B_Load/Force": 0,
    },
}


class _Recording:
    """Wraps a Predictor's scorer and keeps the angles and per-frame results
    of its last call; everything else is the scorer's own."""

    def __init__(self, scorer):
        self._scorer = scorer
        self.poses = self.results = None

    def __call__(self, poses, joint_cams, add_info):
        self.poses = np.array(poses)
        self.results = self._scorer(poses, joint_cams, add_info)
        return self.results

    def __getattr__(self, name):
        return getattr(self._scorer, name)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_clip")
    frames = []
    for i in range(24):
        img = np.full((240, 320, 3), 30, np.uint8)
        x = 100 + 2 * i
        img[60:201, x:x + 61] = (180, 150, 120)
        frames.append(img)
    write_video(frames, fps=12.0, file_path=str(root / "input.mp4"))
    (root / "info.json").write_text(json.dumps(INFO))
    return root


def _record(predictor):
    predictor.reba, predictor.rula = _Recording(predictor.reba), _Recording(predictor.rula)
    return predictor


@pytest.fixture(scope="module")
def runs(clip, small_chunk_config):
    video, info = str(clip / "input.mp4"), str(clip / "info.json")
    common = dict(debug=True, debug_joints="Neck,L_Hip", validate_rotations=True)
    jax_pred = _record(JaxPredictor(cfg=small_chunk_config, detector=JaxStubDetector(),
                                    visualize=False, **common))
    jax_pred(video, info, str(clip / "jax"))
    variables = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_pred.pose_estimator.variables))
    port_pred = _record(Predictor(
        cfg=default_config().replace(PARALLEL={"frames_per_step": 16}),
        detector=StubDetector(), visualize=True, spin_variables=variables,
        device="cpu", **common))
    port_summary = port_pred(video, info, str(clip / "torch"))
    return jax_pred, port_pred, port_summary


@pytest.mark.parametrize("title, jax_scorer", [("REBA", JaxREBAScorer), ("RULA", JaxRULAScorer)])
def test_scores_match_jax(runs, title, jax_scorer):
    jax_pred, port_pred, _ = runs
    want_rec, got_rec = getattr(jax_pred, title.lower()), getattr(port_pred, title.lower())
    want = [int(r["score"]) for r in want_rec.results]
    got = [int(r["score"]) for r in got_rec.results]
    assert len(got) == len(want) == 24
    # Float rounding only: the two packages' angles agree to well under a degree.
    d = np.abs(got_rec.poses - want_rec.poses)
    assert np.minimum(d, 360.0 - d).max() < 0.05
    for i in np.flatnonzero(np.asarray(got) != np.asarray(want)):
        excuse = jax_scorer()(got_rec.poses[i:i + 1], None, INFO)[0]["score"]
        assert int(excuse) == got[i], f"{title} frame {i}: port {got[i]}, JAX {want[i]}"


def test_outputs_byte_equal_to_jax(runs, clip):
    for name in OUTPUT_FILES:
        assert filecmp.cmp(clip / "jax" / name, clip / "torch" / name, shallow=False), name
    summaries = [json.loads((clip / side / "run_summary.json").read_text())
                 for side in ("jax", "torch")]
    assert summaries[0]["scores"] == summaries[1]["scores"]
    assert summaries[1]["frames_tracked"] == 24 and summaries[1]["device"] == "cpu"
    for name in ("REBA_video.mp4", "RULA_video.mp4", "REBA_score.png", "RULA_score.png"):
        assert osp.getsize(clip / "torch" / name) > 0, name


def test_multi_person_writes_each_track_like_the_single_target_run(runs, clip):
    _, port_pred, single = runs
    out = clip / "torch_multi"
    port_pred.multi_person = True
    port_pred.person_genders = {1: "female"}
    port_pred.visualize = False
    try:
        summaries = port_pred(str(clip / "input.mp4"), str(clip / "info.json"), str(out))
        assert port_pred.pose_estimator.gender == "neutral"  # restored after the run
        port_pred.person_genders = {}
        neutral = port_pred(str(clip / "input.mp4"), str(clip / "info.json"),
                            str(clip / "torch_multi_neutral"))
    finally:
        port_pred.multi_person, port_pred.person_genders = False, {}
    assert list(summaries) == list(neutral) == [1]
    # A neutral body gives the single-target run's files. The body model
    # changes joint positions only, and the scorers read Euler angles, so
    # the female run's scores are the single-target run's too.
    for name in OUTPUT_FILES:
        assert filecmp.cmp(clip / "torch" / name,
                           clip / "torch_multi_neutral" / "person_1" / name, shallow=False), name
    assert summaries[1] == single


def test_cli_writes_the_same_files(runs, clip):
    jax_pred = runs[0]
    ckpt = clip / "weights" / "model_checkpoint.pt"  # absent: the cache is used
    ckpt.parent.mkdir()
    save_flax_variables(jax.tree_util.tree_map(np.asarray, jax_pred.pose_estimator.variables),
                        str(ckpt) + ".flax.npz")
    (clip / "override.yaml").write_text(
        f"SPIN:\n  checkpoint: {ckpt}\nPARALLEL:\n  frames_per_step: 16\n")
    out = clip / "torch_cli"
    assert cli.main(["--cpu", "--input", str(clip / "input.mp4"), "--info", str(clip / "info.json"),
                     "--output", str(out), "--cfg", str(clip / "override.yaml"), "--debug",
                     "--debug_joints", "Neck,L_Hip", "--no_visualize"]) == 0
    for name in OUTPUT_FILES:
        assert filecmp.cmp(clip / "jax" / name, out / name, shallow=False), name


def _read_obj(path):
    verts, faces = [], []
    for line in open(path):
        tag, *vals = line.split()
        (verts if tag == "v" else faces).append(vals)
    return np.asarray(verts, np.float64), faces


def test_debug_frame_writes_the_jax_mesh(runs, clip):
    """--debug_frame: both Predictors stop after the pose step and write the
    debug frame's SMPL mesh (vertices in mm) and 3D skeleton figure. The
    meshes agree within 1e-3 mm: the two packages' axis-angles differ by
    float rounding only (tests/test_torch_pose.py), and the body is ~1 m."""
    jax_pred, port_pred, _ = runs
    video, info = str(clip / "input.mp4"), str(clip / "info.json")
    outs = {}
    for name, pred in (("jax", jax_pred), ("torch", port_pred)):
        pred.debug_frame = 5
        try:
            assert pred(video, info, str(clip / f"{name}_debug_frame")) is None
        finally:
            pred.debug_frame = -1
        outs[name] = clip / f"{name}_debug_frame" / "debug"
    want_v, want_f = _read_obj(outs["jax"] / "smpl_model.obj")
    got_v, got_f = _read_obj(outs["torch"] / "smpl_model.obj")
    assert got_v.shape == want_v.shape == (6890, 3) and got_f == want_f
    assert float(np.abs(got_v - want_v).max()) <= 1e-3
    assert osp.getsize(outs["torch"] / "joint_3d.png") > 0


def test_debug_frame_outside_the_track_raises_like_jax(runs, tmp_path):
    jax_pred, port_pred, _ = runs
    frames = np.arange(3, 20)
    aa = np.zeros((len(frames), 24, 3), np.float32)
    messages = []
    for pred in (jax_pred, port_pred):
        pred.debug_frame = 40
        try:
            with pytest.raises(ValueError, match="not among the selected track") as exc:
                pred._visualize_joint_cam_mesh(aa, aa, frames, str(tmp_path))
        finally:
            pred.debug_frame = -1
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
