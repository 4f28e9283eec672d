"""The port's mesh dry run (graft_entry.dryrun_multichip) on gloo ranks on the CPU.

dryrun_multichip(2, cpu=True) spawns 2 ranks (JAX's sections 1-6: dp over
frames, the score histogram, the full-frame step f32 / int8 + bf16 at
det_stride 2 / det_stride 2 with pose_stride 2, K2's plain version alone),
each section held by rank 0 against the single-process step on the whole
batch: scores exactly equal, f32 floats within 1e-5 of max(1,
|reference|), the bf16 step's det_best within 4/255, the resample exactly.
Here the record's flags are read, and the parent recomputes the dp
section's scores and the histogram itself on the same seeded inputs, and
runs JAX's make_pose_and_score_step on them with the port's seeded SPIN
weights: the dp section's scores equal JAX's, the single-process step's
Euler angles and joints within 1e-2 (deg, mm) of JAX's, the class of
tests/test_torch_pose.py. The model axes (tp / sp / pp / ep and the dp x tp training step) need n = 4:
the card runs them from chip_smoke.py, and the `slow` test here.
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch import graft_entry
from poserisk_release_tpu_torch.throughput import make_full_frame_step

SECTIONS = ("dp_pose", "histogram", "full_step", "int8_step", "pose_stride_step",
            "stride_guard", "fused_resample")
AXES = ("tp", "sp", "pp", "ep", "train")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process, as in the ranks it spawns."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def record():
    return graft_entry.dryrun_multichip(2, cpu=True)


@pytest.fixture(scope="module")
def single_dp_scores():
    """The single-process pose + score step on the dry run's 4 crops, with
    the dry run's weights (pipeline.load_spin_variables: the seeded init):
    reba, rula, euler, joint_cam and those weights."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_spin_variables
    from poserisk_release_tpu_torch.throughput import default_packed_infos, make_pose_and_score_step

    cfg = default_config().replace(PARALLEL={"num_devices": 1})
    variables = load_spin_variables(cfg)
    est = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=variables,
                        device="cpu")
    crops = torch.as_tensor(graft_entry.dryrun_inputs(2)["crops"])
    infos = [torch.as_tensor(a) for a in default_packed_infos()]
    with torch.inference_mode():
        out = make_pose_and_score_step(est.parents)(est.model, est.smpl_params, crops, *infos)
    return tuple(t.numpy() for t in out) + (variables,)


@pytest.fixture(scope="module")
def jax_dp(single_dp_scores):
    """JAX's make_pose_and_score_step on the same 4 crops with the port's
    seeded SPIN weights: reba, rula, euler, joint_cam."""
    import jax
    import jax.numpy as jnp

    from poserisk_release_tpu import throughput as jax_throughput
    from poserisk_release_tpu.body.smpl import SMPLFamily
    from poserisk_release_tpu.config import default_config
    from poserisk_release_tpu.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax

    cfg = default_config().replace(PARALLEL={"num_devices": 1})
    est = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir),
                        variables=spin_state_dict_to_flax(single_dp_scores[-1]))
    step = jax.jit(jax_throughput.make_pose_and_score_step(cfg.SPIN.ief_iters, est.parents))
    crops = jnp.asarray(graft_entry.dryrun_inputs(2)["crops"])
    out = step(est.variables, est.smpl_params, crops,
               *map(jnp.asarray, jax_throughput.default_packed_infos()))
    return tuple(np.asarray(t) for t in out)


def test_every_section_holds_on_two_ranks(record):
    s = record["sections"]
    assert record["ok"] and record["n_devices"] == 2
    assert record["backend"] == "gloo" and record["devices"] == ["cpu", "cpu"]
    assert tuple(s) == SECTIONS and not set(AXES) & set(s)
    for name in SECTIONS:
        assert s[name]["ok"], (name, s[name])
        assert len(s[name]["k1"]) == len(s[name]["k2"]) == 2
        assert s[name]["k1"] == s[name]["k2"] == [0, 0]  # the CPU launches no kernel
    for name in ("dp_pose", "full_step", "int8_step", "pose_stride_step", "fused_resample"):
        assert s[name]["scores_equal"], name
    for name in ("dp_pose", "full_step", "pose_stride_step"):
        assert s[name]["ranks_equal"] and len(s[name]["reba"]) == 4


def test_strided_sections_keep_the_batch_and_stride_det_best(record):
    s = record["sections"]
    assert s["full_step"]["det_best_entries"] == 4
    assert s["int8_step"]["det_best_entries"] == s["pose_stride_step"]["det_best_entries"] == 2
    assert s["fused_resample"]["letterbox_shape"] == [4, 64, 64, 3]
    assert s["fused_resample"]["crop_shape"] == [4, 32, 32, 3]
    assert s["fused_resample"]["float_max_abs_diff"] == [0.0, 0.0]
    assert s["stride_guard"]["ok"] and "det_stride 4" in s["stride_guard"]["message"]


def test_dp_scores_equal_the_parents_single_process_step(record, single_dp_scores):
    reba, rula = single_dp_scores[:2]
    assert record["sections"]["dp_pose"]["reba"] == reba.tolist()
    assert record["sections"]["dp_pose"]["rula"] == rula.tolist()


def test_dp_section_equals_jax(record, single_dp_scores, jax_dp):
    """The dp section's scores equal JAX's step on the same crops and
    weights; its floats are within F32_RTOL of the single-process step's
    (the record's check), whose Euler angles and joints lie within 1e-2 of
    JAX's."""
    reba, rula, euler, joints = jax_dp
    dp = record["sections"]["dp_pose"]
    assert dp["reba"] == reba.tolist() and dp["rula"] == rula.tolist()
    assert dp["ok"] and dp["scores_equal"]
    d = np.abs(single_dp_scores[2] - euler)
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), 1e-2)  # deg, +-180 wrap
    np.testing.assert_allclose(single_dp_scores[3], joints, atol=1e-2)  # mm


def test_histogram_equals_bincount(record, single_dp_scores):
    reba = single_dp_scores[0]
    hist = record["sections"]["histogram"]["hist"]
    assert hist == np.bincount(np.clip(reba - 1, 0, 11), minlength=12).tolist()
    assert sum(hist) == 4


class _DataMesh:
    """The DeviceMesh surface parallel/mesh reads: a data axis of 2, this
    rank at 0."""

    mesh_dim_names = ("data",)

    def size(self, dim=None):
        return 2

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("batch,det_stride,pose_stride", [
    (6, 2, 1),  # 3 rows a rank: no multiple of the detection stride
    (8, 1, 8),  # 4 rows a rank: no multiple of the pose stride
    (5, 1, 1),  # 5 rows do not split over 2 ranks
])
def test_rows_per_rank_not_a_multiple_of_the_strides_raise(batch, det_stride, pose_stride):
    step = make_full_frame_step((0,) * 24, det_stride=det_stride, pose_stride=pose_stride,
                                mesh=_DataMesh())
    frames = torch.zeros((batch, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        step(None, None, None, frames, torch.zeros((batch, 4)), None, None)


def test_dryrun_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(1, cpu=True)


@pytest.mark.slow
def test_model_axes_on_four_ranks():
    """JAX's n >= 4 block: tp and sp within 5e-2 of the single device, pp
    and ep within 1e-3 (pp's largest rank under 0.31 of the HMR's bytes,
    ep's male joints equal to a male estimator's), a finite dp 2 x tp 2
    training loss."""
    s = graft_entry.dryrun_multichip(4, cpu=True)["sections"]
    assert tuple(s) == SECTIONS + AXES
    assert all(s[name]["ok"] for name in s), s
    assert s["pp"]["largest_share"] < 0.31 and np.isfinite(s["train"]["loss"])
    assert s["tp"]["mesh"] == {"data": 2, "model": 2} and s["pp"]["mesh"] == {"data": 1,
                                                                               "stage": 4}
