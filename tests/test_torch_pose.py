"""PoseEstimator.run_from_frames of the port against the JAX package's.

The same uint8 frames, tracked boxes and SPIN weights (the JAX package's
random init, through the weight bridge) go through both estimators at
pose_stride 1 and 8, with 20 tracked frames in 16-frame chunks, so the
edge-repeat padding of the last chunk and, at stride 8, the slerp between
anchors and the hold after the last anchor of a chunk are all exercised.

Tolerances: the crops agree within 1e-5 on this smooth content
(test_torch_crop.py) and the HMR outputs within 5e-5 (test_torch_spin.py).
Through the rotation conversions that is at most a few thousandths of a
degree of Euler angle and of a radian of axis-angle (arccos is steep near
theta = pi), and a few thousandths of a millimetre of joint position
(segments of ~0.12 m, times 1000); the asserts allow 1e-2 deg, 1e-3 rad and
1e-2 mm. Anchor frames at stride 8 must equal, bit for bit, a reference
built from the stride-1 pose step: SPIN on the same anchor batch (as in
tests/test_pose_stride.py, since a CPU convolution may pick another
algorithm for another batch size), each anchor's outputs repeated over its
8 frames, and the angle and joint ops on those 16 rows, whose anchor rows
are then taken. So what the check holds is the slerp at t == 0 (it returns
the anchor itself) and which frames are anchors, at the stride-8 step's
own shapes. It is not a plain stride-1 run on the anchor crops: that puts
the anchors at other rows of a 2-row batch, and a CPU elementwise kernel
(atan2) rounds its vector body and its scalar tail differently, so an
anchor's angles there can differ in a last bit.
"""

import jax
import numpy as np
import pytest
import torch

from poserisk_release_tpu.body.smpl import SMPLFamily as JaxSMPLFamily
from poserisk_release_tpu.pipeline import PoseEstimator as JaxPoseEstimator
from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.ops.crop import crop_batch
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict
from poserisk_release_tpu_torch.pipeline import PoseEstimator
from poserisk_release_tpu_torch.throughput import make_pose_core
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 20


@pytest.fixture(scope="module")
def clip():
    frames = np.full((N, 240, 320, 3), 30, np.uint8)
    for i in range(N):
        x = 100 + 2 * i
        frames[i, 60:200, x:x + 60] = (180, 150, 120)
    ids = np.arange(N)
    bboxes = np.stack([[130.0 + 2 * i, 130.0, 150.0 + i, 150.0 + i] for i in range(N)])
    return frames, ids, bboxes


@pytest.fixture(scope="module")
def jax_variables(small_chunk_config):
    from poserisk_release_tpu.pipeline import load_spin_variables

    return load_spin_variables(small_chunk_config)


def _both(stride, small_chunk_config, jax_variables, clip):
    jcfg = small_chunk_config.replace(SPIN={"pose_stride": stride})
    jest = JaxPoseEstimator(jcfg, JaxSMPLFamily(jcfg.SPIN.smpl_model_dir), variables=jax_variables)
    tcfg = default_config().replace(PARALLEL={"frames_per_step": 16}, SPIN={"pose_stride": stride})
    test = PoseEstimator(tcfg, SMPLFamily(tcfg.SPIN.smpl_model_dir), device="cpu",
                         variables=flax_to_state_dict(
                             jax.tree_util.tree_map(np.asarray, jax_variables)))
    return jest.run_from_frames(*clip), test.run_from_frames(*clip), test


@pytest.fixture(scope="module")
def stride1(small_chunk_config, jax_variables, clip):
    return _both(1, small_chunk_config, jax_variables, clip)


@pytest.fixture(scope="module")
def stride8(small_chunk_config, jax_variables, clip):
    return _both(8, small_chunk_config, jax_variables, clip)


def _compare(want, got):
    (je, jj, ja), (te, tj, ta) = want, got
    for arr in (te, tj, ta):
        assert arr.shape == (N, 24, 3) and arr.dtype == np.float32
    d = np.abs(te - je)
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), 1e-2)  # deg, +-180 wrap
    np.testing.assert_allclose(tj, jj, atol=1e-2)  # mm
    np.testing.assert_allclose(ta, ja, atol=1e-3)  # rad
    np.testing.assert_array_equal(ta[:, 0], np.tile(np.float32([3.14, 0, 0]), (N, 1)))
    np.testing.assert_array_equal(tj[:, 0], 0.0)  # root-centred


def test_stride1_matches_jax(stride1):
    _compare(*stride1[:2])


def test_stride8_matches_jax_and_keeps_anchors(stride8, clip):
    _compare(*stride8[:2])
    est = stride8[2]
    frames, _, bboxes = clip
    # SPIN runs on the two anchor crops, as at stride 8; each anchor's
    # outputs then fill its 8 frames, so the stride-1 step's angle and joint
    # ops see the stride-8 step's 16 rows, with the anchors at rows 0 and 8.
    core1 = make_pose_core(est.parents, pose_stride=1, spin_forward=lambda crops: [
        x.repeat_interleave(8, dim=0) for x in est.model(crops)])
    # 16-frame chunks at stride 8: anchors (0, 8), then 16 padded by
    # repeating it to the chunk's two anchor slots.
    for ids in ([0, 8], [16, 16]):
        crops = crop_batch(torch.as_tensor(frames[ids]), torch.as_tensor(bboxes[ids]))
        with torch.inference_mode():
            want = [x.numpy()[::8] for x in core1(est.model, est.smpl_params, crops)]
        for got, w in zip(stride8[1], want):
            np.testing.assert_array_equal(got[ids[0]], w[0])
            if ids[1] != ids[0]:
                np.testing.assert_array_equal(got[ids[1]], w[1])
