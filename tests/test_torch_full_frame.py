"""make_full_frame_step of the port against the JAX package's, on the CPU.

Eight uint8 frames of 64x64 with fixed boxes go through both packages'
full-frame steps (letterbox + YOLOv3 at img_size 64, crop + SPIN + joints +
REBA/RULA) with the same weights: the JAX package's seed-0 YOLO init and
SPIN init, handed to the port through the weight bridges. Each (det, pose)
stride pair runs unfused and fused (K2's plain version in the port, the
Pallas kernel in interpret mode in the JAX package), as
tests/test_pose_stride.py runs them.

What must agree: the per-frame integer REBA and RULA scores exactly (the
crops agree within 1e-5 and SPIN's outputs within 5e-5,
tests/test_torch_pose.py, far inside the rule thresholds on these frames),
and det_best within 1e-3, the bound tests/test_pose_stride.py holds the
JAX package's fused step to against its unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models import detector as td
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict, yolo_params_to_state_dict
from poserisk_release_tpu_torch.models.spin import HMR
from poserisk_release_tpu_torch.ops.lbs import smpl_params_to_torch
from poserisk_release_tpu_torch.throughput import default_packed_infos, make_full_frame_step
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STRIDES = [(1, 1), (4, 2), (2, 4)]


@pytest.fixture(scope="module")
def setup():
    from poserisk_release_tpu.body.smpl import SMPLFamily as JaxSMPLFamily
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.models.detector import fold_bn_params, init_yolo_params
    from poserisk_release_tpu.pipeline import PoseEstimator as JaxPoseEstimator
    from poserisk_release_tpu.throughput import default_packed_infos as jax_infos

    jcfg = jax_default_config().replace(PARALLEL={"frames_per_step": 16})
    est = JaxPoseEstimator(jcfg, JaxSMPLFamily(jcfg.SPIN.smpl_model_dir))
    yolo = fold_bn_params(init_yolo_params())
    ir, iu = jax_infos()

    cfg = default_config()
    spin = HMR(n_iter=cfg.SPIN.ief_iters)
    spin.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, est.variables)))
    spin.eval()
    yolo_model = td.YoloV3.from_state_dict(
        yolo_params_to_state_dict(jax.tree_util.tree_map(np.asarray, yolo)))
    smpl = smpl_params_to_torch(SMPLFamily(cfg.SPIN.smpl_model_dir)["neutral"], device="cpu")
    pr, pu = (torch.as_tensor(a) for a in default_packed_infos())

    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    boxes = np.tile(np.array([[32.0, 32.0, 20.0, 20.0]], np.float32), (8, 1))
    jax_side = (cfg.SPIN.ief_iters, est, yolo, jnp.asarray(ir), jnp.asarray(iu))
    port_side = (spin, yolo_model, smpl, pr, pu, tuple(est.parents))
    return frames, boxes, jax_side, port_side


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("det_s, pose_s", STRIDES)
def test_full_frame_step_matches_jax(setup, det_s, pose_s, fused):
    from poserisk_release_tpu.throughput import make_full_frame_step as jax_step

    frames, boxes, (n_iter, est, yolo, ir, iu), (spin, yolo_model, smpl, pr, pu, parents) = setup
    want_reba, want_rula, want_best = jax_step(
        n_iter, est.parents, img_size=64, det_stride=det_s, pose_stride=pose_s,
        fused_resample=fused, fused_interpret=True)(
        yolo, est.variables, est.smpl_params, jnp.asarray(frames), jnp.asarray(boxes), ir, iu)
    step = make_full_frame_step(parents, yolo_model=yolo_model, img_size=64,
                                det_stride=det_s, pose_stride=pose_s, fused_resample=fused)
    reba, rula, best = step(spin, smpl, torch.as_tensor(frames), torch.as_tensor(boxes), pr, pu)
    assert reba.shape == rula.shape == (8,)
    assert best.shape == (-(-8 // det_s),)
    np.testing.assert_array_equal(reba.numpy(), np.asarray(want_reba))
    np.testing.assert_array_equal(rula.numpy(), np.asarray(want_rula))
    assert float(np.abs(best.numpy() - np.asarray(want_best)).max()) < 1e-3


def test_fused_step_matches_unfused_and_checks_the_batch(setup):
    frames, boxes, _, (spin, yolo_model, smpl, pr, pu, parents) = setup
    args = (spin, smpl, torch.as_tensor(frames), torch.as_tensor(boxes), pr, pu)
    kw = dict(yolo_model=yolo_model, img_size=64, det_stride=2, pose_stride=4)
    unfused = make_full_frame_step(parents, **kw)(*args)
    fused = make_full_frame_step(parents, fused_resample=True, **kw)(*args)
    for a, b in zip(unfused[:2], fused[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((unfused[2] - fused[2]).abs().max()) < 1e-3
    with pytest.raises(ValueError, match="multiple of pose_stride"):
        make_full_frame_step(parents, **kw)(spin, smpl, torch.as_tensor(frames[:7]),
                                            torch.as_tensor(boxes[:7]), pr, pu)


def test_default_packed_infos_match_jax():
    from poserisk_release_tpu.throughput import default_packed_infos as jax_infos

    for got, want in zip(default_packed_infos(), jax_infos()):
        np.testing.assert_array_equal(got, want)


def test_fused_square_canvas_raises_like_jax(setup):
    """The fused step takes the rect canvas only, in both packages: the
    square fused mode gives an output no JAX function gives."""
    from poserisk_release_tpu.throughput import make_full_frame_step as jax_step

    _, _, (n_iter, est, _, _, _), (_, yolo_model, _, _, _, parents) = setup
    messages = []
    for build in (lambda: jax_step(n_iter, est.parents, rect=False, fused_resample=True),
                  lambda: make_full_frame_step(parents, yolo_model=yolo_model, rect=False,
                                               fused_resample=True)):
        with pytest.raises(ValueError, match="rect-canvas contract") as exc:
            build()
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
