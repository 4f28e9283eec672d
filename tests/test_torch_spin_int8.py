"""The port's folded / int8-PTQ SPIN backbone against the JAX package's, on the CPU.

Both packages start from the same weights (the port's seeded
init_spin_params, handed to the JAX package through the weight bridge) and
the same seeded crops (4 of 224x224, the JAX int8 tests' size).

Tolerances, and why:
  * the BN fold and the weight quantization are the same host numpy
    arithmetic on the same inputs: exact;
  * calibration (absmax and the 99.9th percentile of |x|): the f32 float
    walks sum in another order, 1e-5 relative;
  * bias-correction terms on the same quantized params: means over every
    output position of y_f - y_q, where the float halves differ by f32
    summation order (1e-5) and the int8 halves are exact unless an input
    flips at a .5 tie; one flip moves a channel's term by at most
    kh * kw * in_scale * max|w| / (output positions), and four flips per
    layer are allowed (the float walks feeding them differ by ~1e-6
    relative, so a few inputs of a layer lie that close to a tie);
  * hmr_forward_quant on JAX's quantized backbone: rotmat, betas and camera
    within 5e-4, the class of the JAX package's own head test
    (tests/test_resnet_int8.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.models import resnet_int8 as jr
from poserisk_release_tpu.models.spin import hmr_forward_quant as jax_hmr_quant
from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models import resnet_int8 as tr
from poserisk_release_tpu_torch.models.convert import (
    flax_to_state_dict,
    resnet_params_from_jax,
    spin_state_dict_to_flax,
)
from poserisk_release_tpu_torch.models.spin import (
    HMR,
    hmr_forward_quant,
    init_spin_params,
    load_mean_params,
    quantize_spin_backbone,
)
from poserisk_release_tpu_torch.pipeline import PoseEstimator
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    variables = spin_state_dict_to_flax(
        init_spin_params(torch.Generator().manual_seed(0), load_mean_params("")))
    sd = flax_to_state_dict(variables)
    crops = np.random.RandomState(11).rand(4, 224, 224, 3).astype(np.float32)
    folded = _np_tree(jr.fold_resnet50_params(variables))
    absmax = jr.calibrate_resnet50(folded, jnp.asarray(crops[:2]))
    return variables, sd, crops, folded, absmax


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for k in want[name]:
            g, w = np.asarray(got[name][k]), np.asarray(want[name][k])
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")


def test_fold_matches_jax_exactly(shared):
    _, sd, _, folded, _ = shared
    _assert_same_tree(tr.fold_resnet50_params(sd), resnet_params_from_jax(folded))


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibration_matches_jax(shared, percentile):
    _, sd, crops, folded, absmax = shared
    want = absmax if percentile is None else jr.calibrate_resnet50(
        folded, jnp.asarray(crops[:2]), percentile=percentile)
    got = tr.calibrate_resnet50(tr.fold_resnet50_params(sd), torch.as_tensor(crops[:2]),
                                percentile=percentile)
    assert set(got) == set(want) and len(got) == 53
    rel = max(abs(got[k] - want[k]) / want[k] for k in got)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("min_stage, n_quantized", [(0, 53), (3, 29), (4, 10)])
def test_quantize_matches_jax_exactly(shared, min_stage, n_quantized):
    _, _, _, folded, absmax = shared
    want = resnet_params_from_jax(_np_tree(jr.quantize_resnet50(folded, absmax, min_stage)))
    got = tr.quantize_resnet50(resnet_params_from_jax(folded), absmax, min_stage)
    _assert_same_tree(got, want)
    quantized = {n for n, layer in got.items() if "qkernel" in layer}
    assert len(quantized) == n_quantized
    assert all(tr._conv_stage(n) >= min_stage for n in quantized)
    with pytest.raises(ValueError, match="zero convs"):
        tr.quantize_resnet50(resnet_params_from_jax(folded), absmax, min_stage=5)


def test_bias_correction_matches_jax(shared):
    _, _, crops, folded, absmax = shared
    q_jax = _np_tree(jr.quantize_resnet50(folded, absmax, min_stage=3))
    want = resnet_params_from_jax(_np_tree(jr.bias_correct_resnet50(
        folded, q_jax, jnp.asarray(crops[:2]))))
    q = resnet_params_from_jax(q_jax)
    x = torch.as_tensor(crops[:2])
    got = tr.bias_correct_resnet50(resnet_params_from_jax(folded), q, x)
    record = {}
    tr.resnet50_forward(resnet_params_from_jax(folded), x, torch.float32, _record=record)
    geo = tr._conv_geometry()
    assert sorted(got) == sorted(want)
    for name in want:
        corr_w = want[name]["bias"] - q[name]["bias"]
        corr_g = got[name]["bias"] - q[name]["bias"]
        if "qkernel" not in q[name]:  # float layers under min_stage: untouched
            np.testing.assert_array_equal(corr_g, 0.0 * corr_g)
            continue
        (stride, pad), k = geo[name], q[name]["qkernel"].shape[0]
        ho = (record[name].shape[2] + 2 * pad - k) // stride + 1
        flip = k * k * float(q[name]["in_scale"]) * float(np.abs(
            q[name]["w_scale"] * q[name]["qkernel"]).max()) / (x.shape[0] * ho * ho)
        np.testing.assert_allclose(corr_g, corr_w, rtol=0, atol=1e-5 + 4 * flip, err_msg=name)


@pytest.fixture(scope="module")
def hmr(shared):
    model = HMR()
    model.load_state_dict(shared[1])
    return model.eval()


def test_hmr_forward_quant_matches_jax(shared, hmr):
    variables, _, crops, folded, absmax = shared
    q_jax = _np_tree(jr.quantize_resnet50(folded, absmax))
    want = jax.jit(jax_hmr_quant, static_argnums=(3, 4))(q_jax, variables, jnp.asarray(crops),
                                                         3, jnp.float32)
    with torch.no_grad():
        got = hmr_forward_quant(resnet_params_from_jax(q_jax), hmr, torch.as_tensor(crops),
                                torch.float32)
    for name, g, w in zip(("rotmat", "betas", "camera"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4, err_msg=name)


def test_folded_head_math_equals_the_module(shared, hmr):
    """hmr_forward_quant on the FLOAT folded backbone reproduces HMR.forward
    (the BN fold is the only difference)."""
    _, sd, crops, _, _ = shared
    x = torch.as_tensor(crops[:2])
    with torch.no_grad():
        want = hmr(x)
        got = hmr_forward_quant(tr.fold_resnet50_params(sd), hmr, x, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-4)


def test_int8_backbone_bounded_drift(shared):
    """The port alone: int8 PTQ features stay within 5% of the float ones."""
    _, sd, crops, _, _ = shared
    folded = tr.fold_resnet50_params(sd)
    x = torch.as_tensor(crops)
    with torch.no_grad():
        ref = tr.resnet50_forward(folded, x, torch.float32)
        q = quantize_spin_backbone(sd, x[:2])
        got = tr.resnet50_forward(q, x, torch.float32)
    assert float((got - ref).abs().max() / ref.abs().max()) < 0.05


# ---------------------------------------------------------------------------
# PoseEstimator(spin_int8=True): the lifecycle of the JAX package's tests.
# ---------------------------------------------------------------------------
def _estimator(sd, recalibrate=False, spin_int8=True):
    cfg = default_config().replace(PARALLEL={"frames_per_step": 16},
                                   DETECTOR={"recalibrate_per_video": recalibrate})
    return PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=sd,
                         spin_int8=spin_int8, device="cpu")


def test_run_from_frames_quantizes_on_first_crops(shared):
    est = _estimator(shared[1])
    assert est.spin_needs_calibration
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 255, (8, 96, 128, 3)).astype(np.uint8)
    bboxes = np.tile(np.array([64.0, 48.0, 40.0, 60.0], np.float32), (8, 1))
    euler, joint_cam, _ = est.run_from_frames(frames, np.arange(8), bboxes)
    assert not est.spin_needs_calibration
    assert euler.shape == joint_cam.shape == (8, 24, 3) and np.isfinite(euler).all()


def test_calibrate_on_frames_equals_run_from_frames_calibration(shared):
    """The one calibration entry from frames: on a clip's first 8 tracked
    (frame, box) rows it leaves the quant_params that run_from_frames'
    implicit calibration leaves, and once quantized it does nothing."""
    cfg = default_config().replace(PARALLEL={"frames_per_step": 8},
                                   MODEL={"input_shape": (64, 64)})

    def estimator():
        return PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=shared[1],
                             spin_int8=True, device="cpu")

    rng = np.random.RandomState(4)
    frames = rng.randint(0, 255, (16, 48, 64, 3)).astype(np.uint8)
    ids = np.sort(rng.choice(16, 11, replace=False))
    bboxes = np.stack([[32.0 + i % 3, 24.0, 30.0 + i % 4, 30.0] for i in range(11)])
    implicit = estimator()
    implicit.run_from_frames(frames, ids, bboxes)
    explicit = estimator()
    explicit.calibrate_on_frames(frames[ids[:8]], bboxes[:8])
    assert not explicit.spin_needs_calibration
    _assert_same_tree(explicit.quant_params, implicit.quant_params)
    quant = explicit.quant_params
    explicit.calibrate_on_frames(frames[ids[8:]], bboxes[8:])
    assert explicit.quant_params is quant


def test_calibrate_spin_once_and_reset(shared):
    rng = np.random.RandomState(2)
    bright = rng.uniform(0.5, 1.0, (4, 224, 224, 3)).astype(np.float32)
    dark = rng.uniform(0.0, 0.05, (4, 224, 224, 3)).astype(np.float32)
    est = _estimator(shared[1], recalibrate=True)
    est.reset_calibration()  # nothing quantized yet: a no-op
    est.calibrate_spin(bright)
    quant = est._quant_backbone
    assert quant is not None and not est.spin_needs_calibration
    est.calibrate_spin(dark)  # a no-op once quantized
    assert est._quant_backbone is quant
    est.reset_calibration()
    assert est.spin_needs_calibration
    est.calibrate_spin(dark)
    assert est._quant_backbone is not None and est._quant_backbone is not quant
    euler, _, _ = est.run(dark)
    assert euler.shape == (4, 24, 3) and np.isfinite(euler).all()


def test_reset_without_recalibrate_flag_raises(shared):
    est = _estimator(shared[1], recalibrate=False)
    est.calibrate_spin(np.random.RandomState(3).uniform(0, 1, (4, 224, 224, 3)).astype(
        np.float32))
    with pytest.raises(RuntimeError, match="recalibrate_per_video"):
        est.reset_calibration()
    off = _estimator(shared[1], spin_int8=False)
    off.reset_calibration()  # spin_int8 off: a no-op
    assert not off.spin_needs_calibration
