"""The port's full SMPL forward (LBS) and kernel K4's plain version vs JAX.

The same synthetic full-size body (6890 vertices, seed 5, as
tests/test_lbs_pallas.py uses) goes through the JAX package's LBS and
lbs_forward_pallas (interpret mode) and the port's LBS on the CPU
(_lbs_impl) and lbs_forward (the kernel path's arithmetic, with K4's plain
version standing in for the kernel on the CPU).

Mixed batches put frames with all-zero betas or all-zero translation beside
frames without: the template-betas fallback and the translation gate are
per frame (a batch-global gate was a real bug of the JAX package).

Tolerances: both packages run f32 matmuls and einsums in another summation
order, so joints agree within 1e-5 m and vertices within 1e-4 m, the bounds
tests/test_lbs_pallas.py holds the Pallas kernel to against the jnp path.
The CUDA kernel is held against the plain version on the card (marked
`cuda`, skipped here); the JAX package is imported only by the tests that
use it, so on a card's machine without jax those run alone:

    python -m pytest tests/test_torch_lbs.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.body import smpl as body
from poserisk_release_tpu_torch.ops.lbs import LBS, lbs_forward, smpl_params_to_torch
from poserisk_release_tpu_torch.ops.skin import (
    skin_vertices,
    skin_vertices_cuda,
    skin_vertices_plain,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def port_model():
    return body.SMPLModel.from_arrays(body.synthetic_smpl_arrays(seed=5))


@pytest.fixture(scope="module")
def models(port_model):
    from poserisk_release_tpu.body import smpl as jax_body

    return jax_body.SMPLModel.from_arrays(jax_body.synthetic_smpl_arrays(seed=5)), port_model


def _mixed_batch(seed):
    rng = np.random.RandomState(seed)
    pose = rng.uniform(-1.0, 1.0, size=(5, 72)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(5, 10)).astype(np.float32)
    trans = rng.normal(size=(5, 3)).astype(np.float32)
    betas[[1, 3]] = 0.0  # template-betas fallback on these frames only
    trans[[0, 3]] = 0.0  # no translation on these frames only
    return pose, betas, trans


def test_synthetic_bodies_are_the_same(models):
    jm, tm = models
    for name in ("v_template", "shapedirs", "posedirs", "weights", "J_regressor", "betas"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)


def test_vertex_segmentation_matches_jax(models):
    jm, tm = models
    got = tm.vertex_segmentation()
    np.testing.assert_array_equal(got, jm.vertex_segmentation())
    assert got.shape == (tm.num_verts,) and got.dtype == np.int64
    assert set(np.unique(got)) <= set(range(tm.num_joints))


@pytest.mark.parametrize("seed", [0, 1])
def test_lbs_matches_jax_on_mixed_batches(models, seed):
    from poserisk_release_tpu.ops.lbs import LBS as JaxLBS

    jm, tm = models
    pose, betas, trans = _mixed_batch(seed)
    want_v, want_j = JaxLBS(jm)(pose, betas, trans)
    got_v, got_j = LBS(tm, device="cpu")(pose, betas, trans)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-4)


def test_per_frame_gates(port_model):
    """A frame's result does not depend on the other frames of its batch."""
    tm = port_model
    pose, betas, trans = _mixed_batch(2)
    lbs = LBS(tm, device="cpu")
    v_all, j_all = lbs(pose, betas, trans)
    for i in range(pose.shape[0]):
        v_i, j_i = lbs(pose[i:i + 1], betas[i:i + 1], trans[i:i + 1])
        np.testing.assert_allclose(v_all[i].numpy(), v_i[0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(j_all[i].numpy(), j_i[0].numpy(), rtol=0, atol=1e-6)


def test_kernel_path_arithmetic_matches_jax_pallas(models):
    """tests/test_lbs_pallas.py's case: lbs_forward (folded regressor, K4's
    plain version on the CPU) against lbs_forward_pallas in interpret mode."""
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.lbs import smpl_params_to_jax
    from poserisk_release_tpu.ops.lbs_pallas import lbs_forward_pallas

    jm, tm = models
    rng = np.random.RandomState(1234)
    pose = rng.uniform(-1.0, 1.0, size=(3, 72)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(3, 10)).astype(np.float32)
    lbs = LBS(tm, device="cpu")
    want_v, want_j = lbs_forward_pallas(smpl_params_to_jax(jm), jnp.asarray(pose),
                                        jnp.asarray(betas), lbs.parents, interpret=True)
    got_v, got_j = lbs_forward(lbs.params, torch.as_tensor(pose), torch.as_tensor(betas),
                               torch.zeros(3, 3), lbs.parents)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-4)


def test_zero_betas_template_fallback_matches_jax_pallas(models):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.lbs import smpl_params_to_jax
    from poserisk_release_tpu.ops.lbs_pallas import lbs_forward_pallas

    jm, tm = models
    pose = np.zeros((1, 72), np.float32)
    pose[0, 0] = 3.14
    lbs = LBS(tm, device="cpu")
    want_v, _ = lbs_forward_pallas(smpl_params_to_jax(jm), jnp.asarray(pose),
                                   jnp.zeros((1, 10), jnp.float32), lbs.parents, interpret=True)
    got_v, _ = lbs(pose)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-4)


def test_translation_composes_after_skinning(port_model):
    tm = port_model
    rng = np.random.RandomState(3)
    pose = rng.uniform(-0.5, 0.5, size=(2, 72)).astype(np.float32)
    trans = rng.normal(size=(2, 3)).astype(np.float32)
    lbs = LBS(tm, device="cpu")
    v0, j0 = lbs(pose, None, np.zeros((2, 3), np.float32))
    v1, j1 = lbs(pose, None, trans)
    np.testing.assert_allclose((v1 - v0).numpy(), np.broadcast_to(trans[:, None], v0.shape),
                               atol=1e-5)
    np.testing.assert_allclose((j1 - j0).numpy(), np.broadcast_to(trans[:, None], j0.shape),
                               atol=1e-5)


def _skin_inputs(model, B, device, seed=0):
    rng = np.random.RandomState(seed)
    p = smpl_params_to_torch(model, device)
    J = model.weights.shape[1]

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    return (t(rng.normal(scale=0.5, size=(B, 10))), t(rng.normal(scale=0.3, size=(B, 9 * (J - 1)))),
            t(rng.normal(scale=0.5, size=(B, J, 12))), p["v_template"], p["shapedirs"],
            p["posedirs"], p["weights"])


def test_skin_dispatch_on_cpu_is_the_plain_version_and_kernel_refuses_cpu(port_model):
    args = _skin_inputs(port_model, 2, "cpu")
    torch.testing.assert_close(skin_vertices(*args), skin_vertices_plain(*args), rtol=0, atol=0)
    before = skin_vertices_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        skin_vertices_cuda(*args)
    assert skin_vertices_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the skinning kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 8, 9, 11, 64])
def test_kernel_matches_plain_version(cuda_device, port_model, B):
    args = _skin_inputs(port_model, B, cuda_device, seed=B)
    before = skin_vertices_cuda.launches
    got = skin_vertices(*args)
    torch.cuda.synchronize()
    assert skin_vertices_cuda.launches == before + 1
    # Another summation order than the plain version's matmuls: f32
    # rounding of sums of ~220 terms of vertex scale ~1 m.
    torch.testing.assert_close(got, skin_vertices_plain(*args), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 9])
def test_kernel_takes_tables_at_any_float_offset(cuda_device, port_model, B):
    """Tables that start 4, 8 or 12 bytes past a 16-byte boundary: the
    slices' ragged ends are copied by plain loads."""
    args = list(_skin_inputs(port_model, B, cuda_device, seed=20 + B))
    for i, off in ((3, 1), (4, 2), (5, 3), (6, 1)):  # template, shapedirs, posedirs, weights
        t = args[i]
        buf = torch.empty(t.numel() + off, device=cuda_device)
        args[i] = buf[off:].view(t.shape).copy_(t)
        assert args[i].data_ptr() % 16 == 4 * off
    torch.testing.assert_close(skin_vertices_cuda(*args), skin_vertices_plain(*args),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_lbs_on_the_card_matches_the_plain_forward(cuda_device, port_model):
    from poserisk_release_tpu_torch.ops.lbs import _lbs_impl

    pose, betas, trans = _mixed_batch(4)
    lbs = LBS(port_model, device=cuda_device)
    before = skin_vertices_cuda.launches
    got_v, got_j = lbs(pose, betas, trans)
    torch.cuda.synchronize()
    assert skin_vertices_cuda.launches == before + 1
    t = [torch.as_tensor(a, device=cuda_device) for a in (pose, betas, trans)]
    want_v, want_j = _lbs_impl(lbs.params, *t, lbs.parents)
    torch.testing.assert_close(got_j, want_j, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=1e-5)
