"""Port rotation conversions held against the JAX package's, case by case.

Both packages get the same numpy inputs: random rotations plus the edge
cases of tests/test_rotations.py -- theta ~ 0 (series branch of Rodrigues),
theta ~ pi and exactly pi (cv2's diagonal branch, where sin(theta) == 0),
the exact identity (sin == 0 with cos > 0), and gimbal lock (pitch = +-90
deg, the sy < 1e-6 Euler branch). Tolerances: float64 agrees to 1e-12
(the same closed forms, rounded in another order); float32 to 1e-5, about
a hundred ulps of values in [-pi, pi], except where a formula is
ill-conditioned (arccos near pi), which is stated at the assert.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.ops import rotations as J
from poserisk_release_tpu_torch.ops import rotations as T

pytestmark = pytest.mark.smoke

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _axis_angles(n, seed=0, max_angle=np.pi - 0.05):
    rng = np.random.RandomState(seed)
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return axes * rng.uniform(0.001, max_angle, size=(n, 1))


def _edge_axis_angles():
    unit = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.6, 0.8, 0], [0.48, -0.6, 0.64]])
    return np.concatenate([
        np.zeros((1, 3)),                    # exact identity
        unit * 1e-9, unit * 1e-4,            # theta ~ 0
        unit * (np.pi - 1e-9), unit * (np.pi - 1e-3), unit * np.pi,  # theta ~ pi
    ])


def _rotmats(dtype):
    aas = np.concatenate([_axis_angles(256), _edge_axis_angles()])
    mats = np.asarray(J.axis_angle_to_rotmat(jnp.asarray(aas, jnp.float64)))
    exact_pi = np.array([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                         np.diag([-1.0, -1, 1])])
    return np.concatenate([mats, exact_pi, np.eye(3)[None]]).astype(dtype)


def _gimbal_mats(dtype):
    rows = []
    for sign in (1.0, -1.0):
        for x, z in ((0.3, 0.2), (-1.0, 2.5), (0.0, 0.0)):
            rows.append([x, sign * np.pi / 2, z])
    return np.asarray(J.euler_xyz_to_rotmat(jnp.asarray(rows, jnp.float64))).astype(dtype)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_axis_angle_to_rotmat(dtype):
    aas = np.concatenate([_axis_angles(256, seed=1), _edge_axis_angles()]).astype(dtype)
    for fn in ("axis_angle_to_rotmat", "axis_angle_to_rotmat_smpl"):
        want = np.asarray(getattr(J, fn)(jnp.asarray(aas)))
        got = getattr(T, fn)(_t(aas)).numpy()
        assert got.dtype == dtype
        np.testing.assert_allclose(got, want, atol=TOL[dtype], err_msg=fn)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rotmat_to_axis_angle(dtype):
    mats = _rotmats(dtype)
    want = np.asarray(J.rotmat_to_axis_angle(jnp.asarray(mats)))
    got = T.rotmat_to_axis_angle(_t(mats)).numpy()
    # f32: arccos((trace - 1) / 2) has an unbounded derivative at theta ~ pi,
    # so one ulp of the trace moves theta by ~3e-4 rad there; both
    # implementations evaluate the same expression, so they stay far closer.
    np.testing.assert_allclose(got, want, atol=TOL[dtype] if dtype == np.float64 else 5e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rotmat_to_euler_including_gimbal_lock(dtype):
    mats = np.concatenate([_rotmats(dtype), _gimbal_mats(dtype)])
    want = np.asarray(J.rotmat_to_euler_deg(jnp.asarray(mats)))
    got = T.rotmat_to_euler_deg(_t(mats)).numpy()
    # Degrees: 180/pi times the radian tolerance.
    np.testing.assert_allclose(got, want, atol=TOL[dtype] * 60)
    np.testing.assert_allclose(T.rotmat_to_euler_xyz(_t(mats)).numpy(),
                               np.asarray(J.rotmat_to_euler_xyz(jnp.asarray(mats))),
                               atol=TOL[dtype])
    gimbal = _gimbal_mats(np.float64)
    sy = np.sqrt(gimbal[:, 0, 0] ** 2 + gimbal[:, 1, 0] ** 2)
    assert (sy < 1e-6).all()  # the singular branch really ran


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_euler_to_rotmat_and_roundtrip_defect(dtype):
    eul = np.random.RandomState(2).uniform(-np.pi, np.pi, (128, 3)).astype(dtype)
    np.testing.assert_allclose(T.euler_xyz_to_rotmat(_t(eul)).numpy(),
                               np.asarray(J.euler_xyz_to_rotmat(jnp.asarray(eul))),
                               atol=TOL[dtype])
    mats = np.concatenate([_rotmats(dtype), _gimbal_mats(dtype)])
    np.testing.assert_allclose(T.euler_roundtrip_defect(_t(mats)).numpy(),
                               np.asarray(J.euler_roundtrip_defect(jnp.asarray(mats))),
                               atol=TOL[dtype] * 10)


def test_assert_euler_roundtrip():
    T.assert_euler_roundtrip(_t(_rotmats(np.float32)))
    bad = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    bad[1] *= 2.0  # not a rotation: the signed-sum defect exceeds 0.1
    with pytest.raises(AssertionError, match="round-trip defect"):
        T.assert_euler_roundtrip(_t(bad))
    with pytest.raises(AssertionError):
        J.assert_euler_roundtrip(bad)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rot6d_to_rotmat(dtype):
    x = np.random.RandomState(3).normal(size=(64, 24 * 6)).reshape(-1, 6).astype(dtype)
    ident = np.tile(np.array([1, 0, 0, 1, 0, 0], dtype), (1, 1))
    x = np.concatenate([x, ident])
    got = T.rot6d_to_rotmat(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.rot6d_to_rotmat(jnp.asarray(x))),
                               atol=TOL[dtype] * 10)
    np.testing.assert_allclose(got[-1], np.eye(3), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slerp_rotmat(dtype):
    ra = np.asarray(J.axis_angle_to_rotmat(jnp.asarray(_axis_angles(32, seed=4)))).astype(dtype)
    rb = np.asarray(J.axis_angle_to_rotmat(jnp.asarray(_axis_angles(32, seed=5)))).astype(dtype)
    t = np.linspace(0, 1, 32, dtype=dtype)[:, None]  # broadcasts against aa (32, 3)
    got = T.slerp_rotmat(_t(ra), _t(rb), _t(t)).numpy()
    want = np.asarray(J.slerp_rotmat(jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=TOL[dtype] * 10)
    np.testing.assert_array_equal(got[0], ra[0])  # t == 0 returns Ra bit-exactly
