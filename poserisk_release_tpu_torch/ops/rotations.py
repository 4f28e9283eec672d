"""Branchless, batched rotation conversions (PyTorch).

Port of the JAX package's ops/rotations.py. The reference converts SPIN's
per-joint rotation matrices to axis-angle and Euler angles one joint at a
time on the host with OpenCV (reference lib/utils/coord_utils.py:24-30,
83-95). Here every conversion is a closed-form tensor expression over a
trailing (3, 3) / (3,) axis, so a whole clip's F x 24 rotations convert in a
handful of elementwise launches on whatever device the input lives on.

Convention parity (required for score-identical REBA/RULA):
  * rotmat -> axis-angle follows cv2.Rodrigues' algorithm, including its
    theta ~ pi branch (sign choice from the matrix diagonal/off-diagonals).
  * rotmat -> Euler follows the reference's XYZ extraction
    (coord_utils.py:69-81) with the sy < 1e-6 gimbal branch as torch.where.
  * euler -> rotmat is the Rz @ Ry @ Rx composition (coord_utils.py:45-60).
All branches are data-independent torch.where selects.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _stack_rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def axis_angle_to_rotmat(aa) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Rodrigues R = I + sin(t) K + (1 - cos(t)) K^2, with the t -> 0 limit
    handled by series expansions of sin(t)/t and (1-cos t)/t^2."""
    aa = _as_tensor(aa)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_theta) / safe_theta)
    cosc = torch.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - torch.cos(safe_theta)) / torch.where(small, torch.ones_like(theta2), theta2))
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    K = _stack_rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    K2 = torch.matmul(K, K)
    return eye + sinc[..., None] * K + cosc[..., None] * K2


def rotmat_to_axis_angle(R) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), cv2 convention.

      r   = (R21 - R12, R02 - R20, R10 - R01)
      c   = clip((trace - 1)/2, -1, 1); theta = arccos(c); s = |sin(theta)|
      |s| >= eps : out = r * theta / (2 s)
      s < eps, c > 0  (theta ~ 0) : out = 0
      s < eps, c <= 0 (theta ~ pi): axis from sqrt((diag + 1)/2) with signs
         taken from the first row (R01, R02) and a parity fix from R12.
    """
    R = _as_tensor(R)
    rx = R[..., 2, 1] - R[..., 1, 2]
    ry = R[..., 0, 2] - R[..., 2, 0]
    rz = R[..., 1, 0] - R[..., 0, 1]
    r = torch.stack([rx, ry, rz], dim=-1)

    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)
    s = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=0.0)) * 0.5

    safe_s = torch.where(s < 1e-5, torch.ones_like(s), s)
    generic = r * (theta / (2.0 * safe_s))[..., None]

    t0 = torch.sqrt(torch.clamp((R[..., 0, 0] + 1.0) * 0.5, min=0.0))
    t1 = torch.sqrt(torch.clamp((R[..., 1, 1] + 1.0) * 0.5, min=0.0))
    t2 = torch.sqrt(torch.clamp((R[..., 2, 2] + 1.0) * 0.5, min=0.0))
    a1 = torch.where(R[..., 0, 1] < 0, -t1, t1)
    a2 = torch.where(R[..., 0, 2] < 0, -t2, t2)
    # cv2's parity fix when the x component is the smallest.
    x_smallest = (torch.abs(t0) < torch.abs(a1)) & (torch.abs(t0) < torch.abs(a2))
    flip = x_smallest & ((R[..., 1, 2] > 0) != (a1 * a2 > 0))
    a2 = torch.where(flip, -a2, a2)
    axis_pi = torch.stack([t0, a1, a2], dim=-1)
    norm_pi = torch.sqrt(torch.clamp(
        torch.sum(axis_pi * axis_pi, dim=-1, keepdim=True), min=1e-24))
    near_pi = (axis_pi / norm_pi) * theta[..., None]

    small_s = (s < 1e-5)[..., None]
    return torch.where(
        small_s,
        torch.where((c > 0)[..., None], torch.zeros_like(r), near_pi),
        generic,
    )


def slerp_rotmat(Ra, Rb, t) -> torch.Tensor:
    """Geodesic interpolation R(t) = Ra . exp(t . log(Ra^T Rb)) between
    rotation matrices (..., 3, 3); `t` broadcasts against the leading dims,
    e.g. (B, 1, 1) over (B, 24, 3, 3). t == 0 returns Ra bit-exactly: the
    relative axis-angle scales to 0, Rodrigues of 0 is the exact identity,
    and Ra @ I multiplies by exact 1s and 0s."""
    Ra = _as_tensor(Ra)
    Rb = _as_tensor(Rb)
    rel = torch.matmul(Ra.transpose(-1, -2), Rb)
    aa = rotmat_to_axis_angle(rel)
    return torch.matmul(Ra, axis_angle_to_rotmat(aa * t))


def rotmat_to_euler_xyz(R) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> XYZ Euler angles (..., 3) in radians,
    R = Rz(z) @ Ry(y) @ Rx(x); gimbal-lock branch (sy < 1e-6) as a select."""
    R = _as_tensor(R)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(
        singular,
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
    )
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def euler_xyz_to_rotmat(euler) -> torch.Tensor:
    """XYZ Euler (..., 3) radians -> rotation matrix, R = Rz @ Ry @ Rx."""
    euler = _as_tensor(euler)
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    return _stack_rows([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ])


def rotmat_to_euler_deg(R) -> torch.Tensor:
    """Rotation matrix -> XYZ Euler in degrees (reference scoring units)."""
    return rotmat_to_euler_xyz(R) * (180.0 / math.pi)


def euler_roundtrip_defect(R) -> torch.Tensor:
    """Per-matrix SIGNED-sum defect of the rotmat -> euler -> rotmat loop,
    the reference's ``(rotation_matrix - rotation_matrix2).sum() > 0.1``
    guard (coord_utils.py:88-91), replicated verbatim."""
    R = _as_tensor(R)
    R2 = euler_xyz_to_rotmat(rotmat_to_euler_xyz(R))
    return torch.sum(R - R2, dim=(-1, -2))


def assert_euler_roundtrip(R, threshold: float = 0.1) -> None:
    """Host-side mirror of the reference's round-trip consistency assert
    (coord_utils.py:90-91). Raises AssertionError naming the worst offender
    when any matrix's defect exceeds the reference's 0.1 bound."""
    R = _as_tensor(R).to(torch.float32)
    defect = euler_roundtrip_defect(R).cpu().numpy()
    if defect.size and defect.max() > threshold:
        idx = np.unravel_index(int(np.argmax(defect)), defect.shape)
        raise AssertionError(
            f"euler round-trip defect {defect.max():.4f} > {threshold} at index {idx} "
            "(reference coord_utils.py:90-91 would abort here)"
        )


def rot6d_to_rotmat(x) -> torch.Tensor:
    """6D rotation representation (..., 6) -> (..., 3, 3) via Gram-Schmidt.

    SPIN's head convention (Zhou et al. CVPR'19): reshape to (..., 3, 2) and
    read COLUMNS, a1 = m[..., 0] and a2 = m[..., 1], then build orthonormal
    columns b1, b2, b3 = b1 x b2."""
    x = _as_tensor(x)
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1 = m[..., 0]
    a2 = m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=1e-8)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2u = a2 - proj * b1
    b2 = b2u / torch.clamp(torch.linalg.vector_norm(b2u, dim=-1, keepdim=True), min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_to_rotmat(quat) -> torch.Tensor:
    """Unit-normalised quaternion (w, x, y, z) (..., 4) -> rotmat (..., 3, 3),
    smplpytorch's quat2mat algebra (rodrigues_layer.py:13-38)."""
    quat = _as_tensor(quat)
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _stack_rows([
        [w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz],
        [2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx],
        [2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2],
    ])


def axis_angle_to_rotmat_smpl(aa) -> torch.Tensor:
    """Axis-angle -> rotmat via the half-angle quaternion, smplpytorch's
    batch_rodrigues (rodrigues_layer.py:41-52) including its +1e-8
    regulariser inside the norm."""
    aa = _as_tensor(aa)
    norm = torch.linalg.vector_norm(aa + 1e-8, dim=-1, keepdim=True)
    half = norm * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * (aa / norm)], dim=-1)
    return quat_to_rotmat(quat)
