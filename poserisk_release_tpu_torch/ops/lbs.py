"""SMPL joint positions from joint rotations (PyTorch).

Port of the joints-only half of the JAX package's ops/lbs.py: the scoring
path (reference get_joint_cam, coord_utils.py:7-21) needs only the 24 joint
positions, never the 6890 vertices, so skinning and pose correctives are
skipped and the joints come from the kinematic chain alone. The full vertex
LBS (and its fused kernel) arrives with the debug-mesh slice of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from poserisk_release_tpu_torch.body.smpl import SMPLModel
from poserisk_release_tpu_torch.ops.rotations import axis_angle_to_rotmat_smpl


def smpl_params_to_torch(model: SMPLModel, device="cpu") -> Dict[str, torch.Tensor]:
    """Device-resident f32 parameter tables for the joints computation."""
    V = model.num_verts

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return {
        "v_template": t(model.v_template),
        "shapedirs": t(model.shapedirs).reshape(V * 3, -1),
        "J_regressor": t(model.J_regressor),
        "template_betas": t(model.betas),
    }


def _kinematic_chain(
    rotmats: torch.Tensor, joints_rest: torch.Tensor, parents: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate world transforms along the (static) kinematic tree.

    rotmats: (B, J, 3, 3) local rotations; joints_rest: (B, J, 3).
    Returns (R_world (B, J, 3, 3), t_world (B, J, 3)) of each joint's world
    transform [R | t]. parents[0] is 0 (the pkl's 2**32-1 root sentinel is
    never read)."""
    num_joints = rotmats.shape[1]
    R = [rotmats[:, 0]]
    t = [joints_rest[:, 0]]
    for j in range(1, num_joints):
        p = parents[j]
        rel_t = joints_rest[:, j] - joints_rest[:, p]
        R.append(torch.matmul(R[p], rotmats[:, j]))
        t.append(torch.einsum("bij,bj->bi", R[p], rel_t) + t[p])
    return torch.stack(R, dim=1), torch.stack(t, dim=1)


def joints_only(
    params: Dict[str, torch.Tensor], pose_axisang: torch.Tensor, parents: Tuple[int, ...]
) -> torch.Tensor:
    """Joint locations (B, J, 3) in meters for zero-beta poses, from
    axis-angle poses (B, J*3) through smplpytorch's batch_rodrigues."""
    B = pose_axisang.shape[0]
    J = len(parents)
    rotmats = axis_angle_to_rotmat_smpl(pose_axisang.reshape(B, J, 3))
    return joints_only_from_rotmats(params, rotmats, parents)


def joints_only_from_rotmats(
    params: Dict[str, torch.Tensor], rotmats: torch.Tensor, parents: Tuple[int, ...]
) -> torch.Tensor:
    """joints_only taking per-joint rotation matrices (B, J, 3, 3) directly.
    The rest joints come from the template betas (the reference's all-zero
    betas fallback, smpl_layer.py:87). Returns (B, J, 3) m."""
    B = rotmats.shape[0]
    J = len(parents)
    v_shaped = params["v_template"][None] + torch.matmul(
        params["template_betas"][None], params["shapedirs"].T
    ).reshape(1, -1, 3)
    joints_rest = torch.einsum("jv,bvc->bjc", params["J_regressor"], v_shaped)
    joints_rest = joints_rest.expand(B, J, 3)
    _, t_world = _kinematic_chain(rotmats, joints_rest, parents)
    return t_world
