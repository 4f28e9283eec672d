"""Batched SMPL forward: joints for scoring, the full mesh for the debug export.

Port of the JAX package's ops/lbs.py and ops/lbs_pallas.py.

* joints_only: the scoring path (reference get_joint_cam,
  coord_utils.py:7-21) needs only the 24 joint positions, never the 6890
  vertices, so skinning and pose correctives are skipped and the joints come
  from the kinematic chain alone.
* LBS: the full SMPL_Layer.forward (verts, joints) in meters, for the
  --debug_frame mesh export. On a CUDA device the per-vertex work is kernel
  K4 (ops/skin.skin_vertices_cuda) and the rest joints come from the joint
  regressor folded into the template and the shape basis, as
  lbs_forward_pallas has it; on the CPU it is _lbs_impl, the JAX package's
  _lbs_impl. Semantics of the reference, PER FRAME (it runs one frame per
  call): all-zero betas fall back to the model's template betas
  (smpl_layer.py:87) and an all-zero translation applies none.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLModel
from poserisk_release_tpu_torch.device import resolve_device
from poserisk_release_tpu_torch.ops.rotations import axis_angle_to_rotmat_smpl


def smpl_params_to_torch(model: SMPLModel, device=None) -> Dict[str, torch.Tensor]:
    """Device-resident f32 parameter tables of the SMPL forward, on the
    caller's device, else CUDA (device.resolve_device: raises without CUDA
    rather than putting them on the CPU)."""
    V = model.num_verts
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return {
        "v_template": t(model.v_template),
        "shapedirs": t(model.shapedirs).reshape(V * 3, -1),
        "posedirs": t(model.posedirs).reshape(V * 3, -1),
        "J_regressor": t(model.J_regressor),
        "weights": t(model.weights),
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


def _pose_terms(params, pose_axisang, betas, num_joints):
    """(rotmats (B, J, 3, 3), eff_betas (B, 10), pose_map (B, 9(J-1))): the
    rotations, the per-frame template-betas fallback, and the pose-corrective
    features (rotmats minus identity, root excluded)."""
    B = pose_axisang.shape[0]
    rotmats = axis_angle_to_rotmat_smpl(pose_axisang.reshape(B, num_joints, 3))
    use_template = torch.linalg.norm(betas, dim=1, keepdim=True) == 0.0
    eff_betas = torch.where(use_template, params["template_betas"].expand_as(betas), betas)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_map = (rotmats[:, 1:] - eye).reshape(B, (num_joints - 1) * 9)
    return rotmats, eff_betas, pose_map


def _skin_affines(R_world, t_world, joints_rest):
    """(B, J, 12) [R | t - R j_rest]: each joint's world transform with its
    rest position removed, so it maps rest-space points."""
    B, J = R_world.shape[:2]
    t_skin = t_world - torch.einsum("bjik,bjk->bji", R_world, joints_rest)
    return torch.cat([R_world.reshape(B, J, 9), t_skin], dim=-1)


def _translate(verts, joints, trans):
    """The reference's translation: applied only where it is non-zero, per frame."""
    gate = (torch.linalg.norm(trans, dim=1) != 0.0).to(verts.dtype)[:, None, None]
    offset = gate * trans[:, None, :]
    return verts + offset, joints + offset


def _lbs_impl(params, pose_axisang, betas, trans, parents):
    """The plain SMPL forward on any device (the JAX package's _lbs_impl):
    shape blend, joints regressed from the shaped mesh, the kinematic chain,
    and the vertex part, ops/skin.skin_vertices_plain (K4's plain version).
    Returns (verts (B, V, 3), joints (B, J, 3)) in meters."""
    from poserisk_release_tpu_torch.ops.skin import skin_vertices_plain

    B, J, V = pose_axisang.shape[0], len(parents), params["v_template"].shape[0]
    rotmats, eff_betas, pose_map = _pose_terms(params, pose_axisang, betas, J)
    v_shaped = params["v_template"][None] + torch.matmul(
        eff_betas, params["shapedirs"].T).reshape(B, V, 3)
    joints_rest = torch.einsum("jv,bvc->bjc", params["J_regressor"], v_shaped)
    R_world, t_world = _kinematic_chain(rotmats, joints_rest, parents)
    verts = skin_vertices_plain(eff_betas, pose_map, _skin_affines(R_world, t_world, joints_rest),
                                params["v_template"], params["shapedirs"], params["posedirs"],
                                params["weights"])
    return _translate(verts, t_world, trans)


def skin_inputs(params, pose_axisang, betas, parents):
    """The per-frame inputs of the vertex skinning, as the JAX package's
    lbs_forward_pallas computes them: (eff_betas (B, 10), pose_map
    (B, 9(J-1)), affines (B, J, 12), joints (B, J, 3) m). The rest joints
    come from the regressor folded into the template and the shape basis
    (O(B J) work instead of a (B, V, 3) shaped mesh), the same sums as
    _lbs_impl's, re-associated."""
    J, V = len(parents), params["v_template"].shape[0]
    rotmats, eff_betas, pose_map = _pose_terms(params, pose_axisang, betas, J)
    reg = params["J_regressor"]
    joints_base = torch.matmul(reg, params["v_template"])  # (J, 3)
    joints_shape = torch.einsum("jv,vcs->jcs", reg, params["shapedirs"].reshape(V, 3, -1))
    joints_rest = joints_base[None] + torch.einsum("bs,jcs->bjc", eff_betas, joints_shape)
    R_world, t_world = _kinematic_chain(rotmats, joints_rest, parents)
    return eff_betas, pose_map, _skin_affines(R_world, t_world, joints_rest), t_world


def lbs_forward(params, pose_axisang, betas, trans, parents):
    """The SMPL forward with the per-vertex work in ops/skin.skin_vertices
    (K4 on a CUDA device). Returns (verts (B, V, 3), joints (B, J, 3)) in
    meters."""
    from poserisk_release_tpu_torch.ops.skin import skin_vertices

    eff_betas, pose_map, affines, joints = skin_inputs(params, pose_axisang, betas, parents)
    verts = skin_vertices(eff_betas, pose_map, affines, params["v_template"],
                          params["shapedirs"], params["posedirs"], params["weights"])
    return _translate(verts, joints, trans)


class LBS:
    """Callable SMPL forward bound to one body model's tables on one device.

    >>> verts, joints = LBS(model, device="cpu")(pose_aa_b72, betas_b10)

    On a CUDA device the vertices come from kernel K4 (lbs_forward), on the
    CPU from the plain _lbs_impl: the device decides, as for crop_batch.
    device=None means CUDA, and raises without it."""

    def __init__(self, model: SMPLModel, device=None):
        self.device = resolve_device(device)
        self.params = smpl_params_to_torch(model, self.device)
        parents = np.asarray(model.kintree_parents).astype(np.int64).copy()
        parents[0] = 0  # root sentinel (2**32-1 in the pkl) is never used
        self.parents: Tuple[int, ...] = tuple(int(p) for p in parents)

    def __call__(self, pose_axisang, betas=None, trans=None):
        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        pose_axisang = t(pose_axisang)
        B = pose_axisang.shape[0]
        betas = t(betas) if betas is not None else torch.zeros(
            (B, self.params["template_betas"].shape[0]), device=self.device)
        trans = t(trans) if trans is not None else torch.zeros((B, 3), device=self.device)
        with torch.no_grad():
            if self.device.type == "cuda":
                return lbs_forward(self.params, pose_axisang, betas, trans, self.parents)
            if self.device.type == "cpu":
                return _lbs_impl(self.params, pose_axisang, betas, trans, self.parents)
        raise ValueError(f"LBS has no path for device {self.device}")
