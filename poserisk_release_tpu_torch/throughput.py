"""The pose step shared by the port's entry points.

Port of make_pose_core of the JAX package's throughput.py: crops -> SPIN ->
Euler angles -> root-forced axis-angle -> SMPL joints. The JAX package's
fused whole-clip bench graphs (detector + crop + pose + score) arrive with
the detector slice of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from poserisk_release_tpu_torch.ops.lbs import joints_only
from poserisk_release_tpu_torch.ops.rotations import (
    rotmat_to_axis_angle,
    rotmat_to_euler_deg,
    slerp_rotmat,
)

ROOT_POSE = (3.14, 0.0, 0.0)


def make_pose_core(parents: Tuple[int, ...], pose_stride: int = 1):
    """THE pose step (one definition so the subtle ordering cannot
    desynchronise): SPIN forward -> Euler from the ORIGINAL rotmats ->
    axis-angle with the root forced to ROOT_POSE (the reference mutates its
    buffer in place, coord_utils.py:12-13) -> SMPL joints in mm,
    root-centred.

    pose_stride > 1 is the pose-stride throughput mode: `crops` are the
    ANCHOR crops (every pose_stride-th frame) and SPIN runs only on them; the
    intermediate frames' 24 joint rotations are slerped between the
    surrounding anchors (anchors sit at t == 0, so anchor poses are
    bit-exact vs stride 1). Frames after the LAST anchor hold its pose.

    Returns core(spin_model, smpl_params, crops) ->
    (euler_deg (B, 24, 3), joint_cam_mm (B, 24, 3), aa_forced (B, 24, 3)),
    where B = crops.shape[0] * pose_stride; spin_model is the HMR module.
    """
    if pose_stride < 1:
        raise ValueError(f"pose_stride must be >= 1, got {pose_stride}")

    def core(spin_model, smpl_params: Dict[str, torch.Tensor], crops: torch.Tensor):
        rotmat, _betas, _cam = spin_model(crops)
        if pose_stride > 1:
            anchors = rotmat.shape[0]
            n_frames = anchors * pose_stride
            idx = torch.arange(n_frames, device=rotmat.device)
            grp = idx // pose_stride
            t = (idx % pose_stride).to(torch.float32)
            rotmat = slerp_rotmat(
                rotmat[grp],
                rotmat[torch.clamp(grp + 1, max=anchors - 1)],
                (t / pose_stride)[:, None, None],
            )
        euler = rotmat_to_euler_deg(rotmat)
        aa = rotmat_to_axis_angle(rotmat)
        aa_forced = aa.clone()
        aa_forced[:, 0, :] = torch.tensor(ROOT_POSE, dtype=aa.dtype, device=aa.device)
        joints = joints_only(smpl_params, aa_forced.reshape(aa.shape[0], -1), parents)
        joints = joints * 1000.0
        joint_cam = joints - joints[:, :1]
        return euler, joint_cam, aa_forced

    return core
