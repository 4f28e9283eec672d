"""The pose step and the full-frame step shared by the port's entry points.

Port of the JAX package's throughput.py: make_pose_core (crops -> SPIN ->
Euler angles -> root-forced axis-angle -> SMPL joints), make_pose_and_score_step
(+ REBA/RULA), and make_full_frame_step, the per-frame device path of a
whole clip: letterbox + YOLOv3 forward on the detector frames, crop + pose +
scores on the tracked boxes. With fused_resample the letterbox and the crop
come from one launch of kernel K2 (ops/resample.fused_letterbox_crop).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from poserisk_release_tpu_torch.models.spin import hmr_forward_quant
from poserisk_release_tpu_torch.ops.lbs import joints_only
from poserisk_release_tpu_torch.ops.rotations import (
    axis_angle_to_rotmat_smpl,
    rotmat_to_axis_angle,
    rotmat_to_euler_deg,
    slerp_rotmat,
)

ROOT_POSE = (3.14, 0.0, 0.0)


def make_pose_core(parents: Tuple[int, ...], pose_stride: int = 1,
                   quant_backbone: Dict | None = None, spin_forward=None,
                   expert_joints=None, mesh=None):
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

    quant_backbone: the folded / int8-PTQ ResNet-50 (models/spin.
    quantize_spin_backbone, prepared by models/resnet_int8.prepare_resnet50)
    in place of the HMR module's backbone; it computes in the crops' dtype
    (f32 strict, bf16 fast). The IEF head and everything after it are
    unchanged.

    The mesh hooks (parallel/): spin_forward(crops) -> (rotmat, betas,
    cam) replaces the HMR module's forward (the tensor-parallel HMR; the
    pipelined one, which reads only the batch size of `crops` on stages
    after the first; or the row-sharded SpatialHMR, which returns the same
    whole outputs on every spatial rank, so what follows runs replicated
    there). expert_joints (parallel/expert.
    make_expert_joints) replaces joints_only: smpl_params are then this
    rank's expert's tables plus a scalar int32 ``gender_id``. With a mesh
    whose data axis is wider than 1, `crops` are this data rank's rows of
    the chunk's anchors: the slerp runs over the whole chunk's anchors
    (all-gathered), and the outputs are all-gathered so every rank returns
    the whole chunk, as the JAX step over a sharded batch does.

    Returns core(spin_model, smpl_params, crops) ->
    (euler_deg (B, 24, 3), joint_cam_mm (B, 24, 3), aa_forced (B, 24, 3)),
    where B = crops.shape[0] * pose_stride (times the data axis under a
    mesh); spin_model is the HMR module.
    """
    from poserisk_release_tpu_torch.parallel.mesh import gather_rows, shard_rows

    if pose_stride < 1:
        raise ValueError(f"pose_stride must be >= 1, got {pose_stride}")

    def core(spin_model, smpl_params: Dict[str, torch.Tensor], crops: torch.Tensor):
        if spin_forward is not None:
            rotmat, _betas, _cam = spin_forward(crops)
        elif quant_backbone is None:
            rotmat, _betas, _cam = spin_model(crops)
        else:
            rotmat, _betas, _cam = hmr_forward_quant(quant_backbone, spin_model, crops,
                                                     crops.dtype)
        if pose_stride > 1:
            rotmat = gather_rows(rotmat, mesh)
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
            rotmat = shard_rows(rotmat, mesh)
        euler = rotmat_to_euler_deg(rotmat)
        aa = rotmat_to_axis_angle(rotmat)
        aa_forced = aa.clone()
        for axis, value in enumerate(ROOT_POSE):  # fills: no host copy, capturable
            aa_forced[:, 0, axis] = value
        if expert_joints is None:
            joints = joints_only(smpl_params, aa_forced.reshape(aa.shape[0], -1), parents)
        else:
            local = {k: v for k, v in smpl_params.items() if k != "gender_id"}
            gids = smpl_params["gender_id"].expand(aa_forced.shape[0])
            joints = expert_joints(local, axis_angle_to_rotmat_smpl(aa_forced), gids)
        joints = joints * 1000.0
        joint_cam = joints - joints[:, :1]
        if mesh is not None:
            out = gather_rows(torch.cat([euler, joint_cam, aa_forced], dim=2), mesh)
            euler, joint_cam, aa_forced = out[..., :3], out[..., 3:6], out[..., 6:]
        return euler, joint_cam, aa_forced

    return core


def _pose_and_score(parents: Tuple[int, ...], pose_stride: int,
                    quant_backbone: Dict | None, mesh):
    """step(spin_model, smpl_params, crops, info_reba, info_rula) on THIS
    data rank's crops (make_pose_core's convention); every output covers
    the whole batch."""
    from poserisk_release_tpu_torch.scoring.reba import reba_frame_scores
    from poserisk_release_tpu_torch.scoring.rula import rula_frame_scores

    core = make_pose_core(parents, pose_stride=pose_stride, quant_backbone=quant_backbone,
                          mesh=mesh)

    def step(spin_model, smpl_params, crops, info_reba, info_rula):
        euler, joint_cam, _aa = core(spin_model, smpl_params, crops)
        reba = reba_frame_scores(euler, info_reba)["score"]
        rula = rula_frame_scores(euler, info_rula)["score"]
        return reba, rula, euler, joint_cam

    return step


def make_pose_and_score_step(parents: Tuple[int, ...], pose_stride: int = 1,
                             quant_backbone: Dict | None = None, mesh=None):
    """Returns step(spin_model, smpl_params, crops, info_reba, info_rula) ->
    (reba_scores, rula_scores, euler_deg, joint_cam_mm). The crops' dtype
    and the HMR's backbone dtype select strict f32 or fast bf16; rotations
    and scoring stay f32. With pose_stride > 1 `crops` are anchor crops and
    every output covers crops.shape[0] * pose_stride frames.

    mesh: a DeviceMesh with a ``data`` axis (dp over frames, as JAX's jit
    with the crops sharded over ``data``): every rank passes the whole
    batch, computes its contiguous rows (parallel/mesh.shard_rows; the
    batch must split evenly) and returns the whole batch's outputs."""
    from poserisk_release_tpu_torch.parallel.mesh import shard_rows

    step = _pose_and_score(parents, pose_stride, quant_backbone, mesh)
    if mesh is None:
        return step

    def sharded(spin_model, smpl_params, crops, info_reba, info_rula):
        return step(spin_model, smpl_params, shard_rows(crops, mesh), info_reba, info_rula)

    return sharded


def make_full_frame_step(parents: Tuple[int, ...], yolo_model=None, img_size: int = 416,
                         compute_dtype: torch.dtype = torch.float32, rect: bool = True,
                         fused_resample: bool = False, det_stride: int = 1,
                         pose_stride: int = 1, quant_backbone: Dict | None = None,
                         mesh=None):
    """The full per-frame device path, detector included.

    step(yolo_model, spin_model, smpl_params, frames_u8, bboxes, info_reba,
    info_rula) -> (reba, rula, det_best_score). frames are raw uint8 clip
    frames on the device; the detector runs on their letterbox; the crops use
    the given (tracked) boxes, as in the real two-stage pipeline where SORT
    sits between detection and cropping on the host. compute_dtype is the
    resample outputs' dtype (f32 strict, bf16 fast); the models compute in
    their own parameters' dtype, so for bf16 pass a YOLO cast to bf16 and an
    HMR whose backbone is (HMR.cast_backbone). The int8 configuration takes
    a quantized YoloV3 (models/detector.quantize_yolo_params; it computes in
    bf16 around its int8 convs) and a quant_backbone (make_pose_core).

    rect=True letterboxes onto the rectangular canvas (416x288 for 800x450
    frames). det_stride > 1 runs the letterbox and the detector only on
    every Nth frame: det_best has ceil(B / det_stride) entries. pose_stride
    > 1 crops and runs SPIN only on every Nth frame and slerps the others
    (make_pose_core); B must then be a multiple of pose_stride. Scores cover
    every frame.

    fused_resample=True takes the letterbox AND the crop from one launch of
    K2, which reads only every g-th frame, g = gcd(det_stride, pose_stride),
    letterboxing every (det_stride/g)-th and cropping every
    (pose_stride/g)-th of those; like the JAX step it takes the rect canvas
    only (rect=False raises). Without it the letterbox (K2's letterbox-only
    mode on the card) and the crop (K1) run apart.

    mesh: a DeviceMesh with a ``data`` axis (JAX: the frames and boxes
    sharded over ``data``). Every rank passes the whole batch and runs its
    contiguous rows; the pose core all-gathers the anchors for the slerp
    and the outputs, and det_best is gathered from each rank's
    frames[::det_stride], so every rank returns the whole batch's outputs.
    The rows per rank must be a multiple of det_stride and pose_stride:
    JAX's strided slices cross shard boundaries, and here a row count that
    is not raises ValueError.
    """
    from poserisk_release_tpu_torch.models.detector import yolo_forward
    from poserisk_release_tpu_torch.ops.crop import (
        crop_batch,
        letterbox_device,
        letterbox_device_rect,
    )
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop
    from poserisk_release_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_size,
        gather_rows,
        shard_rows,
    )

    if fused_resample and not rect:
        raise ValueError("fused_resample implements the rect-canvas contract")
    if det_stride < 1 or pose_stride < 1:
        raise ValueError(f"strides must be >= 1, got det {det_stride}, pose {pose_stride}")
    pose_step = _pose_and_score(parents, pose_stride, quant_backbone, mesh)
    n_data = axis_size(mesh, DATA_AXIS)

    def step(yolo_m, spin_model, smpl_params, frames, bboxes, info_reba, info_rula):
        if pose_stride > 1 and frames.shape[0] % pose_stride:
            raise ValueError(
                f"batch {frames.shape[0]} is not a multiple of pose_stride {pose_stride}")
        if n_data > 1:
            rows = frames.shape[0] // n_data
            if rows % det_stride or rows % pose_stride:
                raise ValueError(
                    f"{rows} rows per data rank are not a multiple of det_stride "
                    f"{det_stride} and pose_stride {pose_stride}")
            frames, bboxes = shard_rows(frames, mesh), shard_rows(bboxes, mesh)
        with torch.inference_mode():
            if fused_resample:
                g = math.gcd(det_stride, pose_stride)
                letter, crops = fused_letterbox_crop(
                    frames, bboxes, img_size, 224, 1.2, out_dtype=compute_dtype,
                    det_stride=det_stride // g, crop_stride=pose_stride // g,
                    frame_stride=g, rect=rect)
            else:
                letterbox = letterbox_device_rect if rect else letterbox_device
                letter = letterbox(frames[::det_stride], img_size, out_dtype=compute_dtype)
                crops = crop_batch(frames[::pose_stride].contiguous(), bboxes[::pose_stride],
                                   scale=1.2, out_size=224, out_dtype=compute_dtype)
            det = yolo_forward(yolo_m, letter)
            det_best = gather_rows(det[..., 4].max(dim=1).values, mesh)
            reba, rula, _euler, _jc = pose_step(spin_model, smpl_params, crops,
                                                info_reba, info_rula)
        return reba, rula, det_best

    if yolo_model is None:
        return step

    def bound(spin_model, smpl_params, frames, bboxes, info_reba, info_rula):
        return step(yolo_model, spin_model, smpl_params, frames, bboxes, info_reba, info_rula)

    return bound


def score_histogram_psum(scores: torch.Tensor, group, max_score: int = 12) -> torch.Tensor:
    """Per-rank score histogram (max_score float32 bins; score k counts in
    bin k - 1, clipped into range) summed over the group's ranks: the
    metric-reduction collective of the distributed design."""
    from poserisk_release_tpu_torch.parallel.collectives import all_reduce_sum

    idx = torch.clamp(scores.long() - 1, 0, max_score - 1)
    local = torch.nn.functional.one_hot(idx, max_score).to(torch.float32).sum(dim=0)
    return all_reduce_sum(local, group)


def default_packed_infos() -> Tuple[np.ndarray, np.ndarray]:
    """The packaged default_information.json, packed for the REBA and RULA
    score functions (int32 vectors)."""
    import json
    import os.path as osp

    from poserisk_release_tpu_torch.scoring import reba as reba_mod
    from poserisk_release_tpu_torch.scoring import rula as rula_mod

    path = osp.join(osp.dirname(__file__), "default_information.json")
    with open(path) as f:
        info = json.load(f)
    return reba_mod.pack_info(info), rula_mod.pack_info(info)
