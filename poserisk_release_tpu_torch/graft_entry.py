"""Compile-check entry point of the port: the flagship pose + score step on one device.

The counterpart of the JAX repo's __graft_entry__.entry(). Its mesh dry
run (dryrun_multichip) has no counterpart here yet.
"""

from __future__ import annotations

import torch


def entry(device=None):
    """(fn, example_args) for the strict pose + score step on `device`
    (CUDA unless the CPU is named; without a card it raises).

    fn: crops (B, 224, 224, 3) float32 in [0, 1] on the device -> (reba
    (B,), rula (B,), euler (B, 24, 3), joint_cam (B, 24, 3)): SPIN
    (ResNet-50 + 3-step IEF, the estimator's seeded weights unless a
    checkpoint exists) + rotation conversions + SMPL joints + both scorers,
    throughput.make_pose_and_score_step with the default packed infos.
    example_args: (zeros (8, 224, 224, 3) float32 on the device,).
    """
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_pose_and_score_step,
    )

    device = resolve_device(device)
    cfg = default_config()
    estimator = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device=device)
    step = make_pose_and_score_step(estimator.parents)
    info_reba, info_rula = (torch.as_tensor(a, device=device) for a in default_packed_infos())

    def fn(crops: torch.Tensor):
        with torch.inference_mode():
            return step(estimator.model, estimator.smpl_params, crops, info_reba, info_rula)

    example_args = (torch.zeros((8, 224, 224, 3), dtype=torch.float32, device=device),)
    return fn, example_args
