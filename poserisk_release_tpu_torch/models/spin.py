"""SPIN human-mesh regressor (HMR): ResNet-50 + iterative-error-feedback head.

Port of the JAX package's models/spin.py. Input (B, 224, 224, 3) NHWC floats
in [0, 1] (the reference applies NO ImageNet normalisation); output
(pred_rotmat (B, 24, 3, 3), pred_betas (B, 10), pred_camera (B, 3)).

Architecture (nkolot/SPIN models/hmr.py behavioural spec):
  * ResNet-50 -> 2048-d pooled feature xf;
  * regressor state (pose 24x6 rot6d, shape 10, cam 3) initialised from
    smpl_mean_params.npz (buffers init_pose / init_shape / init_cam);
  * n_iter=3 refinement steps: xc = [xf, pose, shape, cam] -> fc1(1024) ->
    fc2(1024) -> three linear heads added residually to the state (dropout
    is identity at inference, and SPIN has no activation between them);
  * rot6d -> rotation matrices via Gram-Schmidt (ops.rotations).

Module and buffer names are nkolot/SPIN's checkpoint keys, so
model_checkpoint.pt loads with a plain load_state_dict.
"""

from __future__ import annotations

import math
import os.path as osp
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from poserisk_release_tpu_torch.models.resnet import ResNet50
from poserisk_release_tpu_torch.ops.rotations import rot6d_to_rotmat

NPOSE = 24 * 6


def ief_head(dense, xf, pred_pose, pred_shape, pred_cam, n_iter: int):
    """THE IEF-head loop (SPIN hmr.py:66-90). `dense(name, t)` applies the
    named linear layer. Inputs are the already-broadcast (B, .) initial
    states; returns (rotmat (B,24,3,3), betas (B,10), camera (B,3))."""
    B = xf.shape[0]
    for _ in range(n_iter):
        xc = torch.cat([xf, pred_pose, pred_shape, pred_cam], dim=1)
        xc = dense("fc2", dense("fc1", xc))
        pred_pose = dense("decpose", xc) + pred_pose
        pred_shape = dense("decshape", xc) + pred_shape
        pred_cam = dense("deccam", xc) + pred_cam
    rotmat = rot6d_to_rotmat(pred_pose.reshape(B * 24, 6)).reshape(B, 24, 3, 3)
    return rotmat, pred_shape, pred_cam


class HMR(ResNet50):
    """SPIN regressor; forward(crops_nhwc) -> (rotmat, betas, camera).

    The backbone computes in the dtype of its parameters (cast_backbone
    selects bf16 for the fast path); the IEF head and the rot6d decode
    always run in float32."""

    def __init__(self, n_iter: int = 3, mean_params: Dict | None = None):
        super().__init__()
        self.n_iter = n_iter
        self.fc1 = nn.Linear(512 * 4 + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        mean = mean_params or load_mean_params("")
        for key in ("init_pose", "init_shape", "init_cam"):
            self.register_buffer(key, torch.as_tensor(
                np.asarray(mean[key], np.float32).reshape(1, -1)))

    def cast_backbone(self, dtype: torch.dtype) -> "HMR":
        """Store the ResNet parameters and BN statistics in `dtype`."""
        for module in self.backbone_modules():
            module.to(dtype)
        return self

    def head(self, xf: torch.Tensor):
        """The IEF head on pooled features (B, 2048) f32: (rotmat, betas,
        camera) after the model's n_iter refinement steps."""
        B = xf.shape[0]
        return ief_head(
            lambda name, t: getattr(self, name)(t), xf,
            self.init_pose.expand(B, NPOSE), self.init_shape.expand(B, 10),
            self.init_cam.expand(B, 3), self.n_iter)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # NHWC -> NCHW as a view: the permuted tensor is channels-last in
        # memory, which is the layout cuDNN prefers.
        return self.head(self.features(x.permute(0, 3, 1, 2)))


def hmr_forward_quant(qbackbone: Dict, model: HMR, x: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """HMR forward with the folded / int8-PTQ backbone
    (models/resnet_int8.resnet50_forward): the same IEF head as
    HMR.forward, on the HMR module's own head weights and mean-params state,
    always in f32. Returns (rotmat, betas, camera)."""
    from poserisk_release_tpu_torch.models.resnet_int8 import resnet50_forward

    B = x.shape[0]
    xf = resnet50_forward(qbackbone, x, compute_dtype)
    return ief_head(
        lambda name, t: getattr(model, name)(t), xf,
        model.init_pose.expand(B, NPOSE), model.init_shape.expand(B, 10),
        model.init_cam.expand(B, 3), model.n_iter)


def quantize_spin_backbone(state_dict: Dict, sample_crops: torch.Tensor,
                           percentile: float | None = None, bias_correct: bool = True,
                           min_stage: int = 0) -> Dict:
    """Fold + calibrate + quantize the SPIN backbone in one step, from the
    HMR state_dict (f32) and a small representative (N, 224, 224, 3) [0, 1]
    batch of crops. percentile: saturating calibration (None = absmax).
    bias_correct (default) folds the expected per-channel quantization error
    into the biases. min_stage quantizes only residual stages >= it."""
    from poserisk_release_tpu_torch.models.resnet_int8 import (
        bias_correct_resnet50,
        calibrate_resnet50,
        fold_resnet50_params,
        quantize_resnet50,
    )

    folded = fold_resnet50_params(state_dict)
    scales = calibrate_resnet50(folded, sample_crops, percentile=percentile)
    q = quantize_resnet50(folded, scales, min_stage=min_stage)
    if bias_correct:
        q = bias_correct_resnet50(folded, q, sample_crops)
    return q


def load_mean_params(path: str) -> dict:
    """smpl_mean_params.npz -> {init_pose (1,144), init_shape (1,10), init_cam (1,3)}.

    Falls back to a deterministic synthetic set when the asset is absent:
    identity rotations in 6D. rot6d_to_rotmat reads COLUMNS of the (3, 2)
    reshape, a1 = (v0, v2, v4) and a2 = (v1, v3, v5), so identity is the
    flat (1, 0, 0, 1, 0, 0)."""
    if path and osp.isfile(path):
        with np.load(path) as data:
            return {
                "init_pose": data["pose"].astype(np.float32).reshape(1, NPOSE),
                "init_shape": data["shape"].astype(np.float32).reshape(1, 10),
                "init_cam": data["cam"].astype(np.float32).reshape(1, 3),
            }
    ident6 = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)
    return {
        "init_pose": ident6.reshape(1, NPOSE),
        "init_shape": np.zeros((1, 10), np.float32),
        "init_cam": np.array([[0.9, 0.0, 0.0]], np.float32),
    }


def init_spin_params(generator: torch.Generator, mean_params: dict,
                     n_iter: int = 3) -> Dict[str, torch.Tensor]:
    """Random-init HMR state_dict drawn from `generator` (a CPU
    torch.Generator), with the mean-params state injected. The same scheme
    as the JAX package's flax init, though not its numbers: conv and linear
    weights normal with variance 1/fan_in, zero biases, BN identity
    (scale 1, bias 0, mean 0, var 1)."""
    model = HMR(n_iter=n_iter, mean_params=mean_params)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model.state_dict()
