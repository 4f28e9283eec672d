"""End-to-end video -> ergonomic-risk pipeline (the reference Predictor) in PyTorch.

Port of the JAX package's pipeline.py. Reference contract:
Predictor.__init__/__call__ (reference lib/core/base.py:76-209) -- video
ingest, multi-person tracking, target selection, 224x224 crops, SPIN pose
regression, joint-angle extraction, neutral-SMPL joint positions, REBA/RULA
scoring, stats, plots, annotated video, result txts and debug CSVs.

Device policy: every entry point runs on CUDA unless the caller passes
device="cpu"; with no device given and no CUDA present it raises, it never
carries on quietly on the CPU. On the card the hand-written kernels do the
resampling and the skinning: the crop (K1, ops/resample.crop_batch_cuda),
the detector's letterbox (K2, ops/resample.fused_letterbox_crop_cuda) and
the --debug_frame mesh (K4, ops/skin.skin_vertices_cuda); on the CPU their
plain versions do.

Numerics: the strict (default) path turns TF32 off for cuDNN convolutions
and matmuls, which default to TF32 on Hopper and would break f32 parity
with the JAX reference. On the card it runs the HMR's backbone with
BatchNorm folded into the convs, NCHW throughout, each conv followed by
one hand-written epilogue (runs_folded_chain, models/resnet_int8.
resnet50_forward, ops/epilogue.conv_epilogue_cuda). fast=True runs the ResNet
backbone in bfloat16 on bf16 crops, with the IEF head and everything after
it in float32.

Detector: YOLOv3 (models/detector.YoloDetector) when DETECTOR.weights
exists, else the full-frame StubDetector.

int8 PTQ (opt-in, as in the JAX package): DETECTOR.int8 (--fast_detector)
quantizes the YOLOv3 tower and spin_int8 (--spin_int8) the SPIN backbone.
Both calibrate their activation scales on the first frames they see, or up
front from DETECTOR.calibration (apply_explicit_calibration), and
DETECTOR.recalibrate_per_video re-derives them for every video.

Mesh parallelism (parallel/, over torch.distributed): PARALLEL's data,
model (tp), stage (pp), expert (ep) and spatial (sp) axes, one process per
rank. Every rank runs the Predictor's host side identically; each data
rank runs the pose step on its rows of a chunk under its model axes (K1
crops on every data rank, on stage 0 under pp; under sp every spatial rank
crops its data rows whole and keeps its row window); the outputs are
all-gathered, and only rank 0 writes files. The bounded-memory streaming
scorer, on one device or any of these meshes, is streaming.StreamingScorer.
"""

from __future__ import annotations

import itertools
import json
import os
import os.path as osp
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import Config, default_config
from poserisk_release_tpu_torch.device import resolve_device
from poserisk_release_tpu_torch.io.video import read_video_parallel
from poserisk_release_tpu_torch.models import convert as model_convert
from poserisk_release_tpu_torch.models.detector import StubDetector, YoloDetector
from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params
from poserisk_release_tpu_torch.ops.crop import crop_batch
from poserisk_release_tpu_torch.ops.lbs import LBS, smpl_params_to_torch
from poserisk_release_tpu_torch.outputs.render import render_result_video, vis_3d_pose
from poserisk_release_tpu_torch.outputs.stats import (
    post_process_scores,
    print_result_summary,
    scores_summary_block,
    write_result_txt,
)
from poserisk_release_tpu_torch.outputs.writers import (
    pose_to_str,
    save_obj,
    save_csv_pose_log,
    save_eval_pose_log_csv,
    save_score_log_csv,
)
from poserisk_release_tpu_torch.scoring.reba import REBAScorer
from poserisk_release_tpu_torch.scoring.rula import RULAScorer
from poserisk_release_tpu_torch.staging import HostRows, StagingRing, chunk_row_ids
from poserisk_release_tpu_torch.throughput import make_pose_core
from poserisk_release_tpu_torch.tracking.mpt import (
    MultiPersonTracker,
    detect_frames,
    filter_and_select_target,
    squared_cxcywh,
    surviving_tracks,
)


def _global_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def load_spin_variables(cfg: Config) -> Dict[str, torch.Tensor]:
    """SPIN weights as the port's HMR state_dict, resolved as the JAX
    package resolves them: converted-npz cache > torch checkpoint (converted
    once, init_* filled from the mean params, then cached in the same
    `.flax.npz` format) > random init from a fixed seed with the mean params.

    The cache embeds the checkpoint's (size, mtime_ns) stamp; any mismatch
    triggers re-conversion, so new weights dropped over the old checkpoint
    path are never shadowed by the previous conversion. Caches without a
    stamp fall back to the mtime ordering.

    In a process group only rank 0 writes the cache; the other ranks
    convert the checkpoint themselves rather than read a cache that rank 0
    may be writing (a cache without a checkpoint, which nobody writes, they
    read)."""
    npz_path = cfg.SPIN.checkpoint + ".flax.npz"
    have_ckpt = osp.isfile(cfg.SPIN.checkpoint)
    writer = _global_rank() == 0
    if osp.isfile(npz_path) and (writer or not have_ckpt):
        fresh = not have_ckpt
        if have_ckpt:
            stamp = model_convert.cached_source_stamp(npz_path)
            if stamp is not None:
                fresh = bool(np.array_equal(
                    stamp, model_convert.source_stamp(cfg.SPIN.checkpoint)))
            else:
                fresh = not (os.path.getmtime(cfg.SPIN.checkpoint)
                             > os.path.getmtime(npz_path))
        if fresh:
            return model_convert.flax_to_state_dict(
                model_convert.load_flax_variables(npz_path))
    mean = load_mean_params(cfg.SPIN.smpl_mean_params)
    if have_ckpt:
        variables = model_convert.spin_state_dict_to_flax(
            model_convert.load_spin_checkpoint(cfg.SPIN.checkpoint))
        for key in ("init_pose", "init_shape", "init_cam"):
            variables["params"].setdefault(key, mean[key])
        if writer:
            model_convert.save_flax_variables(variables, npz_path,
                                              source=cfg.SPIN.checkpoint)
        return model_convert.flax_to_state_dict(variables)
    return init_spin_params(torch.Generator().manual_seed(0), mean,
                            n_iter=cfg.SPIN.ief_iters)


def _chunk_rows(x, ids: np.ndarray):
    """A chunk's rows of x: for a tensor (the streaming scorer's shared
    per-window upload) gathered on its own device, never via the host; for
    a host array the rows still to gather, which _run_chunked stages."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(ids, dtype=torch.long, device=x.device)]
    return HostRows(x, np.asarray(ids))


def _mesh_axes(cfg: Config, mesh) -> tuple:
    """The names of the mesh the estimator will run on: the given mesh's,
    or the one PARALLEL describes (known before any process group exists,
    so the layout checks run first)."""
    from poserisk_release_tpu_torch.parallel import spmd

    if mesh is not None:
        return tuple(mesh.mesh_dim_names)
    pcfg = cfg.PARALLEL
    axes = spmd.model_axes_from_config(pcfg)
    if axes or int(pcfg.num_devices) > 1:
        return (pcfg.data_axis, *axes)
    return ()


def runs_folded_chain(device: torch.device, backbone_dtype: torch.dtype) -> bool:
    """Whether a single-device HMR runs its backbone BN-folded, NCHW, one
    epilogue a conv (models/resnet_int8.resnet50_forward on
    fold_resnet50_params' f32 dict): strict f32 on a CUDA device. cuDNN's strict-
    f32 convs are NCHW kernels there, so the channels-last module pays a
    layout transpose on each side of every conv, and its BatchNorm, ReLUs
    and residual adds are passes of their own; the chain is the GEMM and
    one epilogue a conv. bf16 (fast) keeps the channels-last module: cuDNN's
    bf16 tensor-core kernels are NHWC-native, so NCHW would add the
    transposes. The CPU keeps the module: folding reorders the f32 sums,
    and the CPU checks of debug/pose_log.csv against the JAX package are
    byte for byte."""
    return torch.device(device).type == "cuda" and backbone_dtype == torch.float32


class PoseEstimator:
    """Crops -> (euler deg, joint_cam mm, axis-angle), chunked, on one
    device or one rank of a mesh."""

    def __init__(self, cfg: Config, smpl_family: SMPLFamily,
                 variables: Optional[Dict[str, torch.Tensor]] = None,
                 gender: str = "neutral", fast: bool = False, spin_int8: bool = False,
                 device=None, mesh=None):
        """variables: an HMR state_dict (models.convert.flax_to_state_dict
        turns the JAX package's Flax tree into one); None resolves them
        through load_spin_variables. fast=True runs the ResNet backbone in
        bfloat16 on bf16 crops; the default is the strict f32 configuration
        with TF32 off.

        spin_int8=True routes the ResNet-50 through the int8 PTQ backbone
        (models/resnet_int8), folded, calibrated and bias-corrected on the
        first crops this estimator sees (at most 8), in the crops' dtype
        around its int8 convs (f32 strict, bf16 fast); under dp, ep or sp
        rank 0 quantizes on whole crops and every rank takes its backbone
        (a replica).

        mesh: a DeviceMesh (parallel/spmd.mesh_from_config), or None, in
        which case PARALLEL decides: any model axis, or num_devices > 1,
        builds the mesh over the process group this rank has joined
        (parallel/distributed.initialize_distributed); otherwise the
        estimator runs on one device. Under the mesh the HMR is Megatron-
        sharded over ``model`` (tp), GPipe-pipelined over ``stage`` with
        each rank holding only its stage's weights (pp), or replicated,
        with the gendered SMPL tables one per ``expert`` rank (ep); the
        crop rows of every activation split over ``spatial`` (sp, with
        halo exchanges: parallel/spmd.SpatialHMR, in the estimator's own
        steps; the whole-row core stays for the server); chunks split over
        ``data`` and every rank returns the whole chunk."""
        from poserisk_release_tpu_torch.parallel import mesh as pmesh
        from poserisk_release_tpu_torch.parallel import spmd

        pcfg = cfg.PARALLEL
        names = _mesh_axes(cfg, mesh)
        if names and pcfg.data_axis not in names:
            raise ValueError(
                f"mesh axes {names} lack the configured data axis {pcfg.data_axis!r}")
        self._tp = spmd.MODEL_AXIS in names
        self._pp = spmd.STAGE_AXIS in names
        self._ep = spmd.EXPERT_AXIS in names
        self._sp = spmd.SPATIAL_AXIS in names
        if self._pp and (self._tp or self._sp or self._ep):
            raise ValueError(
                "PARALLEL.stage (pipeline parallelism) cannot combine with the "
                "model/spatial/expert axes in one mesh")
        if spin_int8 and (self._tp or self._pp):
            raise ValueError(
                "spin_int8 cannot combine with model or stage parallelism: the quantized "
                "backbone has its own layout; pick one of int8 / tp / pp for the backbone")
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is None and names:
            mesh = spmd.mesh_from_config(pcfg)
        self.mesh = mesh
        self._n_data = pmesh.axis_size(mesh, pcfg.data_axis)
        self.fast = bool(fast)
        if self.device.type == "cuda" and not self.fast:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        self._family = smpl_family
        self.gender = gender
        parents = np.asarray(smpl_family[gender].kintree_parents).copy()
        parents[0] = 0
        self.parents = tuple(int(p) for p in parents)
        expert_joints = None
        if self._ep:
            from poserisk_release_tpu_torch.parallel.expert import (
                GENDERS, make_expert_joints, stack_gender_experts)

            # Each expert rank keeps only its own slot of the stacked
            # gendered tables; set_gender swaps the routing scalar.
            e = pmesh.axis_index(mesh, spmd.EXPERT_AXIS)
            stacked = stack_gender_experts(smpl_family, pmesh.axis_size(mesh, spmd.EXPERT_AXIS))
            self.smpl_params = {k: v[e].to(self.device) for k, v in stacked.items()}
            self.smpl_params["gender_id"] = torch.tensor(
                GENDERS.index(gender), dtype=torch.int32, device=self.device)
            expert_joints = make_expert_joints(
                self.parents, pmesh.axis_group(mesh, spmd.EXPERT_AXIS), e)
        else:
            self.smpl_params = smpl_params_to_torch(smpl_family[gender], self.device)

        # Pose-stride throughput mode (SpinConfig.pose_stride): SPIN runs on
        # every Nth tracked frame; skipped frames slerp between anchors.
        self._pose_stride = int(cfg.SPIN.pose_stride)
        if variables is None:
            variables = load_spin_variables(cfg)
        # The f32 weights are folded at quantization time, so int8 keeps
        # them (on the host) until then, or for good under
        # recalibrate_per_video, which re-folds for every video.
        self._spin_int8 = bool(spin_int8)
        self._variables_f32 = (
            {k: v.detach().cpu().clone() for k, v in variables.items()} if spin_int8 else None)
        self._quant_backbone = self.quant_params = None
        self._crop_dtype = torch.bfloat16 if self.fast else torch.float32
        # Stage 0 alone crops under pp; the other stages never read pixels.
        self._crops_here = True
        spin_forward = None
        if self._tp:
            self.model = spmd.TensorParallelHMR(
                variables, pmesh.axis_group(mesh, spmd.MODEL_AXIS),
                pmesh.axis_size(mesh, spmd.MODEL_AXIS), pmesh.axis_index(mesh, spmd.MODEL_AXIS),
                cfg.SPIN.ief_iters, self.device, self._crop_dtype)
            spin_forward = self.model
        elif self._pp:
            from poserisk_release_tpu_torch.parallel import pipeline as ppipe

            n_stages = pmesh.axis_size(mesh, spmd.STAGE_AXIS)
            stage = pmesh.axis_index(mesh, spmd.STAGE_AXIS)
            sized = variables
            if self.fast:  # the split balances the bytes the stages will hold
                sized = {k: v.to(torch.bfloat16) if k.startswith(("conv1.", "bn1.", "layer"))
                         and v.is_floating_point() else v for k, v in variables.items()}
            self._pp_split = ppipe.balanced_split(sized, n_stages)
            self.model = ppipe.PipelineHMR(
                ppipe.stage_param_entries(variables, self._pp_split)[stage], self._pp_split,
                pmesh.axis_group(mesh, spmd.STAGE_AXIS), stage,
                int(pcfg.stage_microbatches), int(cfg.MODEL.input_shape[0]),
                cfg.SPIN.ief_iters, self.device, self._crop_dtype)
            spin_forward = self.model
            self._crops_here = stage == 0
        else:
            model = HMR(n_iter=cfg.SPIN.ief_iters)
            model.load_state_dict(variables)
            model.eval()
            if self.fast:
                model.cast_backbone(torch.bfloat16)
            self.model = model.to(self.device, memory_format=torch.channels_last)
        # The one place that picks the backbone every pose core runs. The
        # folded chain needs the whole module (not tp's shard or pp's stage)
        # and whole crop rows (sp's SpatialHMR walks the module); spin_int8
        # folds and calibrates its own backbone on the first crops.
        self._folds = (spin_forward is None and not self._sp and not spin_int8
                       and runs_folded_chain(self.device, self.model.conv1.weight.dtype))
        self._spin_forward = spin_forward
        self._core_hooks = {"expert_joints": expert_joints, "mesh": mesh}
        self._rows = None
        if self._sp:
            self._rows = pmesh.RowShards(pmesh.axis_group(mesh, spmd.SPATIAL_AXIS),
                                         pmesh.axis_size(mesh, spmd.SPATIAL_AXIS),
                                         pmesh.axis_index(mesh, spmd.SPATIAL_AXIS))
        self._pose_core = self._step_core = None  # built on first use (_cores)
        self._ring = None  # the chunks' staging, made on first use

    def _build_cores(self) -> None:
        """The pose cores on the current backbone: `_pose_core` reads whole
        crop rows (whole_row_step's), `_step_core` is the estimator's own
        steps' core, the same one unless the crop rows split over
        ``spatial`` (JAX constrains the crops in those steps only)."""
        from poserisk_release_tpu_torch.parallel.spmd import SpatialHMR

        if self._folds and self._quant_backbone is None:
            # The strict-f32 backbone on the card: BatchNorm folded into
            # each conv once (the JAX package's fold arithmetic), OIHW
            # weights on the device, the module's own IEF head
            # (make_pose_core -> models/spin.hmr_forward_quant).
            from poserisk_release_tpu_torch.models.resnet_int8 import (
                fold_resnet50_params,
                prepare_resnet50,
            )

            self._quant_backbone = prepare_resnet50(
                fold_resnet50_params(self.model.state_dict()), self.device)
        hooks = dict(self._core_hooks, pose_stride=self._pose_stride,
                     quant_backbone=self._quant_backbone)
        self._pose_core = make_pose_core(self.parents, spin_forward=self._spin_forward, **hooks)
        self._step_core = self._pose_core
        if self._rows is not None:  # self.model: the HMR, or its tp shard
            self._step_core = make_pose_core(
                self.parents, spin_forward=SpatialHMR(self.model, self._rows,
                                                      self._quant_backbone), **hooks)

    def _cores(self) -> tuple:
        """(_pose_core, _step_core), built on first use, so an estimator
        that only lends its module (train/step.TrainState) folds nothing."""
        if self._pose_core is None:
            self._build_cores()
        return self._pose_core, self._step_core

    @property
    def param_bytes(self) -> int:
        """Bytes of the SPIN weights this rank holds on its device (the
        whole HMR, its tp shard, or its pp stage). A folded or quantized
        copy of the backbone beside them (the strict card's, spin_int8's) is
        not counted."""
        if isinstance(self.model, torch.nn.Module):
            return sum(t.numel() * t.element_size() for t in self.model.state_dict().values())
        return self.model.nbytes()

    def set_gender(self, gender: str) -> None:
        """Switch the SMPL body model between tracks (--person_genders).
        Under ep only the routing scalar changes: the gendered tables stay
        where they are, one per expert rank."""
        if gender == self.gender:
            return
        if self._ep:
            from poserisk_release_tpu_torch.parallel.expert import GENDERS

            self.smpl_params["gender_id"].fill_(GENDERS.index(gender))  # ValueError if unknown
        else:
            self.smpl_params = smpl_params_to_torch(self._family[gender], self.device)
        self.gender = gender

    def _ensure_spin_quantized(self, calib_crops: torch.Tensor) -> None:
        """spin_int8 lifecycle: fold + calibrate + bias-correct the backbone
        on the first crops (at most 8), then rebuild the pose core around
        it. No-op once quantized or without spin_int8."""
        if not self._spin_int8 or self._quant_backbone is not None:
            return
        from poserisk_release_tpu_torch.models.spin import quantize_spin_backbone

        calib = torch.as_tensor(calib_crops[:8], dtype=torch.float32, device=self.device)
        qparams = None
        if self.mesh is None or _global_rank() == 0:
            qparams = quantize_spin_backbone(
                self._variables_f32, calib, min_stage=int(self.cfg.SPIN.int8_min_stage))
        if self.mesh is not None:
            # dp / ep / sp: one calibration on whole crops, replicated (rank
            # 0's, as the JAX estimator replicates its one quantized tree).
            from poserisk_release_tpu_torch.parallel.collectives import broadcast_object

            qparams = broadcast_object(qparams, src=0)
        self.load_quant_backbone(qparams)
        if not self.cfg.DETECTOR.recalibrate_per_video:
            self._variables_f32 = None

    def load_quant_backbone(self, qparams: Dict) -> None:
        """Run the pose core through the given folded / int8 backbone dict
        (quantize_spin_backbone's, or the JAX package's through
        models/convert.resnet_params_from_jax), kept as `quant_params`."""
        from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50

        self.quant_params = qparams
        self._quant_backbone = prepare_resnet50(qparams, self.device)
        self._build_cores()

    def reset_calibration(self) -> None:
        """Drop the int8 backbone so the next crops (or calibrate_spin)
        re-derive the activation scales: the SPIN half of
        DETECTOR.recalibrate_per_video. No-op without spin_int8 or before
        quantization; raises when the f32 weights were released (the
        estimator was not built under recalibrate_per_video)."""
        if not self._spin_int8 or self._quant_backbone is None:
            return
        if self._variables_f32 is None:
            raise RuntimeError(
                "cannot reset spin_int8 calibration: the f32 parameter tree "
                "was released; construct the estimator with "
                "DETECTOR.recalibrate_per_video=True to keep it resident")
        self._quant_backbone = self.quant_params = None
        self._build_cores()

    def calibrate_spin(self, crops) -> None:
        """Explicit spin_int8 calibration on representative person crops
        ((N, 224, 224, 3) float [0, 1]). No-op without spin_int8, once
        quantized, or on no crops."""
        if self.spin_needs_calibration and len(crops):
            self._ensure_spin_quantized(torch.as_tensor(np.asarray(crops)[:8]))

    def calibrate_on_frames(self, frames, bboxes) -> None:
        """spin_int8 calibration on the f32 crops (K1 on the card) of the
        first (at most 8) rows of uint8 frames and boxes, host arrays or
        tensors. No-op without spin_int8, once quantized, or on no rows."""
        if not self.spin_needs_calibration or not len(frames):
            return
        self._ensure_spin_quantized(crop_batch(
            torch.as_tensor(frames[:8], device=self.device),
            torch.as_tensor(bboxes[:8], dtype=torch.float32, device=self.device),
            scale=float(self.cfg.DATASET.bbox_scale),
            out_size=int(self.cfg.MODEL.input_shape[0])))

    @property
    def spin_needs_calibration(self) -> bool:
        return self._spin_int8 and self._quant_backbone is None

    @property
    def pose_stride(self) -> int:
        """SPIN runs on every pose_stride-th frame (SpinConfig.pose_stride)."""
        return self._pose_stride

    @property
    def row_quantum(self) -> int:
        """What every chunk and server bucket rounds up to: data ranks x pose
        stride (the anchor phase aligned across chunks, the anchors split
        evenly over the data axis), x stage_microbatches under pp."""
        q = self._n_data * self._pose_stride
        if self._pp:
            q *= int(self.cfg.PARALLEL.stage_microbatches)
        return q

    @property
    def row_step_has_collectives(self) -> bool:
        """Whether whole_row_step runs collectives inside itself: the model
        axes' (tp, pp, ep), which then also gather the data rows."""
        return self._tp or self._pp or self._ep

    def whole_row_step(self):
        """step(frames_u8, bboxes) -> (euler, joint_cam, aa) at pose stride 1:
        crop + the current backbone's pose core (take a new step after int8
        calibration) over whole crop rows, so spatial ranks compute their
        data rows as replicas, as the JAX server does. Under a mesh without
        row_step_has_collectives it returns this data rank's rows and
        leaves their gather to the caller."""
        core = self._cores()[0]
        if self.mesh is not None and not self.row_step_has_collectives:
            core = make_pose_core(self.parents, quant_backbone=self._quant_backbone)

        def step(frames_u8: torch.Tensor, bboxes: torch.Tensor):
            return core(self.model, self.smpl_params, self._crop(frames_u8, bboxes))

        return step

    def _pose_step(self, crops: torch.Tensor):
        return self._cores()[1](self.model, self.smpl_params, crops)

    def _crop(self, frames_u8: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
        """The pose step's crops (K1 on the card). A later pp stage crops
        nothing: it gets an empty (B, 0) tensor, since only B matters there."""
        if not self._crops_here:
            return torch.empty((frames_u8.shape[0], 0), device=self.device)
        return crop_batch(frames_u8, bboxes, scale=float(self.cfg.DATASET.bbox_scale),
                          out_size=int(self.cfg.MODEL.input_shape[0]),
                          out_dtype=self._crop_dtype)

    def _pose_step_from_frames(self, frames_u8: torch.Tensor, bboxes: torch.Tensor):
        # Crop fused into the pose step: the host uploads raw uint8 frames
        # once and downloads only angles/joints.
        return self._cores()[1](self.model, self.smpl_params, self._crop(frames_u8, bboxes))

    def run(self, crops: np.ndarray, chunk: int = 0):
        """crops: (F, 224, 224, 3) float32 [0,1]. Chunked + padded execution;
        under pose_stride > 1 only every Nth crop is uploaded (the anchors)."""
        self.calibrate_spin(crops)
        stride = self._pose_stride
        n = crops.shape[0]
        return self._run_chunked(
            n,
            lambda start, size: (HostRows(crops, np.arange(start, min(start + size, n), stride)),),
            self._pose_step,
            chunk,
        )

    def run_from_frames(self, frames_rgb, frame_ids: np.ndarray,
                        bboxes: np.ndarray, chunk: int = 0):
        """Crop + pose straight from raw uint8 frames (the Predictor's
        production path): only the tracked uint8 frames go up, only
        angles/joints come back. Under pose_stride > 1 only every Nth
        tracked frame is uploaded. frames_rgb is a host array, or a tensor
        already on the device, whose frames are then gathered and padded
        there. A host array's frames, and every chunk's boxes, are staged
        (_run_chunked)."""
        frame_ids = np.asarray(frame_ids)
        bboxes = np.asarray(bboxes, np.float32)
        if self.spin_needs_calibration:
            # The first 8 tracked frames' f32 crops calibrate the backbone.
            self.calibrate_on_frames(frames_rgb[frame_ids[:8]], bboxes[:8])
        stride = self._pose_stride
        n = len(frame_ids)
        return self._run_chunked(
            n,
            lambda start, size: (
                _chunk_rows(frames_rgb, frame_ids[start : start + size : stride]),
                HostRows(bboxes, np.arange(start, min(start + size, n), stride)),
            ),
            self._pose_step_from_frames,
            chunk,
        )

    def production_chunk(self, chunk: int = 0) -> int:
        """THE chunk-size rule: the requested (or configured frames_per_step
        * n_data) chunk rounded up to a multiple of row_quantum."""
        if chunk <= 0:
            chunk = self.cfg.PARALLEL.frames_per_step * self._n_data
        q = self.row_quantum
        return ((chunk + q - 1) // q) * q

    def upload_stats(self) -> Dict[str, int]:
        """How the chunks' host parts went up: `staged_chunks` through the
        staging ring (with `staged_bytes`, and `slot_waits`, the times the
        host waited for a slot's last copy on the card)."""
        ring = self._ring
        return {"staged_chunks": ring.chunks if ring else 0,
                "staged_bytes": ring.bytes if ring else 0,
                "slot_waits": ring.waits if ring else 0}

    def _run_chunked(self, num_items: int, host_chunk, step_fn, chunk: int = 0):
        """Runs step_fn over production chunks of num_items; host_chunk(start,
        size) gives a chunk's parts: HostRows of host arrays, or tensors.

        Every HostRows part is staged (staging.StagingRing), on every
        device: its rows, edge-padded and cut to this data rank's share,
        are gathered into a slot. On a CUDA device that crops, the slot is
        pinned and copied on the ring's copy stream, and the compute stream
        waits on that copy's event before the step; elsewhere (the CPU, a
        later pp stage) the step reads the slot's host views. A tensor part
        (the streaming scorer's shared device window) is padded and sharded
        on its own device. Each chunk is staged before the fetch of the
        oldest chunk in flight, whose .cpu() syncs the compute stream, so
        the gather and copy overlap the chunk the device is running."""
        chunk = self.production_chunk(chunk)
        if num_items == 0:
            empty = np.zeros((0, 24, 3), np.float32)
            return empty, empty.copy(), empty.copy()

        from poserisk_release_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows

        rows = chunk // self._pose_stride

        def upload(start: int):
            # n_valid counts FRAMES (the step's output rows); under a pose
            # stride the uploaded parts are the anchor subsample.
            n_valid = min(chunk, num_items - start)
            parts = host_chunk(start, chunk)
            host = [HostRows(p.source, chunk_row_ids(p.ids, rows, self.mesh))
                    for p in parts if isinstance(p, HostRows)]
            if self._ring is None:  # a later pp stage keeps its rows on the host
                self._ring = StagingRing(self.device if self._crops_here else "cpu")
            staged = iter(self._ring.upload(host) if host else ())
            return [next(staged) if isinstance(p, HostRows)
                    else shard_rows(pad_to_multiple(p, rows)[0], self.mesh).to(
                        self.device, non_blocking=True)
                    for p in parts], n_valid

        eulers, jcams, aas = [], [], []

        def fetch(out, start, n_valid, idx):
            # Per-chunk fault isolation: a failed fetch re-runs its chunk
            # once on the same device before surfacing with context. Not
            # under a mesh: a rank re-running alone would wait forever on
            # its collectives.
            try:
                e, jc, aa = (x.cpu().numpy() for x in out)
            except RuntimeError:
                if self.mesh is not None:
                    raise
                try:
                    batches, _ = upload(start)
                    with torch.inference_mode():
                        out = step_fn(*batches)
                    e, jc, aa = (x.cpu().numpy() for x in out)
                except RuntimeError as exc:
                    raise RuntimeError(
                        f"pose-estimation chunk {idx} (frames "
                        f"{start}..{start + n_valid - 1}) failed twice"
                    ) from exc
            eulers.append(e[:n_valid])
            jcams.append(jc[:n_valid])
            aas.append(aa[:n_valid])

        # Bounded pipelining: the host enqueues up to MAX_IN_FLIGHT chunks
        # ahead of the fetches, so the device overlaps chunks while at most
        # that many chunks' uint8 frames, and the one staged next, are
        # resident at once.
        MAX_IN_FLIGHT = 4
        pending = []
        for start in range(0, num_items, chunk):
            batches, n_valid = upload(start)
            if len(pending) >= MAX_IN_FLIGHT:
                out, s, nv = pending.pop(0)
                fetch(out, s, nv, len(eulers))
            with torch.inference_mode():
                pending.append((step_fn(*batches), start, n_valid))
            del batches
        for out, s, nv in pending:
            fetch(out, s, nv, len(eulers))
        return np.concatenate(eulers), np.concatenate(jcams), np.concatenate(aas)


def validate_rotation_roundtrip(axis_angles) -> None:
    """Host-side euler round-trip guard mirroring the reference's
    coord_utils assert (--validate_rotations). Joint 0 is excluded: its
    axis-angle is root-forced to (3.14, 0, 0) while its euler keeps the
    original rotmat."""
    from poserisk_release_tpu_torch.ops.rotations import (
        assert_euler_roundtrip,
        axis_angle_to_rotmat,
    )

    aa = torch.as_tensor(np.asarray(axis_angles, np.float32)[:, 1:, :])
    assert_euler_roundtrip(axis_angle_to_rotmat(aa))


def build_detector(cfg: Config, device=None):
    """The Predictor's detector policy: YOLOv3 from DETECTOR.weights when
    the file exists, else the full-frame StubDetector that keeps weight-free
    environments runnable."""
    if osp.isfile(cfg.DETECTOR.weights):
        return YoloDetector.from_weights(
            cfg.DETECTOR.weights,
            img_size=cfg.DETECTOR.img_size,
            detection_threshold=cfg.DETECTOR.detection_threshold,
            nms_threshold=cfg.DETECTOR.nms_threshold,
            batch_size=cfg.DETECTOR.batch_size,
            rect=cfg.DETECTOR.rect_letterbox,
            max_device_dets=cfg.DETECTOR.max_device_dets,
            int8=cfg.DETECTOR.int8,
            int8_min_downsample=cfg.DETECTOR.int8_min_downsample,
            device=device,
        )
    print("[poserisk] no detector weights found; using full-frame stub detector")
    return StubDetector()


def load_add_info(cfg: Config, info_path: str) -> Dict:
    """Additional-information JSON with the reference's default fallback
    (base.py:137-142): a missing --info path falls back to the packaged
    default_information.json."""
    path = info_path if osp.isfile(info_path) else cfg.DATASET.default_information
    with open(path) as f:
        return json.load(f)


def apply_explicit_calibration(cfg: Config, detector, pose_estimator) -> None:
    """The explicit int8 calibration lifecycle (DETECTOR.calibration):
    derive the activation scales from an operator-supplied source before any
    video frame is seen, so a dark opening window cannot pin them. The same
    frames calibrate the int8 SPIN backbone: the freshly calibrated detector
    proposes person boxes (the largest per frame, squared as the tracker
    squares them; the full frame when nothing clears the threshold) on up to
    8 evenly drawn frames, and their crops feed quantize_spin_backbone."""
    src = cfg.DETECTOR.calibration
    if not src:
        return
    needs_det = getattr(detector, "needs_calibration", False)
    needs_spin = pose_estimator.spin_needs_calibration
    if not (needs_det or needs_spin):
        return
    from poserisk_release_tpu_torch.io.video import load_calibration_frames

    frames = load_calibration_frames(src, cfg.DETECTOR.calibration_frames)
    if needs_det:
        detector.calibrate(frames)
    if needs_spin:
        sample = frames[:: max(1, len(frames) // 8)][:8]
        H, W = sample.shape[1:3]
        boxes = []
        for dets in detect_frames(detector, sample):
            if len(dets):
                best = dets[np.argmax((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]))]
                boxes.append(squared_cxcywh(best[0], best[1], best[2], best[3]))
            else:
                side = float(max(H, W))
                boxes.append([W / 2.0, H / 2.0, side, side])
        dev = pose_estimator.device
        crops = crop_batch(torch.as_tensor(sample, device=dev),
                           torch.as_tensor(np.asarray(boxes, np.float32), device=dev),
                           scale=float(cfg.DATASET.bbox_scale),
                           out_size=int(cfg.MODEL.input_shape[0]))
        pose_estimator.calibrate_spin(crops.cpu().numpy())


class Predictor:
    """Reference-compatible orchestrator. See module docstring."""

    def __init__(
        self,
        cfg: Config | None = None,
        score_type: str = "REBA,RULA",
        debug: bool = False,
        debug_joints: str = "",
        debug_frame: int = -1,
        visualize: bool = True,
        detector=None,
        spin_variables=None,
        allow_synthetic_assets: bool = True,
        gender: str = "neutral",
        multi_person: bool = False,
        person_genders: Optional[Dict] = None,
        fast: bool = False,
        spin_int8: bool = False,
        validate_rotations: bool = False,
        device=None,
        mesh=None,
    ):
        """mesh: as PoseEstimator's (None: PARALLEL decides). Under a mesh
        every rank runs the Predictor and returns the same result; only
        rank 0 writes files (result txts, CSVs, plots, videos, the run
        summary), so its outputs equal a single-rank run's byte for byte."""
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        self.smpl = SMPLFamily(self.cfg.SPIN.smpl_model_dir, allow_synthetic=allow_synthetic_assets)
        self.gender = gender
        self.multi_person = multi_person
        self.person_genders = {
            int(pid): g for pid, g in (person_genders or {}).items()
        }
        for g in self.person_genders.values():
            if g not in ("neutral", "male", "female"):
                raise ValueError(f"Invalid gender: {g}")
        self._lbs_cache: Dict[str, LBS] = {}
        self.pose_estimator = PoseEstimator(
            self.cfg, self.smpl, variables=spin_variables, gender=gender,
            fast=fast, spin_int8=spin_int8, device=self.device, mesh=mesh,
        )
        self._writes = self.pose_estimator.mesh is None or _global_rank() == 0

        # The detector comes after the PoseEstimator, which turns TF32 off on
        # the strict path before the detector's first convolution.
        if detector is None:
            detector = build_detector(self.cfg, self.device)
        self.tracker = MultiPersonTracker(
            detector, detection_stride=int(self.cfg.DETECTOR.detection_stride),
            adaptive=bool(self.cfg.DETECTOR.adaptive_stride),
            adaptive_tol=float(self.cfg.DETECTOR.adaptive_tol))

        self.reba = REBAScorer(debug, device=self.device)
        self.rula = RULAScorer(debug, device=self.device)
        scores = score_type.replace(" ", "").upper().split(",")
        self.run_reba = "REBA" in scores
        self.run_rula = "RULA" in scores

        self.debugging = debug
        self.debug_frame = debug_frame
        self.visualize = visualize
        joints = debug_joints.replace(" ", "").split(",")
        if joints == [""]:
            self.debug_joints = None
        else:
            for joint in joints:
                if joint.upper() not in self.smpl.joints_name_upper:
                    raise ValueError(f"Invalid Joint name: {joint}")
            self.debug_joints = joints
        self.validate_rotations = validate_rotations
        self.timings: Dict[str, float] = {}

    def _lbs(self, gender: str) -> LBS:
        """Gender-keyed LBS cache for the debug mesh (the obj export uses
        the CURRENT track's body model under --person_genders)."""
        if gender not in self._lbs_cache:
            self._lbs_cache[gender] = LBS(self.smpl[gender], self.device)
        return self._lbs_cache[gender]

    def __call__(self, input_path: str, info_path: str, output_path: str):
        if self._writes:
            os.makedirs(output_path, exist_ok=True)
        self.timings = {}

        # Shared-instance lifecycle: re-derive the int8 scales per video
        # rather than inherit the previous video's. With an explicit source
        # the scales are a function of that source alone, so no reset.
        if self.cfg.DETECTOR.recalibrate_per_video and not self.cfg.DETECTOR.calibration:
            if hasattr(self.tracker.detector, "reset_calibration"):
                self.tracker.detector.reset_calibration()
            self.pose_estimator.reset_calibration()
        apply_explicit_calibration(self.cfg, self.tracker.detector, self.pose_estimator)

        print("\n===> Data preprocessing...")
        if self.cfg.DATASET.jpeg_ingest:
            t0 = time.time()
            clip = read_video_parallel(input_path, self.cfg.DATASET.decode_workers)
            from poserisk_release_tpu_torch.io.video import jpeg_roundtrip

            # Reference-parity ingest: frames take the '%09d.jpg' disk round
            # trip (funcs_utils.py:42) before detection/cropping.
            # Ranks that write no files take the same pixels in memory.
            tmp = osp.join(output_path, "tmp") if self._writes else None
            clip = jpeg_roundtrip(clip, tmp_path=tmp)
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
            self.timings["decode"] = time.time() - t0

            t0 = time.time()
            print("\n===> Get human tracking results...")
            tracking_results = self.tracker(clip.frames)
            self.timings["track"] = time.time() - t0
        else:
            t0 = time.time()
            print("\n===> Get human tracking results (overlapped with decode)...")
            clip, tracking_results = self._ingest_and_track_overlapped(input_path)
            self.timings["decode+track (overlapped)"] = time.time() - t0

        if self.multi_person:
            # Extension over the reference: score every track surviving the
            # min-frames filter, one output dir each.
            survivors = surviving_tracks(
                tracking_results, clip.num_frames,
                self.cfg.DATASET.min_frame_ratio,
            )
            if not survivors:
                raise ValueError("no person tracks found in the clip")
            summaries = {}
            try:
                for pid, track in survivors.items():
                    person_out = osp.join(output_path, f"person_{pid}")
                    if self._writes:
                        os.makedirs(person_out, exist_ok=True)
                    self.pose_estimator.set_gender(
                        self.person_genders.get(int(pid), self.gender))
                    summaries[pid] = self._process_track(
                        clip, track["bbox"], track["frames"], info_path,
                        person_out
                    )
            finally:
                # A failed track must not leave the shared estimator on ITS
                # gender for the caller's next video.
                self.pose_estimator.set_gender(self.gender)
            return summaries

        bboxes, frames = filter_and_select_target(
            tracking_results, clip.num_frames,
            self.cfg.DATASET.min_frame_ratio,
        )
        return self._process_track(clip, bboxes, frames, info_path, output_path)

    def _ingest_and_track_overlapped(self, input_path: str,
                                     window: int | None = None):
        """Decode windows on a background thread (io.video._window_stream)
        and feed them straight into the tracker, so detection of window k
        runs while window k+1 decodes. Frames are retained for the crop and
        render stages."""
        from poserisk_release_tpu_torch.io.video import VideoClip, _window_stream

        if window is None:
            window = int(self.cfg.DETECTOR.batch_size)
        fps = 0.0
        pieces = []

        def windows():
            nonlocal fps
            for item in _window_stream(input_path, window, None,
                                       self.cfg.DATASET.decode_workers):
                if item[0] == "meta":
                    fps = float(item[1])
                elif item[0] == "window":
                    pieces.append(item[2])
                    yield item[1], item[2]

        gen = iter(windows())
        if getattr(self.tracker.detector, "needs_calibration", False):
            # int8 under windowed ingest: calibrate on the first decoded
            # window, then detect every window, the first included, int8.
            first = next(gen, None)
            if first is not None:
                self.tracker.detector.calibrate(first[1])
                gen = itertools.chain([first], gen)
        tracking_results = self.tracker.track_windows(gen)
        if not pieces:
            raise ValueError(f"video decoded to zero frames: {input_path}")
        clip = VideoClip(frames=np.concatenate(pieces), fps=fps)
        return clip, tracking_results

    def _process_track(self, clip, bboxes, frames, info_path, output_path):
        debug_path = osp.join(output_path, "debug")
        writes = self._writes
        if writes:
            shutil.rmtree(debug_path, ignore_errors=True)
            os.makedirs(debug_path, exist_ok=True)
        timestamp = (0, frames, clip.num_frames)
        # Per-track stage keys start fresh (under --multi_person this runs
        # once per person within one __call__).
        for key in ("pose", "score", "score.device", "score.render"):
            self.timings.pop(key, None)

        t0 = time.time()
        print("\n===> Estimate human pose...")
        result, joint_cam, axis_angles = self.pose_estimator.run_from_frames(
            clip.frames, frames, bboxes
        )
        self.timings["pose"] = time.time() - t0

        if self.validate_rotations:
            validate_rotation_roundtrip(axis_angles)

        # --- single-frame debug branch ------------------------------------
        if self.debugging and self.debug_frame >= 0:
            print(f"\n===> Debug Result at frame #{self.debug_frame}")
            if writes:
                self._visualize_joint_cam_mesh(axis_angles, joint_cam, frames, debug_path)
            print("\n Debug files are saved in : ", debug_path)
            return None

        add_info = load_add_info(self.cfg, info_path)

        pose_str = pose_to_str(result)
        if writes and self.debugging and self.debug_joints is not None:
            save_csv_pose_log(
                pose_str, timestamp, self.debug_joints,
                self.smpl.joints_name_upper, debug_path,
            )

        print("\n===> Post Processing...")
        summary = {}
        t0 = time.time()
        for title, scorer, enabled in (
            ("REBA", self.reba, self.run_reba),
            ("RULA", self.rula, self.run_rula),
        ):
            if not enabled:
                continue
            t1 = time.time()
            results = scorer(result, joint_cam, add_info)
            self.timings["score.device"] = (
                self.timings.get("score.device", 0.0) + time.time() - t1
            )
            final_scores, scores, logs = post_process_scores(
                results, timestamp, output_path, title=title, make_plot=writes
            )
            if writes and self.visualize:
                t1 = time.time()
                render_result_video(
                    clip.frames, bboxes, timestamp, clip.fps,
                    scores, scorer.eval_items, logs, output_path, title=title,
                )
                self.timings["score.render"] = (
                    self.timings.get("score.render", 0.0) + time.time() - t1
                )
            if writes and self.debugging:
                save_score_log_csv(timestamp, scores, scorer.eval_items, logs, debug_path, title)
                save_eval_pose_log_csv(timestamp, scorer.log, debug_path, title)

            action_level, action_name = scorer.action_level(final_scores[4])
            if writes:
                write_result_txt(output_path, title, final_scores, action_level, action_name)
            summary[title] = (final_scores, action_level, action_name)
        self.timings["score"] = time.time() - t0

        if writes:
            with open(osp.join(output_path, "run_summary.json"), "w") as f:
                json.dump(
                    {
                        "frames_total": int(timestamp[2]),
                        "frames_tracked": int(len(frames)),
                        "device": str(self.device),
                        "timings_sec": {k: round(v, 4) for k, v in self.timings.items()},
                        "scores": scores_summary_block(summary),
                    },
                    f,
                    indent=2,
                )

        print("\n\n===> DONE!")
        print("Result files saved in ", output_path)
        print_result_summary(summary)
        return summary

    def _save_debug_mesh(self, axis_angles, frames, output_path) -> int:
        """The obj half of the debug export: the SMPL mesh of the debug
        frame (the current track's gender, vertices in mm) as smpl_model.obj.
        Returns the frame's index in the track."""
        hits = np.flatnonzero(np.asarray(frames) == self.debug_frame)
        if hits.size == 0:
            raise ValueError(
                f"--debug_frame {self.debug_frame} is not among the selected "
                f"track's frames ({len(frames)} tracked frames in "
                f"[{int(np.min(frames))}, {int(np.max(frames))}])"
            )
        idx = int(hits[0])
        pose = axis_angles[idx].reshape(1, -1)
        verts, _ = self._lbs(self.pose_estimator.gender)(pose)
        verts = verts.cpu().numpy().astype(np.float32).reshape(-1, 3) * 1000
        save_obj(verts, self.smpl.face, osp.join(output_path, "smpl_model.obj"))
        return idx

    def _visualize_joint_cam_mesh(self, axis_angles, joint_cam, frames, output_path):
        idx = self._save_debug_mesh(axis_angles, frames, output_path)
        vis_3d_pose(joint_cam[idx], self.smpl.skeleton,
                    osp.join(output_path, "joint_3d.png"), frame=self.debug_frame)
