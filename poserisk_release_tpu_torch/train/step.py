"""End-to-end SPIN fine-tuning step, on one device or over a mesh.

Port of the JAX package's train/step.py. One step: the HMR forward (the
whole ResNet-50 backbone optionally rematerialised as ONE segment, as the
JAX package's nn.remat wraps it), SMPL joints from the predicted rotation
MATRICES (ops/lbs.joints_only_from_rotmats: the rotmat -> axis-angle ->
rotmat round trip has arccos/sqrt singularities whose gradient NaNs the step
near theta ~ 0 or pi), root-centred, the masked-L1 coord_loss, backward,
and an optimizer update with optax's rules (train/optim.py).

What JAX's step does implicitly, the port does explicitly:
  * BatchNorm is frozen: JAX applies the model without `mutable`, so BN
    uses its running statistics and never updates them, while BN scale and
    bias train as parameters. The port's HMR stays in eval() mode (the
    tensor-parallel forward calls F.batch_norm(training=False)); every
    entry of the JAX `params` collection -- convs, BN scales and biases,
    the heads and the init_pose / init_shape / init_cam state -- takes a
    gradient; the running statistics (JAX's batch_stats) take none.
  * f32 with TF32 off on the card (the estimator's strict setting): JAX
    trains in f32.

Under a mesh (a DeviceMesh, one process per rank over torch.distributed),
the two axes the JAX TrainState.create knows:
  * ``data``: each data rank takes its contiguous rows of the batch (a
    batch the axis does not divide raises ValueError); before the update
    the gradients (and the loss) are averaged over the axis in ONE
    all-reduce (parallel/collectives.py), where XLA inserts it in JAX;
  * ``model``: the HMR is Megatron-sharded as parallel/spmd.py shards it
    for inference (tp_shard_state_dict), through its differentiable
    forward; the optimizer's moments are built on the shards, so they
    take the same shards.
Any other axis is what JAX's create makes of it: parameters replicated
over it and the batch not split along it, so its ranks compute the same
step.

>>> state = TrainState.create(cfg, smpl_family, device="cuda")
>>> state, loss = state.step(crops, target_joints)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from poserisk_release_tpu_torch.ops.lbs import joints_only_from_rotmats
from poserisk_release_tpu_torch.parallel import collectives
from poserisk_release_tpu_torch.parallel import mesh as pmesh
from poserisk_release_tpu_torch.train.losses import coord_loss
from poserisk_release_tpu_torch.train.optim import get_optimizer

# The state_dict entries of JAX's batch_stats collection (and the counter
# torch's BatchNorm adds): the only ones that take no gradient.
_FROZEN = ("running_mean", "running_var", "num_batches_tracked")


def model_tensors(model) -> Dict[str, torch.Tensor]:
    """Every tensor of the HMR (an nn.Module's parameters and buffers) or
    of its tensor-parallel shard (spmd.TensorParallelHMR), by state_dict
    key, as live tensors (not copies)."""
    if isinstance(model, torch.nn.Module):
        return {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return model.tensors


def trainable_tensors(model) -> Dict[str, torch.Tensor]:
    """The tensors JAX trains (its `params` collection): all but BN's
    running statistics."""
    return {k: v for k, v in model_tensors(model).items() if not k.endswith(_FROZEN)}


def _compute_context(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=compute_dtype)


def _average_over_data(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                       group, n: int) -> torch.Tensor:
    """Average every gradient of the optimizer's tensors, and the loss, over
    the data axis in one all-reduce; returns the averaged loss."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
    flat = collectives.all_reduce_sum(flat, group) / n
    offset = 0
    for p in params:
        size = p.numel()
        p.grad.copy_(flat[offset:offset + size].view(p.shape))
        offset += size
    return flat[-1]


def make_train_step(n_iter: int, parents: Tuple[int, ...], optimizer: torch.optim.Optimizer,
                    remat: bool = True, compute_dtype: torch.dtype = torch.float32,
                    data_group=None) -> Callable:
    """step(model, smpl_params, crops (B, S, S, 3), target_joints (B, 24, 3),
    joint_valid=None) -> the loss (a 0-d tensor, averaged over the data
    axis). One forward, backward and update of `optimizer`, which holds the
    model's trainable tensors and updates them in place. model: the HMR in
    eval() mode or a TensorParallelHMR (both give features / head), built
    with n_iter IEF iterations (JAX's signature; a mismatch raises).
    data_group: the data axis's process group when it is wider than 1."""
    n_data = 1 if data_group is None else torch.distributed.get_world_size(data_group)

    def loss_fn(model, smpl_params, crops, target_joints, joint_valid):
        if model.n_iter != n_iter:
            raise ValueError(f"the model runs {model.n_iter} IEF iterations, the step {n_iter}")
        x = crops.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        with _compute_context(x.device, compute_dtype):
            xf = (checkpoint(model.features, x, use_reentrant=False) if remat
                  else model.features(x))
        rotmat, _betas, _cam = model.head(xf.float())
        joints = joints_only_from_rotmats(smpl_params, rotmat, parents)
        joints = joints - joints[:, :1]  # root-centred, like the eval path
        return coord_loss(joints, target_joints, joint_valid)

    def step(model, smpl_params, crops, target_joints, joint_valid=None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, smpl_params, crops, target_joints, joint_valid)
        loss.backward()
        loss = loss.detach()
        if n_data > 1:
            loss = _average_over_data(optimizer, loss, data_group, n_data)
        optimizer.step()
        return loss

    return step


@dataclass
class TrainState:
    """Training harness around make_train_step: the model (HMR or its tp
    shard) on `device`, its optimizer, the SMPL tables and the mesh. step()
    updates the tensors in place and returns the state itself."""

    model: Any
    optimizer: torch.optim.Optimizer
    smpl_params: Dict[str, torch.Tensor]
    mesh: Any
    device: torch.device
    _step: Callable

    @classmethod
    def create(cls, cfg, smpl_family, variables: Optional[Dict[str, torch.Tensor]] = None,
               optimizer_name: str = "adam", lr: float = 1e-4, gender: str = "neutral",
               remat: bool = True, mesh=None, device=None) -> "TrainState":
        """variables: an HMR state_dict, as PoseEstimator takes it
        (models.convert.flax_to_state_dict turns a JAX tree into one); None
        resolves them as the estimator does. mesh: a DeviceMesh this rank
        belongs to, or None for one device. device: CUDA unless the caller
        names the CPU (device.resolve_device: raises without CUDA)."""
        from poserisk_release_tpu_torch.parallel import spmd
        from poserisk_release_tpu_torch.pipeline import PoseEstimator

        # The estimator is built single-device: this class lays the model
        # out over the mesh itself, with JAX's two axes.
        single = cfg.replace(PARALLEL={"num_devices": 1, "model": 1, "spatial": 1,
                                       "stage": 1, "expert": 1})
        est = PoseEstimator(single, smpl_family, variables=variables, gender=gender,
                            device=device)
        model = est.model
        if spmd.MODEL_AXIS in pmesh.axis_names(mesh):
            model = spmd.TensorParallelHMR(
                model.state_dict(), pmesh.axis_group(mesh, spmd.MODEL_AXIS),
                pmesh.axis_size(mesh, spmd.MODEL_AXIS),
                pmesh.axis_index(mesh, spmd.MODEL_AXIS), cfg.SPIN.ief_iters, est.device)
        trainables = trainable_tensors(model)
        for t in trainables.values():
            t.requires_grad_(True)
        optimizer = get_optimizer(optimizer_name, lr)(list(trainables.values()))
        data_group = None
        if pmesh.axis_size(mesh, pmesh.DATA_AXIS) > 1:
            data_group = pmesh.axis_group(mesh, pmesh.DATA_AXIS)
        step = make_train_step(cfg.SPIN.ief_iters, est.parents, optimizer, remat=remat,
                               data_group=data_group)
        return cls(model=model, optimizer=optimizer, smpl_params=est.smpl_params, mesh=mesh,
                   device=est.device, _step=step)

    def step(self, crops, target_joints, joint_valid=None) -> Tuple["TrainState", float]:
        """One training step on the global batch (every rank passes the
        same one; each data rank takes its rows). Returns (self, loss)."""
        def put(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        crops, target = put(crops), put(target_joints)
        valid = None
        if joint_valid is not None:
            # A mask with a batch axis is split like the batch; a broadcast
            # mask without one applies to every row as it is.
            valid = put(joint_valid)
            if valid.ndim == target.ndim:
                valid = pmesh.shard_rows(valid, self.mesh)
        loss = self._step(self.model, self.smpl_params, pmesh.shard_rows(crops, self.mesh),
                          pmesh.shard_rows(target, self.mesh), valid)
        return self, float(loss)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole HMR state_dict (under tp the shards gathered back whole
        over the model axis: every rank of it calls this together)."""
        from poserisk_release_tpu_torch.parallel import spmd

        if isinstance(self.model, spmd.TensorParallelHMR):
            whole = spmd.tp_gather_state_dict(self.model.tensors, self.model.size,
                                              self.model.group)
            # The shard drops BN's counters; HMR.load_state_dict wants them.
            for key in [k for k in whole if k.endswith(".running_mean")]:
                whole[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
            return whole
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def variables(self) -> Dict:
        """The trained weights in the JAX package's Flax tree layout
        ({'params', 'batch_stats'}, numpy f32), which its PoseEstimator(
        variables=...) takes unchanged."""
        from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax

        return spin_state_dict_to_flax(self.state_dict())

    @property
    def param_bytes(self) -> int:
        """Bytes of the SPIN weights this rank holds (the whole HMR or its
        tp shard)."""
        return sum(t.numel() * t.element_size() for t in model_tensors(self.model).values())
