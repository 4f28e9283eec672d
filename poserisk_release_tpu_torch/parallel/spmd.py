"""The config -> mesh rule, Megatron tensor parallelism of the HMR, and the
HMR with its crop rows split over ``spatial``.

Port of the JAX package's parallel/spmd.py. The JAX package annotates
shardings and lets XLA's partitioner insert the collectives; here each
collective is written where it happens.

Tensor parallelism (``model`` axis), leaf for leaf the JAX rule
(`_tp_leaf_spec`), on the port's HMR state_dict:
  * every backbone conv weight shards its OUTPUT channels -- dim 0 of a
    PyTorch OIHW weight, where JAX shards dim 3 of HWIO;
  * every BN weight / bias / running_mean / running_var shards with its
    conv (num_batches_tracked, which JAX has not, stays whole);
  * fc1 is column-parallel (weight rows and bias), fc2 row-parallel
    (weight columns; bias whole, added once after the all_reduce);
  * the decpose / decshape / deccam heads and init_* stay replicated.
A model axis must divide 64, the stem's channel count.

The forward (TensorParallelHMR, through models/resnet.resnet50_walk):
each conv computes its output-channel shard from the whole input, BN and
ReLU act on the shard, max-pool and the residual add work shard-wise (the
block's output shard lines up with its input's). The channels are all-gathered just before a conv that consumes a
sharded activation, and once more after the global average pool. fc1's
shard output feeds fc2's shard, and one all_reduce sums fc2's partial
products.

The forward is differentiable (train/step.py trains through it). JAX's
partitioner derives the backward of each collective; here each is a
torch.autograd.Function whose backward fits what consumes its output:
  * the channel gather before a conv: the convs that read the gathered
    tensor each hold an output-channel shard, so a rank's gradient of it is
    partial -- the backward sums it over the model axis and keeps this
    rank's channels;
  * the pooled features' gather: the IEF head that reads it is replicated,
    so its gradient is already whole -- the backward keeps this rank's
    slice (a sum would count the head once per rank);
  * fc1's input (Megatron's f): identity forward; fc1 holds an output shard,
    so the input's gradient is partial and the backward all-reduces it;
  * fc2's all_reduce (Megatron's g): identity backward.

The spatial axis (SpatialHMR): every activation's rows are split over
``spatial`` (mesh.row_range) and each conv and the max-pool read their
input window through a hand-written halo exchange (mesh.RowShards), where
JAX pins the crops' height sharding and lets XLA insert the exchanges. It
composes with the data axis (each data rank's frames, rows over its
spatial line), with tp (shards exchanged, then channels gathered) and with
the int8 backbone. It runs only in the estimator's own steps, as JAX
constrains the crops only there: the server's step reads whole rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from poserisk_release_tpu_torch.models.resnet import BN_EPS, conv_bn_names, resnet50_walk
from poserisk_release_tpu_torch.models.spin import NPOSE, ief_head
from poserisk_release_tpu_torch.parallel import collectives
from poserisk_release_tpu_torch.parallel.expert import EXPERT_AXIS
from poserisk_release_tpu_torch.parallel.mesh import SPATIAL_AXIS
from poserisk_release_tpu_torch.parallel.pipeline import STAGE_AXIS

MODEL_AXIS = "model"


def model_axes_from_config(pcfg) -> Dict[str, int]:
    """The configured model-parallel axes (size > 1) of a ParallelConfig,
    in mesh order: stage outermost, then expert, model, spatial."""
    return {
        name: int(size)
        for name, size in ((STAGE_AXIS, pcfg.stage), (EXPERT_AXIS, pcfg.expert),
                           (MODEL_AXIS, pcfg.model), (SPATIAL_AXIS, pcfg.spatial))
        if int(size) > 1
    }


def mesh_shape_from_config(pcfg, world_size: int) -> Optional[Dict[str, int]]:
    """{axis: size} of the mesh a ParallelConfig describes over world_size
    ranks, data outermost, or None for the single-device layout (no model
    axes and a data axis <= 1). The data axis is PARALLEL.num_devices, or
    whatever the model axes leave of the world when that is 0."""
    axes = model_axes_from_config(pcfg)
    n_model = int(np.prod(list(axes.values()))) if axes else 1
    if pcfg.num_devices and pcfg.num_devices > 0:
        dp = int(pcfg.num_devices)
    else:
        dp = max(1, world_size // n_model)
    if not axes and dp <= 1:
        return None
    return {pcfg.data_axis: dp, **axes}


def mesh_from_config(pcfg):
    """The DeviceMesh a ParallelConfig describes over the process group, or
    None for the single-device layout. The mesh must cover the whole group.
    Its device type is CUDA under NCCL and the CPU under gloo (gloo's
    collectives run on the host, whichever device computes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    shape = mesh_shape_from_config(pcfg, world)
    if shape is None:
        return None
    n = int(np.prod(list(shape.values())))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"PARALLEL describes the mesh {shape} ({n} ranks) but this process is in no "
            "process group: run it under torchrun or the CLI's own spawn, or call "
            "parallel.distributed.initialize_distributed first")
    if n != world:
        raise ValueError(f"the mesh {shape} needs {n} ranks; the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def _check_model_size(size: int) -> None:
    if size < 1 or 64 % size:
        raise ValueError(f"the model axis ({size}) must divide 64, the stem's channel count")


def tp_shard_dim(key: str, ndim: int) -> Optional[int]:
    """The state_dict dim that the model axis shards for one entry, or None
    when the entry is replicated (the JAX `_tp_leaf_spec`, transposed to
    PyTorch layouts)."""
    if key.startswith(("conv1.", "bn1.", "layer")):
        return 0 if ndim in (1, 4) else None  # OIHW output channels; BN vectors
    if key.startswith("fc1."):
        return 0  # column-parallel: weight rows (out) and bias
    if key == "fc2.weight":
        return 1  # row-parallel: weight columns (in); the bias stays whole
    return None


def tp_shard_state_dict(state_dict: Dict[str, torch.Tensor], size: int,
                        index: int) -> Dict[str, torch.Tensor]:
    """The model-axis rank `index`'s shard of an HMR state_dict: each
    sharded entry's contiguous index-th of size slices along tp_shard_dim."""
    _check_model_size(size)
    out = {}
    for key, value in state_dict.items():
        dim = tp_shard_dim(key, value.ndim)
        if dim is not None:
            value = value.chunk(size, dim=dim)[index]
        out[key] = value.clone()
    return out


def tp_gather_state_dict(shard: Dict[str, torch.Tensor], size: int,
                         group) -> Dict[str, torch.Tensor]:
    """The inverse of tp_shard_state_dict on every rank of the model axis
    (a collective: every rank calls it): each sharded entry all-gathered
    along tp_shard_dim in rank order, the replicated ones as they are."""
    _check_model_size(size)
    out = {}
    for key, value in shard.items():
        dim = tp_shard_dim(key, value.ndim)
        value = value.detach()
        if dim is not None:
            rows = collectives.all_gather_rows(value.movedim(dim, 0).contiguous(), group)
            value = rows.movedim(0, dim)
        out[key] = value.contiguous()
    return out


def _gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """(B, C/T, H, W) channel shards -> (B, C, H, W), channels in rank
    order, channels_last in memory like the convs' own outputs."""
    shards = collectives.all_gather_rows(x.permute(0, 2, 3, 1).contiguous()[None], group)
    T, B, H, W, c = shards.shape
    full = shards.permute(1, 2, 3, 0, 4).reshape(B, H, W, T * c)
    return full.permute(0, 3, 1, 2)


class _GatherChannels(torch.autograd.Function):
    """_gather_channels; backward: sum over the model axis, this rank's
    channels (the gathered tensor feeds output-channel-sharded convs)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size, ctx.index = group, size, index
        return _gather_channels(x, group)

    @staticmethod
    def backward(ctx, grad):
        whole = collectives.all_reduce_sum(grad, ctx.group)
        return whole.chunk(ctx.size, dim=1)[ctx.index], None, None, None


class _GatherFeatures(torch.autograd.Function):
    """(B, C/T) pooled-feature shards -> (B, C); backward: this rank's
    slice of the (already whole) gradient of the replicated head's input."""

    @staticmethod
    def forward(ctx, xf, group, size, index):
        ctx.size, ctx.index = size, index
        return collectives.all_gather_rows(xf.t().contiguous(), group).t()

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=1)[ctx.index], None, None, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f before a column-parallel layer: identity; backward: the
    all-reduce of the partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g after a row-parallel layer: the all-reduce of the
    partial products; backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallelHMR:
    """This rank's shard of the HMR and its forward (see the module
    docstring): crops_nhwc (B, S, S, 3) -> (rotmat, betas, camera), every
    output whole on every rank of the model axis.

    state_dict: the whole HMR state_dict (host); only this rank's shard is
    kept, on `device`. backbone_dtype: bfloat16 for the fast path (the
    backbone shards are stored and computed in it, as HMR.cast_backbone);
    the IEF head always runs in float32."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], group, size: int, index: int,
                 n_iter: int, device, backbone_dtype: torch.dtype = torch.float32):
        self.group, self.n_iter = group, int(n_iter)
        self.size, self.index = int(size), int(index)
        shard = tp_shard_state_dict(state_dict, size, index)
        self.tensors: Dict[str, torch.Tensor] = {}
        for key, value in shard.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key.startswith(("conv1.", "bn1.", "layer")):
                value = value.to(backbone_dtype)
                if value.ndim == 4:
                    value = value.to(memory_format=torch.channels_last)
            self.tensors[key] = value.to(device)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherChannels.apply(x, self.group, self.size, self.index)

    def _conv_bn(self, name: str, x, stride: int, padding):
        """resnet50_walk's conv: this rank's output-channel shard of the
        named conv and its BN."""
        t = self.tensors
        conv, bn = conv_bn_names(name)
        y = F.conv2d(x, t[conv + ".weight"], stride=stride, padding=padding)
        return F.batch_norm(y, t[bn + ".running_mean"], t[bn + ".running_var"],
                            t[bn + ".weight"], t[bn + ".bias"], False, 0.0, BN_EPS)

    def features(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """NCHW crops -> (B, 2048) pooled f32 features, whole. rows: the
        spatial axis's RowShards, when the crop rows are split too."""
        x = x.to(self.tensors["conv1.weight"].dtype)
        xf = resnet50_walk(x, self._conv_bn, rows=rows, gather=self._gather, width=self.size)
        return _GatherFeatures.apply(xf, self.group, self.size, self.index)

    def _dense(self, name: str, t: torch.Tensor) -> torch.Tensor:
        w = self.tensors[name + ".weight"]
        if name == "fc2":  # row-parallel: partial products, one all_reduce
            return _ReduceFromModel.apply(t @ w.t(), self.group) + self.tensors["fc2.bias"]
        if name == "fc1":  # column-parallel on a replicated input
            t = _CopyToModel.apply(t, self.group)
        return F.linear(t, w, self.tensors[name + ".bias"])

    def head(self, xf: torch.Tensor):
        """The IEF head (replicated heads, tp fc1/fc2) on whole pooled
        features: (rotmat, betas, camera), whole on every rank."""
        B = xf.shape[0]
        t = self.tensors
        return ief_head(self._dense, xf, t["init_pose"].expand(B, NPOSE),
                        t["init_shape"].expand(B, 10), t["init_cam"].expand(B, 3), self.n_iter)

    def __call__(self, crops_nhwc: torch.Tensor, rows=None):
        return self.head(self.features(crops_nhwc.permute(0, 3, 1, 2), rows))


class SpatialHMR:
    """The HMR forward with the crop rows split over ``spatial`` (the
    estimator's spin_forward under sp): crops_nhwc (B, S, S, 3), the whole
    crops of this data rank's frames on every spatial rank -> (rotmat,
    betas, camera), whole and the same on every spatial rank.

    The backbone is resnet50_walk over this rank's rows (mesh.RowShards):
    the stem takes its window from the whole crops, every later conv and
    the max-pool read theirs through a halo exchange, and the pooled
    features are the row sums summed over the axis. The IEF head runs
    replicated on the whole pooled features. One walk serves the three
    backbones: `model` is the HMR module (its convs), a TensorParallelHMR
    (tp x sp: its shards, the channel gathers composed with the row
    exchanges), or the HMR module with `quant_backbone`, the prepared
    folded / int8 backbone (models/resnet_int8), which computes in the
    crops' dtype. Inference only: training runs no spatial axis."""

    def __init__(self, model, rows, quant_backbone: Optional[Dict] = None):
        self.model, self.rows, self.quant_backbone = model, rows, quant_backbone

    def __call__(self, crops_nhwc: torch.Tensor):
        if isinstance(self.model, TensorParallelHMR):
            return self.model(crops_nhwc, self.rows)
        if self.quant_backbone is not None:
            from poserisk_release_tpu_torch.models.resnet_int8 import resnet50_forward

            xf = resnet50_forward(self.quant_backbone, crops_nhwc, crops_nhwc.dtype,
                                  rows=self.rows)
        else:
            x = crops_nhwc.permute(0, 3, 1, 2).to(self.model.conv1.weight.dtype)
            xf = resnet50_walk(x, self.model.conv_bn, rows=self.rows)
        return self.model.head(xf)

