"""Pipeline parallelism: the HMR forward as a microbatched GPipe over ``stage``.

Port of the JAX package's parallel/pipeline.py. ResNet-50's 16 bottleneck
blocks (the stem on stage 0, the IEF head on the last stage) are split into
S contiguous stages; balanced_split picks the split that minimises the
largest stage's parameter bytes, the same split as the JAX function for
the same weights, because the point of pipeline parallelism is the memory:
each stage rank holds only its stage's entries of the HMR state_dict
(stage_param_entries), about total / S.

Each stage is a PipelineStage built from the port's own stem and Bottleneck
classes under the HMR's module names, so its slice of the state_dict loads
unchanged and a stage computes exactly what those modules of the HMR do.

Schedule (GPipe): S + M - 1 ticks over M microbatches; at tick t stage s
runs microbatch t - s (the other ticks are its bubble). The activation goes
from stage s to s + 1 at its real shape and type by batch_isend_irecv (the
JAX package carries one flat max-size f32 buffer through `ppermute`
instead). The last stage's outputs are broadcast over the stage group (JAX:
a masked psum), so every stage rank ends with the whole result.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from poserisk_release_tpu_torch.models.resnet import BN_EPS, LAYERS, PLANES, Bottleneck
from poserisk_release_tpu_torch.models.spin import NPOSE, ief_head
from poserisk_release_tpu_torch.parallel import collectives

STAGE_AXIS = "stage"
# The 16 bottleneck blocks in execution order as (layer, block) pairs.
_BLOCKS: Tuple[Tuple[int, int], ...] = tuple(
    (L, i) for L, n in enumerate(LAYERS, start=1) for i in range(n))
# The 4-stage layer-boundary split (stem+layer1 | layer2 | layer3 | layer4+head).
LAYER_SPLIT: Tuple[int, ...] = (0, 3, 7, 13, 16)
# flattened (rotmat 24*9, betas 10, cam 3) per sample
_OUT_F = 24 * 9 + 10 + 3


def _block_geometry(hw: int) -> List[Tuple[int, int, int]]:
    """Input (H, W, C) of each of the 16 blocks for square hw-pixel crops,
    plus the final feature-map shape at index 16 (hw % 32 == 0)."""
    shapes = []
    h, c = hw // 4, 64  # after stem (/2) + maxpool (/2)
    for L, i in _BLOCKS:
        shapes.append((h, h, c))
        if L > 1 and i == 0:
            h //= 2
        c = PLANES[L - 1] * 4
    shapes.append((h, h, c))
    return shapes


def stage_input_shape(hw: int, b0: int) -> Tuple[int, int, int]:
    """Input (H, W, C) of the stage whose first block is b0 (b0 == 0 means
    the stage starts at the raw crops, before the stem)."""
    if b0 == 0:
        return (hw, hw, 3)
    return _block_geometry(hw)[b0]


def hmr_stage_shapes(hw: int) -> Tuple[Tuple[int, int, int], ...]:
    """Per-stage input (H, W, C) for LAYER_SPLIT."""
    return tuple(stage_input_shape(hw, b0) for b0 in LAYER_SPLIT[:-1])


def _entry_stage(key: str, split: Sequence[int]) -> int:
    """The stage owning one state_dict entry: the stem's to stage 0, a
    block's to the stage holding the block, the IEF head's and the init_*
    state's to the last stage."""
    n_stages = len(split) - 1
    module = key.split(".")[0]
    if module in ("conv1", "bn1"):
        return 0
    if module.startswith("layer"):
        b = _BLOCKS.index((int(module[len("layer"):]), int(key.split(".")[1])))
        for s in range(n_stages):
            if split[s] <= b < split[s + 1]:
                return s
        raise ValueError(f"block {b} outside split {split}")
    return n_stages - 1


def _counted(key: str) -> bool:
    # num_batches_tracked is PyTorch's BN bookkeeping; the JAX tree has no
    # such leaf, and it takes no part in the forward.
    return not key.endswith("num_batches_tracked")


def balanced_split(state_dict: Dict[str, torch.Tensor], n_stages: int) -> Tuple[int, ...]:
    """The block split minimising the LARGEST stage's parameter bytes, by
    exhaustive search over the C(15, S-1) boundary placements (the first
    minimum in the JAX function's order). Stem bytes are pinned to stage 0,
    head bytes to the last stage."""
    if not 2 <= n_stages <= len(_BLOCKS):
        raise ValueError(f"n_stages must be in [2, {len(_BLOCKS)}], got {n_stages}")
    block_bytes = [0] * len(_BLOCKS)
    stem_bytes = head_bytes = 0
    for key, value in state_dict.items():
        if not _counted(key):
            continue
        nbytes = value.numel() * value.element_size()
        module = key.split(".")[0]
        if module in ("conv1", "bn1"):
            stem_bytes += nbytes
        elif module.startswith("layer"):
            block_bytes[_BLOCKS.index((int(module[len("layer"):]), int(key.split(".")[1])))] += nbytes
        else:
            head_bytes += nbytes

    best, best_cost = None, None
    for cuts in itertools.combinations(range(1, len(_BLOCKS)), n_stages - 1):
        split = (0, *cuts, len(_BLOCKS))
        sizes = [sum(block_bytes[split[s]:split[s + 1]]) for s in range(n_stages)]
        sizes[0] += stem_bytes
        sizes[-1] += head_bytes
        cost = max(sizes)
        if best_cost is None or cost < best_cost:
            best, best_cost = split, cost
    return best


def stage_param_entries(state_dict: Dict[str, torch.Tensor],
                        split: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """Per stage, its entries of the state_dict in state_dict order: the
    stage's slice, the only weights its rank ever holds."""
    entries: List[Dict[str, torch.Tensor]] = [{} for _ in range(len(split) - 1)]
    for key, value in state_dict.items():
        entries[_entry_stage(key, split)][key] = value
    return entries


class PipelineStage(nn.Module):
    """Blocks [b0, b1) of the backbone (stage 0 also runs the stem; the
    last stage also pools and runs the IEF head), under the HMR's module
    names so the stage's state_dict entries load unchanged.

    forward(x_nhwc): the stage input, NHWC (crops on stage 0) -> the next
    stage's input, NHWC in the backbone's dtype; the last stage returns
    (rotmat (B, 24, 3, 3), betas (B, 10), camera (B, 3)) in float32."""

    def __init__(self, b0: int, b1: int, last: bool, n_iter: int = 3):
        super().__init__()
        self.b0, self.b1, self.last, self.n_iter = b0, b1, last, n_iter
        if b0 == 0:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        for b in range(b0, b1):
            L, i = _BLOCKS[b]
            planes = PLANES[L - 1]
            inplanes = planes * 4 if i else (64 if L == 1 else PLANES[L - 2] * 4)
            stride = 2 if (L > 1 and i == 0) else 1
            downsample = None if i else nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4, eps=BN_EPS))
            if not hasattr(self, f"layer{L}"):
                self.add_module(f"layer{L}", nn.Sequential())
            getattr(self, f"layer{L}").add_module(str(i), Bottleneck(inplanes, planes, stride,
                                                                     downsample))
        if last:
            self.fc1 = nn.Linear(512 * 4 + NPOSE + 13, 1024)
            self.fc2 = nn.Linear(1024, 1024)
            self.decpose = nn.Linear(1024, NPOSE)
            self.decshape = nn.Linear(1024, 10)
            self.deccam = nn.Linear(1024, 3)
            for key, n in (("init_pose", NPOSE), ("init_shape", 10), ("init_cam", 3)):
                self.register_buffer(key, torch.zeros(1, n))

    def backbone_modules(self):
        return [m for name, m in self.named_children()
                if name in ("conv1", "bn1") or name.startswith("layer")]

    def cast_backbone(self, dtype: torch.dtype) -> "PipelineStage":
        for module in self.backbone_modules():
            module.to(dtype)
        return self

    def forward(self, x_nhwc: torch.Tensor):
        x = x_nhwc.permute(0, 3, 1, 2)
        if self.b0 == 0:
            x = x.to(self.conv1.weight.dtype)
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for name, layer in self.named_children():
            if name.startswith("layer"):
                x = layer(x)
        if not self.last:
            return x.permute(0, 2, 3, 1)
        xf = x.float().mean(dim=(2, 3))
        B = xf.shape[0]
        return ief_head(lambda name, t: getattr(self, name)(t), xf,
                        self.init_pose.expand(B, NPOSE), self.init_shape.expand(B, 10),
                        self.init_cam.expand(B, 3), self.n_iter)


class PipelineHMR:
    """This rank's stage of the pipelined HMR and the GPipe schedule.

    entries: this stage's state_dict entries (stage_param_entries), the
    only weights placed on `device`. group: the stage group (this rank's
    line along ``stage``; its group rank is the stage index).
    call(crops): crops (B, S, S, 3) -> (rotmat, betas, camera) of the
    whole batch on every stage rank. Only stage 0 reads the pixels; later
    stages read only B = crops.shape[0] (the estimator hands them an empty
    (B, 0) tensor and crops nothing there)."""

    def __init__(self, entries: Dict[str, torch.Tensor], split: Sequence[int], group,
                 stage: int, microbatches: int, hw: int, n_iter: int, device,
                 backbone_dtype: torch.dtype = torch.float32):
        import torch.distributed as dist

        self.split, self.group = tuple(split), group
        self.S, self.s, self.M = len(split) - 1, int(stage), int(microbatches)
        self.hw, self.device = int(hw), device
        self.ranks = dist.get_process_group_ranks(group)
        module = PipelineStage(split[stage], split[stage + 1], stage == self.S - 1, n_iter)
        module.load_state_dict(entries, strict=True)
        module.eval()
        module.cast_backbone(backbone_dtype)
        self.module = module.to(device, memory_format=torch.channels_last)
        self.act_dtype = backbone_dtype

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.module.state_dict().values())

    def __call__(self, crops: torch.Tensor):
        S, s, M = self.S, self.s, self.M
        batch = crops.shape[0]
        if batch % M:
            raise ValueError(f"the anchor batch ({batch}) does not split into {M} microbatches; "
                             "production_chunk guarantees it for the chunked paths")
        m = batch // M
        in_shape = (m, *stage_input_shape(self.hw, self.split[s]))
        outs, pending = [], []
        for t in range(S + M - 1):
            j = t - s  # this stage's microbatch at tick t
            if not 0 <= j < M:
                continue  # bubble
            if s == 0:
                x = crops[j * m:(j + 1) * m]
            else:
                x = collectives.recv(in_shape, self.act_dtype, self.device, self.ranks[s - 1],
                                     self.group)
            y = self.module(x)
            if s < S - 1:
                pending.append(collectives.send(y, self.ranks[s + 1], self.group))
            else:
                rotmat, betas, cam = y
                outs.append(torch.cat([rotmat.reshape(m, -1), betas, cam], dim=1))
        collectives.wait(pending)
        if s == S - 1:
            out = torch.cat(outs)
        else:
            out = torch.empty((batch, _OUT_F), dtype=torch.float32, device=self.device)
        out = collectives.broadcast(out, self.ranks[S - 1], self.group)
        return (out[:, :24 * 9].reshape(batch, 24, 3, 3), out[:, 24 * 9:24 * 9 + 10],
                out[:, -3:])
