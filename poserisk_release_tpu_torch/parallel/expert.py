"""Expert parallelism: the gendered SMPL body models as experts over ``expert``.

Port of the JAX package's parallel/expert.py. The reference keeps all three
gendered SMPL layers resident and picks one per run; here they are experts,
one per rank of the ``expert`` axis (slots in GENDERS order, padded with
the neutral model up to the axis size; pad slots are never routed to), so
each rank holds only its own expert's tables and switching a track's
gender (PoseEstimator.set_gender) swaps one routing scalar.

Routing is dense dispatch, the pattern for tiny expert counts: every expert
rank computes joints for the whole data shard with its own tables, zeroes
the frames routed elsewhere, and one all_reduce over the expert group sums
them. The joints are a negligible part of the pose step, so sparse
dispatch's all-to-all would cost more than the masked compute it saves.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from poserisk_release_tpu_torch.ops.lbs import joints_only_from_rotmats, smpl_params_to_torch
from poserisk_release_tpu_torch.parallel import collectives

EXPERT_AXIS = "expert"
GENDERS = ("neutral", "male", "female")


def stack_expert_trees(trees: Sequence[Dict[str, torch.Tensor]],
                       n_experts: int) -> Dict[str, torch.Tensor]:
    """Stack homogeneous expert parameter dicts along a new leading expert
    axis of n_experts slots, padding with tree 0."""
    if n_experts < len(trees):
        raise ValueError(f"expert axis {n_experts} < {len(trees)} experts")
    trees = list(trees) + [trees[0]] * (n_experts - len(trees))
    return {key: torch.stack([t[key] for t in trees]) for key in trees[0]}


def stack_gender_experts(family, n_experts: int) -> Dict[str, torch.Tensor]:
    """The family's gendered SMPL tables (an SMPLFamily, indexed by gender)
    stacked as experts on the host, slot order GENDERS, neutral-padded."""
    return stack_expert_trees([smpl_params_to_torch(family[g], "cpu") for g in GENDERS],
                              n_experts)


def make_expert_joints(parents: Tuple[int, ...], group, expert_index: int):
    """fn(local_params, rotmats (B, 24, 3, 3), gender_ids (B,)) -> (B, 24, 3)
    m, where local_params are this rank's expert's SMPL tables and
    gender_ids index GENDERS: the expert's joints for the frames routed to
    it, the other experts' for the rest (one all_reduce over the group)."""

    def routed(local_params, rotmats, gender_ids):
        joints = joints_only_from_rotmats(local_params, rotmats, parents)
        mask = (gender_ids == expert_index).to(joints.dtype)
        return collectives.all_reduce_sum(joints * mask[:, None, None], group)

    return routed
