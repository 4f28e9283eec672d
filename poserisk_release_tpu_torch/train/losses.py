"""Mesh and coordinate training losses (reference lib/core/loss.py).

Port of the JAX package's train/losses.py, on tensors, each differentiable
through autograd:

  * coord_loss          -- masked L1 (CoordLoss, loss.py:10-23)
  * laplacian_loss      -- uniform-weight mesh Laplacian smoothness
                           (LaplacianLoss, loss.py:25-58) as a sparse
                           neighbour-mean gather instead of the dense
                           6890^2 matmul (the same row-normalised Laplacian)
  * normal_vector_loss  -- GT-face-normal alignment (loss.py:61-87)
  * edge_length_loss    -- per-edge length L1 (loss.py:90-113)

build_laplacian_neighbors is host numpy, copied.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch


def coord_loss(pred, target, target_valid=None) -> torch.Tensor:
    """Mean L1; optional validity mask multiplies both sides (reference
    semantics: masked entries contribute zero but still count in the mean)."""
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target, device=pred.device)
    if target_valid is not None:
        target_valid = torch.as_tensor(target_valid, device=pred.device)
        pred = pred * target_valid
        target = target * target_valid
    return torch.mean(torch.abs(pred - target))


def build_laplacian_neighbors(faces: np.ndarray, num_verts: int,
                              max_degree: int | None = None):
    """Static neighbour table (V, max_degree) + degree (V,) from triangle faces.

    Row-normalised uniform Laplacian: L x = x - mean(neighbours). Equivalent
    to the reference's dense matrix (laplacian[i]/degree_i) without the
    6890 x 6890 matmul. max_degree defaults to the mesh's actual maximum
    valence (so the equivalence is unconditional); an explicit value that
    would TRUNCATE a neighbour list raises instead of silently computing a
    wrong Laplacian.
    """
    neighbors = [[] for _ in range(num_verts)]
    for a, b, c in np.asarray(faces, np.int64):
        for u, v in ((a, b), (b, c), (c, a)):
            if v not in neighbors[u]:
                neighbors[u].append(v)
            if u not in neighbors[v]:
                neighbors[v].append(u)
    actual_max = max((len(n) for n in neighbors), default=0)
    if max_degree is None:
        max_degree = max(actual_max, 1)
    elif actual_max > max_degree:
        raise ValueError(
            f"max_degree={max_degree} would truncate a vertex with "
            f"{actual_max} neighbours; pass max_degree>={actual_max} or None")
    degree = np.array([max(len(n), 1) for n in neighbors], np.int32)
    table = np.zeros((num_verts, max_degree), np.int32)
    mask = np.zeros((num_verts, max_degree), np.float32)
    for i, n in enumerate(neighbors):
        table[i, : len(n)] = n
        mask[i, : len(n)] = 1.0
    return table, mask, degree


def laplacian_loss(verts: torch.Tensor, neighbor_table, neighbor_mask,
                   average: bool = False) -> torch.Tensor:
    """verts: (B, V, 3). Sum over coords of squared Laplacian per vertex,
    then mean (or sum/B with average=True) -- reference loss.py:48-58."""
    table = torch.as_tensor(np.asarray(neighbor_table), dtype=torch.long, device=verts.device)
    mask = torch.as_tensor(neighbor_mask, dtype=verts.dtype, device=verts.device)
    gathered = verts[:, table, :]  # (B, V, D, 3)
    neigh_sum = torch.sum(gathered * mask[None, :, :, None], dim=2)
    degree = torch.sum(mask, dim=1)[None, :, None]
    lap = verts - neigh_sum / torch.clamp(degree, min=1.0)
    per_vertex = torch.sum(lap ** 2, dim=2)  # (B, V)
    if average:
        return torch.sum(per_vertex) / verts.shape[0]
    return torch.mean(per_vertex)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _faces(faces, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)


def normal_vector_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor, faces) -> torch.Tensor:
    faces = _faces(faces, coord_out.device)
    v1o = _normalize(coord_out[:, faces[:, 1]] - coord_out[:, faces[:, 0]])
    v2o = _normalize(coord_out[:, faces[:, 2]] - coord_out[:, faces[:, 0]])
    v3o = _normalize(coord_out[:, faces[:, 2]] - coord_out[:, faces[:, 1]])

    v1g = _normalize(coord_gt[:, faces[:, 1]] - coord_gt[:, faces[:, 0]])
    v2g = _normalize(coord_gt[:, faces[:, 2]] - coord_gt[:, faces[:, 0]])
    normal_gt = _normalize(torch.cross(v1g, v2g, dim=-1))

    cos1 = torch.abs(torch.sum(v1o * normal_gt, dim=2))
    cos2 = torch.abs(torch.sum(v2o * normal_gt, dim=2))
    cos3 = torch.abs(torch.sum(v3o * normal_gt, dim=2))
    return torch.mean(torch.stack([cos1, cos2, cos3], dim=1))


def edge_length_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor, faces) -> torch.Tensor:
    faces = _faces(faces, coord_out.device)

    def edges(coord):
        d1 = torch.linalg.norm(coord[:, faces[:, 0]] - coord[:, faces[:, 1]], dim=2)
        d2 = torch.linalg.norm(coord[:, faces[:, 0]] - coord[:, faces[:, 2]], dim=2)
        d3 = torch.linalg.norm(coord[:, faces[:, 1]] - coord[:, faces[:, 2]], dim=2)
        return d1, d2, d3

    diffs = [torch.abs(a - b) for a, b in zip(edges(coord_out), edges(coord_gt))]
    return torch.mean(torch.stack(diffs, dim=1))


def get_loss(faces: np.ndarray) -> Tuple:
    """Factory mirroring the reference get_loss tuple (loss.py:116-118):
    (coord, normal, edge, coord, coord) as partial-applied callables."""
    return (
        coord_loss,
        partial(normal_vector_loss, faces=faces),
        partial(edge_length_loss, faces=faces),
        coord_loss,
        coord_loss,
    )
