"""The data axis: a chunk's frames split contiguously over the data ranks.

Port of the JAX package's parallel/mesh.py. JAX shards the frame axis with
``P('data')`` and fetches the global array back; here every rank holds the
whole host chunk, takes its own contiguous rows (shard_rows), computes them,
and all-gathers the outputs (gather_rows) so every rank holds the whole
chunk again. A mesh is a DeviceMesh (spmd.mesh_from_config) or None, the
single-device layout; the helpers below read it through axis_size /
axis_index / axis_group so that a mesh without an axis means size 1.
"""

from __future__ import annotations

import numpy as np
import torch

from poserisk_release_tpu_torch.parallel import collectives

DATA_AXIS = "data"


def axis_names(mesh) -> tuple:
    return () if mesh is None else tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    """Size of the named mesh dim; 1 when the mesh (or the dim) is absent."""
    names = axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the named dim (0 when absent)."""
    return int(mesh.get_local_rank(name)) if name in axis_names(mesh) else 0


def axis_group(mesh, name: str):
    """The process group of this rank's line along the named dim."""
    return mesh.get_group(name)


def pad_to_multiple(x, multiple: int) -> tuple:
    """Pad dim 0 up to a multiple by repeating the last row; returns
    (padded, n_valid). A host ndarray stays a host ndarray and a tensor
    stays on its device (never pulled to the host to be padded). Raises
    ValueError on an empty batch that needs padding: edge-repeating zero
    rows would silently return an unpadded empty."""
    n = x.shape[0]
    if multiple <= 1 or (n and n % multiple == 0):
        return x, n
    if n == 0:
        raise ValueError("cannot edge-pad an empty batch to a multiple")
    pad = multiple - n % multiple
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]), n
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]), n


def shard_rows(x, mesh):
    """This data rank's contiguous 1/n_data of dim 0 (x itself without a
    data axis wider than 1). Dim 0 must divide evenly: production_chunk
    and the server's mesh quantum guarantee it."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over a data axis of {n}")
    per = x.shape[0] // n
    start = axis_index(mesh, DATA_AXIS) * per
    return x[start:start + per]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather of every data rank's rows, in rank order, onto x's device:
    the inverse of shard_rows."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return x
    return collectives.all_gather_rows(x, axis_group(mesh, DATA_AXIS))
