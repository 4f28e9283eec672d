"""The data axis (a chunk's frames over the data ranks) and the spatial axis
(a frame's rows over the spatial ranks).

Port of the JAX package's parallel/mesh.py. JAX shards the frame axis with
``P('data')`` and fetches the global array back; here every rank holds the
whole host chunk, takes its own contiguous rows (shard_rows), computes them,
and all-gathers the outputs (gather_rows) so every rank holds the whole
chunk again. A mesh is a DeviceMesh (spmd.mesh_from_config) or None, the
single-device layout; the helpers below read it through axis_size /
axis_index / axis_group so that a mesh without an axis means size 1.

The spatial axis splits the crop HEIGHT of every activation of the
backbone (JAX: ``P('data', 'spatial')`` on the crops, with XLA's
partitioner inserting the convolutions' halo exchanges). Here the rows
follow row_range at every layer, and RowShards.exchange hands a conv or
pool the input window its output rows read: halo_plan says which rank
owns which of those rows, and only those rows travel, never the whole
activation.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from poserisk_release_tpu_torch.models.resnet import conv_height
from poserisk_release_tpu_torch.parallel import collectives

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


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
    data axis wider than 1). Dim 0 must divide evenly: PoseEstimator.
    row_quantum, which chunks and the server's buckets round up to,
    guarantees it."""
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


# -- the spatial axis: crop rows over ``spatial`` -------------------------------

def row_range(height: int, size: int, index: int) -> Tuple[int, int]:
    """The rows [start, stop) of a height that rank `index` of `size` owns:
    contiguous blocks of ceil(height / size) rows in rank order, so the
    last ranks own fewer rows, or none. Every rank computes every rank's
    range, which is what makes the halo exchanges deterministic."""
    c = -(-height // size)
    return min(index * c, height), min((index + 1) * c, height)


def conv_window(o0: int, o1: int, k: int, s: int, p: int) -> Tuple[int, int]:
    """The input rows [a, b) that output rows [o0, o1) of a conv (kernel k,
    stride s, padding p) read; rows outside the input are its padding."""
    return o0 * s - p, (o1 - 1) * s - p + k


@functools.lru_cache(maxsize=None)
def halo_plan(height: int, size: int, k: int, s: int, p: int) -> Tuple[dict, ...]:
    """Per rank of the spatial axis, for one conv or pool on an input of
    `height` rows split by row_range: the input ``window`` its output rows
    read (None without output rows) and the ``pieces`` that make the
    window's rows inside the input, in row order, as (owner rank, start,
    stop)."""
    ho = conv_height(height, k, s, p)
    owned = [row_range(height, size, r) for r in range(size)]
    plan = []
    for r in range(size):
        o0, o1 = row_range(ho, size, r)
        if o1 <= o0:
            plan.append({"window": None, "pieces": ()})
            continue
        a, b = conv_window(o0, o1, k, s, p)
        pieces = tuple((q, max(a, h0), min(b, h1)) for q, (h0, h1) in enumerate(owned)
                       if max(a, h0) < min(b, h1))
        plan.append({"window": (a, b), "pieces": pieces})
    return tuple(plan)


def stitch_rows(parts: Sequence[torch.Tensor], a: int, b: int, height: int) -> torch.Tensor:
    """The window [a, b) of rows (dim 2) of an input of `height` rows from
    its parts inside the input, in row order: rows above 0 and from
    `height` on are zero rows made here. Channels-last in memory, as the
    convs' own outputs are."""
    like = parts[0]
    B, C, _, W = like.shape
    top, bottom = max(0, -a), max(0, b - height)
    zeros = [like.new_zeros((B, C, n, W)) for n in (top, bottom)]
    out = torch.cat([zeros[0], *parts, zeros[1]], dim=2)
    return out.contiguous(memory_format=torch.channels_last)


class RowShards:
    """This rank's rows of every activation when the crop HEIGHT axis is
    split over the ``spatial`` axis (row_range), and the halo exchanges a
    conv or pool needs to read its input window.

    group: this rank's line along ``spatial``; size and index: the axis
    size and this rank's coordinate on it; ranks: the group's global ranks
    in axis order (by default the group's own list).
    ``RowShards.received_bytes`` counts the bytes this process has received
    in halo exchanges (set it to 0 to start a count)."""

    received_bytes = 0

    def __init__(self, group, size: int, index: int, ranks: Sequence[int] | None = None):
        import torch.distributed as dist

        self.group, self.size, self.index = group, int(size), int(index)
        if ranks is not None:
            self.ranks = list(ranks)
            return
        self.ranks = dist.get_process_group_ranks(group)
        if collectives.transport(group) == "nccl":
            # NCCL wants every rank of a group in the group's first
            # collective, and a halo exchange may leave a rank out.
            collectives.all_reduce_sum(torch.zeros(1), group)

    def rows(self, height: int) -> Tuple[int, int]:
        return row_range(height, self.size, self.index)

    def take(self, whole: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
        """This rank's input window of a conv on a tensor every rank holds
        whole (the stem on the crops): no exchange."""
        height = whole.shape[2]
        window = halo_plan(height, self.size, k, s, p)[self.index]["window"]
        if window is None:
            return whole[:, :, :0]
        a, b = window
        return stitch_rows([whole[:, :, max(a, 0):min(b, height)]], a, b, height)

    def exchange(self, x: torch.Tensor, height: int, k: int, s: int, p: int) -> torch.Tensor:
        """This rank's input window of a conv or pool (kernel k, stride s,
        padding p) on an input of `height` rows, of which x holds this
        rank's (row_range): x itself when the window is exactly those
        rows, else the window stitched from x, the rows received from the
        ranks that own them (one batch_isend_irecv with every send and
        receive of this rank) and zero rows past the edges. A rank with no
        output rows gets 0 rows back and receives nothing; it still sends
        what the others need of its rows."""
        plan = halo_plan(height, self.size, k, s, p)
        h0, _h1 = self.rows(height)
        me = self.index
        sends = [(x[:, :, lo - h0:hi - h0], self.ranks[q])
                 for q, entry in enumerate(plan) if q != me
                 for src, lo, hi in entry["pieces"] if src == me]
        mine = plan[me]
        B, C, _, W = x.shape
        recvs = [((B, C, hi - lo, W), self.ranks[src])
                 for src, lo, hi in mine["pieces"] if src != me]
        got = collectives.exchange(sends, recvs, self.group, x)
        RowShards.received_bytes += sum(t.numel() * t.element_size() for t in got)
        if mine["window"] is None:
            return x[:, :, :0]
        a, b = mine["window"]
        if (a, b) == self.rows(height):
            return x
        got = iter(got)
        parts = [x[:, :, lo - h0:hi - h0] if src == me else next(got)
                 for src, lo, hi in mine["pieces"]]
        return stitch_rows(parts, a, b, height)

    def mean(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The global average pool of a row-sharded (B, C, h, W) map of n
        positions in all: this rank's row sum, summed over the axis."""
        return collectives.all_reduce_sum(x.sum(dim=(2, 3)), self.group) / n
