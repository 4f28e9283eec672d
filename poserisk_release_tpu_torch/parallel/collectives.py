"""The port's only calls of torch.distributed collectives.

Where a tensor lives and where the backend moves it can differ:

  * NCCL moves CUDA tensors as they are (a host tensor goes to the current
    CUDA device for the collective and comes back);
  * gloo moves host tensors, so a CUDA tensor is copied to the host,
    reduced or moved there, and copied back ("gloo-staged"). This is the
    one place where that happens. It is how ranks that share one card run
    (NCCL refuses two ranks on one device); its times measure host staging,
    not parallel speed.

Movement-only collectives (gathers, broadcasts, point-to-point) carry
bfloat16 as its int16 bits, so no backend has to know the type; int8 and
the other types travel as themselves, and sums run in the tensor's own
type.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# all_gather_single is the newer name of all_gather_into_tensor (same
# signature); the older one warns about its deprecation where both exist.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def transport(group=None) -> str:
    """"nccl" when the group's backend moves CUDA tensors itself, else
    "gloo-staged"."""
    return "nccl" if dist.get_backend(group) == "nccl" else "gloo-staged"


def _wire_device(group, x: torch.Tensor) -> torch.device:
    if transport(group) == "nccl":
        return x.device if x.is_cuda else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_wire(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.to(device)


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        y = y.view(torch.bfloat16)
    return y.to(like.device)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenation along dim 0 of every group rank's x (same shapes), in
    group-rank order, on x's device."""
    world = dist.get_world_size(group)
    if world == 1:
        return x
    src = _to_wire(x, _wire_device(group, x))
    out = torch.empty((world * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=group)
    return _from_wire(out, x)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group, on x's device (a new tensor)."""
    if dist.get_world_size(group) == 1:
        return x
    y = x.contiguous().to(_wire_device(group, x), copy=True)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """The src global rank's x on every rank of the group, on x's device:
    x is the data on src and, of the same shape and type, the buffer to
    receive into on the others (written in place where the backend can)."""
    if dist.get_world_size(group) == 1:
        return x
    y = _to_wire(x, _wire_device(group, x))
    dist.broadcast(y, src=src, group=group)
    return _from_wire(y, x)


def broadcast_object(obj, src: int = 0, group=None):
    """A picklable object from the src global rank to every rank."""
    if dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    device = None
    if transport(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=src, group=group, device=device)
    return box[0]


def send(x: torch.Tensor, dst: int, group) -> List:
    """Start sending x to the dst global rank (one batch_isend_irecv op).
    Returns the works and the wire tensor: keep both until waited on."""
    y = _to_wire(x, _wire_device(group, x))
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, dst, group)])
    return [works, y]


def recv(shape, dtype: torch.dtype, device, src: int, group) -> torch.Tensor:
    """Receive a tensor of the given shape and type from the src global
    rank (one batch_isend_irecv op), onto device."""
    return exchange((), [(shape, src)], group, torch.empty(0, dtype=dtype, device=device))[0]


def exchange(sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[tuple, int]],
             group, like: torch.Tensor) -> List[torch.Tensor]:
    """Point-to-point sends and receives of one rank posted together (one
    batch_isend_irecv) and finished before it returns: sends are (tensor,
    dst global rank), recvs (shape, src global rank) of tensors of like's
    type. Returns the received tensors in recvs order, on like's device.
    A rank with neither posts nothing. Every send must meet its peer's
    receive of the same shape, or both ranks wait for ever."""
    if not (sends or recvs):
        return []
    device = _wire_device(group, like)
    wire_dtype = torch.int16 if like.dtype == torch.bfloat16 else like.dtype
    wires = [_to_wire(x, device) for x, _dst in sends]
    bufs = [torch.empty(shape, dtype=wire_dtype, device=device) for shape, _src in recvs]
    ops = ([dist.P2POp(dist.isend, y, dst, group) for y, (_x, dst) in zip(wires, sends)]
           + [dist.P2POp(dist.irecv, buf, src, group) for buf, (_s, src) in zip(bufs, recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_from_wire(buf, like) for buf in bufs]


def wait(pending: Optional[List]) -> None:
    """Finish the sends that send() started."""
    for works, _wire in pending or ():
        for work in works:
            work.wait()
