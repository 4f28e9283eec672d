"""Joining a process group, the rank's device, and spawning ranks.

Port of the JAX package's parallel/distributed.py. JAX's multi-host mode
runs one process per host around jax.distributed; the port runs one process
per rank around torch.distributed, on one machine or many:

    torchrun --nproc_per_node 4 -m poserisk_release_tpu_torch.cli --tp 2 ...

or, without a launcher, the CLI spawns its ranks itself (run_ranks). The
backend is always the caller's choice: NCCL with one card per rank, or gloo
(on the CPU, or on cards that ranks share, staging through the host:
parallel/collectives.py). No code here switches backend or device when one
fails.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None) -> dict:
    """Join the process group (idempotent); with no init_method and no
    group it is a safe no-op. Returns the topology summary of the JAX
    function: process_index, process_count, local_devices (one device per
    rank process) and global_devices (one per rank). ``env://`` reads
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT as torchrun sets them."""
    if init_method is not None and not dist.is_initialized():
        if backend is None:
            raise ValueError("initialize_distributed needs a backend ('nccl' or 'gloo')")
        kwargs = {} if world_size is None else {"world_size": world_size, "rank": rank}
        dist.init_process_group(backend=backend, init_method=init_method, **kwargs)
    if dist.is_available() and dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return {"process_index": index, "process_count": count,
            "local_devices": 1, "global_devices": count}


def global_batch_slice(global_batch: int) -> slice:
    """The frame range this rank feeds when the frame axis spans ranks:
    contiguous equal shards in rank order."""
    info = initialize_distributed()
    per = global_batch // info["process_count"]
    start = info["process_index"] * per
    return slice(start, start + per)


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device, made the current CUDA device when it is one.

    NCCL: cuda:{LOCAL_RANK}, one card per rank; raises when the ranks on
    this machine outnumber its visible cards. gloo: the CPU when the caller
    asks for it, else cuda:{LOCAL_RANK % cards} (ranks share cards and
    their collectives stage through the host). LOCAL_RANK defaults to the
    global rank (run_ranks sets it)."""
    backend = dist.get_backend() if dist.is_initialized() else None
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if backend else 0))
    if cpu:
        if backend == "nccl":
            raise ValueError("the NCCL backend moves CUDA tensors; use gloo on the CPU")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --cpu (gloo on the CPU) to run ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= cards:
        local_world = os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size())
        raise RuntimeError(
            f"{local_world} NCCL ranks on this machine outnumber its {cards} visible "
            "cards (NCCL takes one card per rank; ranks that share a card use gloo)")
    device = torch.device("cuda", local_rank % cards)
    torch.cuda.set_device(device)
    return device


def _rank_entry(rank: int, fn, world_size: int, backend: str, init_method: str,
                args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(init_method, world_size, rank, backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, init_method: str, args: tuple = (),
              timeout: float | None = None) -> None:
    """Run fn(rank, *args) in world_size spawned processes, each joined to
    one process group (init_method: ``file://`` or ``tcp://host:port``).
    fn and args must pickle (fn a module-level function). A rank that
    raises fails the call (the others are terminated); so does outrunning
    timeout seconds, after which every rank is killed."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_entry, args=(fn, world_size, backend, init_method, args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in ctx.processes:
                proc.join(10.0)
            raise TimeoutError(f"{world_size} ranks outran their {timeout} s")
