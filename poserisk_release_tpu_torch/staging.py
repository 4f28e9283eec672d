"""Host staging for the pose estimator's chunk uploads.

PoseEstimator._run_chunked stages every chunk's host parts (the tracked
uint8 frames and their boxes, or float32 crops), on every device. From
pageable memory a copy to the card cannot be asynchronous: CUDA
stages it through its own bounce buffer, in order on the compute stream,
so the host waits for the chunks already enqueued to drain and the device
then idles while the bytes go across. On CUDA StagingRing gathers each
chunk's rows straight into one of two page-locked host slots and copies
them on a stream of its own:

    host:    gather rows into slot k  (after slot k's last copy finished)
    copy:    H2D of slot k → fresh device tensors; record event e_k
    compute: wait e_k, then the pose step reads the device tensors

The device tensors are allocated on the copy stream and handed to the
compute stream with record_stream, so the caching allocator never gives
their blocks back to a copy while a pending step still reads them. A
ring on the CPU (on a CPU estimator, or a later pp stage, which crops
nothing) hands the step the slot's host views. The rows staged are the
ids edge-padded as parallel.mesh.pad_to_multiple pads a gathered array,
then cut as parallel.mesh.shard_rows cuts it (chunk_row_ids).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from poserisk_release_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows

_ALIGN = 256  # bytes: every part starts on its own aligned offset in a slot
_THREADS = 4  # the gather's threads
_PARALLEL_BYTES = 1 << 20  # a smaller part is gathered on the calling thread


class HostRows(NamedTuple):
    """Rows `ids` (along dim 0) of the host array `source`, not gathered yet."""

    source: np.ndarray
    ids: np.ndarray


def chunk_row_ids(ids: np.ndarray, rows: int, mesh) -> np.ndarray:
    """The ids whose rows a chunk's host part uploads: edge-padded to a
    multiple of `rows` (the rows pad_to_multiple repeats are the last id's)
    and cut to this data rank's share (shard_rows')."""
    return shard_rows(pad_to_multiple(np.asarray(ids), rows)[0], mesh)


def gather_into(out: np.ndarray, source: np.ndarray, ids: np.ndarray, pool=None) -> None:
    """out[:] = source[ids] without a temporary: np.take buffers its `out`
    under mode="raise", so the ids are bounds-checked here and taken with
    mode="wrap", which maps the negative ids fancy indexing accepts alike.
    Given a thread pool, a part of 1 MiB or more is taken in _THREADS
    blocks of rows at once: np.take releases the interpreter lock, and on
    an H100 machine's host a 64-frame 450x800 chunk took 15.5 ms on one
    thread and 5.1 ms on four."""
    n = source.shape[0]
    if ids.size and (ids.min() < -n or ids.max() >= n):
        raise IndexError(f"row ids out of range for {n} rows")
    if pool is None or out.nbytes < _PARALLEL_BYTES:
        np.take(source, ids, axis=0, out=out, mode="wrap")
        return
    cuts = np.linspace(0, len(ids), _THREADS + 1).astype(int)
    for block in [pool.submit(np.take, source, ids[a:b], 0, out[a:b], "wrap")
                  for a, b in zip(cuts[:-1], cuts[1:]) if b > a]:
        block.result()


class StagingRing:
    """Two host slots that chunks are gathered into, and on CUDA the copy
    stream that uploads them. A slot is one flat byte buffer, allocated on
    first use and grown to the largest chunk it has held; a smaller chunk
    uses its front, so a new shape never reallocates. A slot is refilled
    only after the copy that last read it has finished (its event).

    On a CUDA device the slots are page-locked. On the CPU they are plain
    memory and upload returns the slot's host views, which holds only if
    no step output and no pending send views a slot after the step returns
    (slot k is refilled two chunks later): an eager CPU step has finished
    by then, and a pp stage waits for its sends before it returns."""

    SLOTS = 2

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._slots: List = [None] * self.SLOTS
        self._events: List = [None] * self.SLOTS
        self._next = 0
        self._lock = threading.Lock()
        self._pool = None  # the gather's threads, started by the first fill
        self.chunks = self.bytes = self.waits = 0

    def capacity(self, k: int) -> int:
        """Bytes slot k holds (0 before its first use)."""
        return 0 if self._slots[k] is None else self._slots[k].numel()

    def fill(self, parts: Sequence[HostRows]):
        """Gathers each part's rows into the next slot; returns (slot index,
        one host tensor a part, viewing the slot)."""
        sources = [np.asarray(p.source) for p in parts]
        shapes = [(len(p.ids), *src.shape[1:]) for p, src in zip(parts, sources)]
        sizes = [int(np.prod(shape)) * src.itemsize for shape, src in zip(shapes, sources)]
        offsets = np.cumsum([0] + [-(-b // _ALIGN) * _ALIGN for b in sizes])
        k = self._next
        self._next = (k + 1) % self.SLOTS
        event = self._events[k]
        if event is not None and not event.query():
            self.waits += 1
            event.synchronize()
        if self.capacity(k) < offsets[-1]:
            self._slots[k] = None  # its copy has finished: release it before growing
            self._slots[k] = torch.empty(int(offsets[-1]), dtype=torch.uint8,
                                         pin_memory=self._cuda)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(_THREADS, thread_name_prefix="staging")
        flat = self._slots[k].numpy()
        host = []
        for p, source, shape, size, off in zip(parts, sources, shapes, sizes, offsets):
            out = flat[off:off + size].view(source.dtype).reshape(shape)
            gather_into(out, source, np.asarray(p.ids), self._pool)
            host.append(torch.from_numpy(out))
        self.chunks += 1
        self.bytes += sum(sizes)
        return k, host

    def upload(self, parts: Sequence[HostRows]) -> List[torch.Tensor]:
        """The parts' rows for the step, gathered into a slot: on CUDA copied
        on the copy stream, which the current (compute) stream waits on
        before anything it enqueues next; elsewhere the slot's host views."""
        if not self._cuda:
            return self.fill(parts)[1]
        compute = torch.cuda.current_stream(self.device)
        with self._lock:
            k, host = self.fill(parts)
            with torch.cuda.stream(self._stream):
                dev = [h.to(self.device, non_blocking=True) for h in host]
                event = torch.cuda.Event()
                event.record(self._stream)
            self._events[k] = event
        compute.wait_event(event)
        for d in dev:
            d.record_stream(compute)
        return dev
