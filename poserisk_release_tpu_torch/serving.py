"""Request-batching server: pose + ergonomic scoring of single frames, in PyTorch.

Port of the JAX package's serving.py. The reference is a batch CLI (one
video in, result files out); this module serves the same per-frame
capability online: score individual (frame, tracked bbox) requests arriving
concurrently from many clients.

  * **Static shapes, bucketed batching.** A request batch is padded up to
    the smallest bucket of the ladder (default 1/4/16/64) that holds it.
    Padding rows are edge-repeats of the last request; their results are
    dropped.
  * **One CUDA graph per bucket.** On a CUDA device each bucket is one
    captured ``torch.cuda.CUDAGraph`` of crop (kernel K1) -> HMR ->
    rotations -> SMPL joints -> REBA/RULA over static input buffers
    ((b, H, W, 3) uint8 frames, (b, 4) f32 boxes) and static outputs. A
    batch's real rows are copied into the inputs from the pinned slot its
    requests were written into, the pad rows are filled on the device, the
    graph is replayed, and the outputs are copied back to the host before
    the next replay. All buckets of a build share one memory pool. A
    bucket is captured on its first batch (warm-up captures every bucket),
    after a warm-up of the step on the server's own stream; capture runs in
    ``thread_local`` error mode on that stream, so other threads' work on
    the card (a StreamSession's detector) neither breaks nor joins it. A
    failed capture or replay raises: there is no eager fallback on the
    card. On the CPU, which the caller must name, each batch runs the same
    step eagerly.
  * **Deadline micro-batching into staging slots.** ``submit`` writes each
    request's frame and box once, into the next row of the open slot: host
    rows of the largest bucket, pinned on CUDA. A dispatcher thread takes
    the oldest slot once it holds a request, waits at most ``max_delay_ms``
    more (or until the slot fills), then closes it (later requests open
    the next slot), waits for its rows' copies and runs its filled rows as
    one batch. Two slots serve a steady load: one fills while the other's
    batch runs; a burst that fills both takes a further slot, never a wait.

Detection and tracking are per-stream state (a SORT filter per camera), so
they live in ``StreamSession``: one session per camera owns its detector,
SORT filter, online target lock and detection-stride backfill ring
(streaming.OnlineTargetTracker, the online streaming mode's machinery) and
feeds the tracked boxes into THIS server's ladder, so N cameras share one
set of bucket graphs, batched across streams. ``pose_stride`` must be 1:
requests are independent frames with no neighbours to slerp.

Numerics: a request's result is the eager pose + score step's result at
that bucket's batch shape (pipeline.PoseEstimator.run_from_frames with
chunk = bucket, then the REBA/RULA engines), since padding edge-repeats
the last request as run_from_frames pads its last chunk.

Under a mesh (cfg.PARALLEL's data, model, stage, expert and spatial axes
over torch.distributed, parallel/), every rank builds the server; rank 0 owns
the staging slots and the dispatcher and broadcasts each batch's bucket
and real rows to a worker loop on the other ranks (every rank edge-pads
its own share on its device), which stops on a sentinel at ``close()``.
Buckets round up to PoseEstimator.row_quantum (the data axis, times
stage_microbatches under pp), and each data rank scores its rows of a
batch, as the estimator splits a chunk; the results are all-gathered.
What runs where: with a data axis alone, a bucket's CUDA graph covers the
rank's own rows (crop -> pose -> scores), and the gather follows the
replay outside the graph. Where collectives sit inside the step (tp, pp,
ep) the step runs eagerly on the card: gloo cannot be captured, and
capturing NCCL's collectives in the graphs is later work (ROADMAP). The
spatial axis is a no-op here, as in the JAX server: the step reads whole
crop rows, so the spatial ranks compute their data rows as replicas.

>>> with PoseScoringServer(frame_hw=(450, 800)) as server:
...     res = server.score(frame_u8, np.array([400., 225., 220., 220.]))
...     res.reba, res.rula, res.euler_deg.shape
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import Config, default_config
from poserisk_release_tpu_torch.device import resolve_device
from poserisk_release_tpu_torch.pipeline import PoseEstimator, _global_rank, build_detector
from poserisk_release_tpu_torch.scoring import reba as reba_mod
from poserisk_release_tpu_torch.scoring import rula as rula_mod
from poserisk_release_tpu_torch.streaming import OnlineTargetTracker
from poserisk_release_tpu_torch.throughput import default_packed_infos
from poserisk_release_tpu_torch.tracking.mpt import detect_frames

# Eager runs of the step on the capture stream before each capture: cuDNN
# and cuBLAS pick their algorithms and workspaces outside the graph.
CAPTURE_WARMUP_RUNS = 2


@dataclass(frozen=True)
class ScoredPose:
    """One request's result: final scores + the angle/joint surfaces the
    reference's debug dumps expose per frame."""

    reba: int
    rula: int
    euler_deg: np.ndarray  # (24, 3) XYZ Euler, degrees
    joint_cam_mm: np.ndarray  # (24, 3) root-centred joints, mm


@dataclass(frozen=True)
class _Request:
    future: Future
    t_submit: float


class _Slot:
    """Host rows of the largest bucket that submit() writes requests into:
    (rows, H, W, 3) uint8 frames and (rows, 4) f32 boxes, pinned on CUDA.
    ``requests`` holds each reserved row's request in row order; ``copied``
    counts the reserved rows whose bytes are written; ``closed`` is set
    once the dispatcher has taken the slot."""

    def __init__(self, rows: int, frame_hw: Tuple[int, int], pin: bool):
        self.frames = torch.empty((rows, *frame_hw, 3), dtype=torch.uint8, pin_memory=pin)
        self.boxes = torch.empty((rows, 4), dtype=torch.float32, pin_memory=pin)
        self.frames_np, self.boxes_np = self.frames.numpy(), self.boxes.numpy()
        self.requests: List[_Request] = []
        self.copied = 0
        self.closed = False


def _host(x, dtype) -> torch.Tensor:
    """A batch's host rows as a CPU tensor: a slot's rows as they are, a
    caller's array without a copy where its layout allows."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype))


def _fill_rows(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst[:m] = the m host rows src, then every later row of dst = its row
    m - 1, on dst's device: a bucket's edge pad without a host copy."""
    m = src.shape[0]
    dst[:m].copy_(src, non_blocking=True)
    if m < dst.shape[0]:
        dst[m:].copy_(dst[m - 1])
    return dst


class _BucketGraph:
    """One bucket's CUDA graph of the step, captured on its first run.

    Owns the static device inputs and the graph's static outputs; `run`
    copies a batch's real host rows (a pinned slot's, on the dispatcher's
    path) into the inputs, edge-pads the rest on the device, replays, and
    returns host copies of the outputs. A replay launches every kernel the
    capture recorded, so it adds the crop kernel's and the conv epilogue's
    recorded launches to ops/resample.crop_batch_cuda.launches and
    ops/epilogue.conv_epilogue_cuda.launches (each wrapper counts a
    recording apart, in `.captured`)."""

    def __init__(self, step, bucket: int, frame_hw: Tuple[int, int], device: torch.device,
                 pool, stream: torch.cuda.Stream):
        self.step, self.bucket, self.device = step, bucket, device
        self.pool, self.stream = pool, stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.frames = torch.zeros((bucket, *frame_hw, 3), dtype=torch.uint8, device=device)
        self.boxes = torch.zeros((bucket, 4), dtype=torch.float32, device=device)
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.host_out: Tuple[torch.Tensor, ...] = ()
        self.k1_per_replay = self.epilogue_per_replay = 0

    def capture(self) -> None:
        from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue_cuda
        from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), torch.inference_mode():
            for _ in range(CAPTURE_WARMUP_RUNS):
                self.step(self.frames, self.boxes)
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        recorded = crop_batch_cuda.captured, conv_epilogue_cuda.captured
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                outputs = self.step(self.frames, self.boxes)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of serving bucket {self.bucket} failed") from exc
        self.k1_per_replay = crop_batch_cuda.captured - recorded[0]
        self.epilogue_per_replay = conv_epilogue_cuda.captured - recorded[1]
        self.outputs = tuple(outputs)
        self.host_out = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                              for o in self.outputs)
        self.graph = graph

    def run(self, host_frames: torch.Tensor, host_boxes: torch.Tensor):
        from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue_cuda
        from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

        if self.graph is None:
            self.capture()
        with torch.cuda.stream(self.stream):
            _fill_rows(self.frames, host_frames)
            _fill_rows(self.boxes, host_boxes)
            self.graph.replay()
            for host, out in zip(self.host_out, self.outputs):
                host.copy_(out, non_blocking=True)
        self.stream.synchronize()
        crop_batch_cuda.launches += self.k1_per_replay
        conv_epilogue_cuda.launches += self.epilogue_per_replay
        return tuple(h.numpy().copy() for h in self.host_out)

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.outputs = self.host_out = ()


class PoseScoringServer:
    """Request-batching scoring server over one warm PoseEstimator.

    Parameters
    ----------
    cfg, fast, spin_int8, gender:
        Same contracts as pipeline.PoseEstimator (bf16 backbone under
        ``fast``; int8-PTQ SPIN calibrated on the first real batch under
        ``spin_int8``, after which the server captures its bucket graphs
        anew, once). A cfg.PARALLEL that describes a mesh serves on it, on
        every rank of the process group (module docstring).
    add_info:
        The reference's additional-information dict (load_add_info format);
        defaults to the packaged default_information.json. Fixed per server:
        run one server per info profile.
    batch_sizes:
        The bucket ladder, unique and ascending: one CUDA graph each.
        Under a mesh each bucket rounds up to the mesh quantum.
    max_delay_ms:
        How long the dispatcher waits after the FIRST queued request for
        more to coalesce. 0 serves strictly one batch per poll.
    frame_hw:
        Fixed (height, width) of every request frame, the static-shape
        contract of the bucket graphs. Defaults to the reference's ingest
        cap, (450, 800).
    warm:
        Capture and run every bucket at construction, so the first real
        request never pays a capture.
    calibration_crops:
        Representative person crops ((N, S, S, 3) float [0, 1]) for the
        ``spin_int8`` activation scales, applied BEFORE warm-up so the
        warmed graphs are the quantized ones. Without it the first REAL
        batch calibrates (and the graphs are captured anew, once,
        mid-traffic). Warm-up itself never calibrates: its all-zero frames
        would pin degenerate scales.
    spin_variables:
        The HMR state_dict (models/convert.flax_to_state_dict turns the JAX
        package's Flax tree into one); None resolves the configured weights.
    device:
        CUDA unless the caller names another device (device.resolve_device:
        raises without CUDA). On the CPU each batch runs the step eagerly.
    """

    def __init__(
        self,
        cfg: Config | None = None,
        add_info: Optional[Dict] = None,
        batch_sizes: Sequence[int] = (1, 4, 16, 64),
        max_delay_ms: float = 3.0,
        frame_hw: Tuple[int, int] = (450, 800),
        fast: bool = False,
        spin_int8: bool = False,
        gender: str = "neutral",
        warm: bool = True,
        calibration_crops: Optional[np.ndarray] = None,
        spin_variables: Optional[Dict[str, torch.Tensor]] = None,
        device=None,
    ):
        if not batch_sizes or list(batch_sizes) != sorted(set(batch_sizes)):
            raise ValueError(f"batch_sizes must be unique ascending, got {batch_sizes!r}")
        self.cfg = cfg or default_config()
        if int(self.cfg.SPIN.pose_stride) != 1:
            raise ValueError(
                "serving requires SPIN.pose_stride == 1: requests are "
                "independent frames, there are no neighbours to slerp")
        self.device = resolve_device(device)
        self.batch_sizes = tuple(int(b) for b in batch_sizes)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        self.estimator = PoseEstimator(
            self.cfg, SMPLFamily(self.cfg.SPIN.smpl_model_dir), variables=spin_variables,
            fast=fast, spin_int8=spin_int8, gender=gender, device=self.device)
        self._mesh = self.estimator.mesh
        # Buckets round UP to the row quantum (1 without a mesh): padding
        # only widens, no request is dropped.
        q = self.estimator.row_quantum
        self.batch_sizes = tuple(sorted({((b + q - 1) // q) * q for b in self.batch_sizes}))
        self._rank = 0 if self._mesh is None else _global_rank()
        if calibration_crops is not None:
            self.estimator.calibrate_spin(calibration_crops)
        if add_info is None:
            info_reba, info_rula = default_packed_infos()
        else:
            info_reba, info_rula = reba_mod.pack_info(add_info), rula_mod.pack_info(add_info)
        self._info_reba = torch.as_tensor(info_reba, device=self.device)
        self._info_rula = torch.as_tensor(info_rula, device=self.device)

        self._cuda = self.device.type == "cuda"
        self.graph_replays = 0
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
        self._steps = self._build_steps()

        self._closed = threading.Event()
        self._lock = threading.Lock()
        # Staging slots, guarded by _lock: _pending holds the slots with
        # reserved rows that no batch has taken yet, oldest first (the last
        # one is open while it has a free row); _free the idle ones.
        self._cv = threading.Condition(self._lock)
        self._rows = self.batch_sizes[-1]
        self._pending: "deque[_Slot]" = deque()
        self._free: List[_Slot] = []
        self._slot_grows = self._copy_waits = 0
        # Bounded metric windows: percentiles and fills cover the most
        # recent requests while the totals stay exact counters.
        self._latencies: "deque[float]" = deque(maxlen=4096)
        self._batch_fills: "deque[Tuple[int, int]]" = deque(maxlen=4096)
        self._n_requests = 0
        self._n_batches = 0
        self._worker_error: Optional[BaseException] = None

        if self._rank != 0:
            # The other ranks' worker loop answers rank 0's broadcasts, its
            # warm-up's included, until the close() sentinel.
            self._thread = threading.Thread(target=self._worker_loop, daemon=True,
                                            name="poserisk-serving-worker")
            self._thread.start()
            return
        self._free = [self._new_slot() for _ in range(2)]
        if warm:
            self._warmup()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="poserisk-serving")
        self._thread.start()

    # -- graph construction -------------------------------------------------
    def _make_step(self):
        """The fused step: PoseEstimator.whole_row_step (crop + pose on the
        CURRENT backbone, this data rank's rows) + REBA/RULA on the card.
        With a data axis alone it stops short of the rows' gather, which
        _run_bucket does after it, outside the bucket's graph."""
        pose = self.estimator.whole_row_step()
        info_reba, info_rula = self._info_reba, self._info_rula

        def step(frames_u8: torch.Tensor, bboxes: torch.Tensor):
            euler, joint_cam, _aa = pose(frames_u8, bboxes)
            reba = reba_mod.reba_frame_scores(euler, info_reba)["score"]
            rula = rula_mod.rula_frame_scores(euler, info_rula)["score"]
            return reba, rula, euler, joint_cam

        return step

    def _build_steps(self) -> Dict[int, object]:
        """One bucket graph per bucket on the card (captured on first use,
        one shared memory pool, over this data rank's rows of the bucket),
        the eager step elsewhere and wherever collectives sit inside it."""
        step = self._make_step()
        if not self._cuda or self.estimator.row_step_has_collectives:
            return {b: step for b in self.batch_sizes}
        from poserisk_release_tpu_torch.parallel.mesh import shard_rows

        pool = torch.cuda.graph_pool_handle()
        return {b: _BucketGraph(step, len(shard_rows(np.arange(b), self._mesh)), self.frame_hw,
                                self.device, pool, self._stream)
                for b in self.batch_sizes}

    def _release_steps(self) -> None:
        for bucket in self._steps.values():
            if isinstance(bucket, _BucketGraph):
                bucket.release()

    def _warmup(self) -> None:
        frames = np.zeros((1, *self.frame_hw, 3), np.uint8)
        boxes = np.asarray(
            [[self.frame_hw[1] / 2, self.frame_hw[0] / 2, 32.0, 32.0]], np.float32)
        for b in self.batch_sizes:
            # allow_calibration=False: warm-up frames are zeros, and int8
            # scales pinned on black frames would be degenerate.
            self._run_bucket(np.repeat(frames, b, 0), np.repeat(boxes, b, 0),
                             allow_calibration=False)

    def _new_slot(self) -> _Slot:
        return _Slot(self._rows, self.frame_hw, pin=self._cuda)

    def _bucket(self, n: int) -> int:
        """The smallest bucket that holds n rows."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise ValueError(f"{n} rows exceed the largest bucket, {self.batch_sizes[-1]}")

    def _run_bucket(self, frames, bboxes, allow_calibration: bool = True):
        """n real rows (host arrays, or a slot's rows) through the smallest
        bucket that holds them, edge-padded with row n - 1 on the device:
        host (reba, rula, euler, joint_cam) arrays of the bucket's rows.
        Under a mesh rank 0 first broadcasts the rows to the other ranks'
        worker loops."""
        bucket = self._bucket(len(frames))
        if self._mesh is not None:
            self._broadcast_batch(frames, bboxes, bucket, allow_calibration)
        return self._run_bucket_here(frames, bboxes, bucket, allow_calibration)

    # -- the mesh: rank 0 -> worker loops ------------------------------------
    def _broadcast_batch(self, frames, bboxes, bucket: int, allow_calibration: bool) -> None:
        """Rank 0's half of one batch (frames None: the close() sentinel):
        a header (bucket, allow_calibration, real rows), then the real
        rows' frames and boxes; every rank pads its own share."""
        from poserisk_release_tpu_torch.parallel.collectives import broadcast

        n = 0 if frames is None else len(frames)
        broadcast(torch.tensor([bucket, int(allow_calibration), n], dtype=torch.int64), 0)
        if n:
            broadcast(_host(frames, np.uint8), 0)
            broadcast(_host(bboxes, np.float32), 0)

    def _worker_loop(self) -> None:
        from poserisk_release_tpu_torch.parallel.collectives import broadcast

        try:
            while True:
                bucket, allow, n = broadcast(torch.zeros(3, dtype=torch.int64), 0).tolist()
                if not n:
                    return
                frames = broadcast(torch.empty((n, *self.frame_hw, 3), dtype=torch.uint8), 0)
                boxes = broadcast(torch.empty((n, 4), dtype=torch.float32), 0)
                self._run_bucket_here(frames, boxes, bucket, bool(allow))
        except BaseException as exc:  # surfaced by close(); the run cannot go on
            self._worker_error = exc
            raise

    def _run_bucket_here(self, frames, bboxes, bucket: int, allow_calibration: bool):
        """This rank's part of one batch (every rank under a mesh): the
        whole bucket's host outputs from its n real host rows."""
        from poserisk_release_tpu_torch.parallel.mesh import gather_rows, shard_rows

        frames, bboxes = _host(frames, np.uint8), _host(bboxes, np.float32)
        # The padded batch's row ids (the edge pad repeats row n - 1), cut
        # to this data rank's share: it uploads the real rows in `rows` and
        # pads the rest on the device.
        ids = shard_rows(np.minimum(np.arange(bucket), len(frames) - 1), self._mesh)
        rows = slice(int(ids[0]), int(ids[-1]) + 1)
        if allow_calibration and self.estimator.spin_needs_calibration:
            # The first real batch calibrates the int8 backbone on the
            # padded batch's first 8 rows, as run_from_frames does; the
            # quantized core replaces the f32 one, so the bucket graphs are
            # released and captured anew, once.
            first = torch.from_numpy(np.minimum(np.arange(min(8, bucket)), len(frames) - 1))
            self.estimator.calibrate_on_frames(frames[first], bboxes[first])
            self._release_steps()
            self._steps = self._build_steps()
        step = self._steps[bucket]
        if isinstance(step, _BucketGraph):
            with torch.cuda.device(self.device):
                outs = step.run(frames[rows], bboxes[rows])
            self.graph_replays += 1
        else:
            inputs = [_fill_rows(torch.empty((len(ids), *x.shape[1:]), dtype=x.dtype,
                                             device=self.device), x[rows])
                      for x in (frames, bboxes)]
            with torch.inference_mode():
                outs = step(*inputs)
            outs = tuple(o.cpu().numpy() for o in outs)
        if self._mesh is None or self.estimator.row_step_has_collectives:
            return outs  # the estimator's step gathered the rows already
        # The rows' gather, outside the graph: scores travel as float32
        # (small integers, exact) in one collective with the angles.
        n = outs[0].shape[0]
        packed = torch.cat([torch.from_numpy(np.asarray(o, np.float32)).reshape(n, -1)
                            for o in outs], dim=1)
        packed = gather_rows(packed, self._mesh).numpy()
        reba, rula = (packed[:, k].astype(outs[k].dtype) for k in (0, 1))
        return (reba, rula, packed[:, 2:74].reshape(-1, 24, 3), packed[:, 74:].reshape(-1, 24, 3))

    # -- request path --------------------------------------------------------
    def submit(self, frame: np.ndarray, bbox: np.ndarray) -> "Future[ScoredPose]":
        """Stage one request; returns a Future resolving to ScoredPose.

        frame: (H, W, 3) uint8 RGB matching frame_hw. bbox: (4,) squared
        cxcywh in frame pixels (tracking.mpt.squared_cxcywh convention);
        a wrong shape or dtype raises ValueError before anything is staged.

        The frame and bbox are copied once, into the next row of the open
        staging slot (pinned on CUDA), and the batch is uploaded from that
        row: submit() owns its inputs from the moment it returns, so a
        caller may reuse its capture buffer at once. The row is reserved
        under the server's lock and copied outside it, so threads submitting
        at once copy in parallel. submit() never waits on the device and
        never drops a request: with every slot held, it takes a further one
        (stats()["slot_grows"])."""
        if self._rank != 0:
            raise RuntimeError("requests go to rank 0's server; this rank runs a worker loop")
        if self._closed.is_set():
            raise RuntimeError("server is closed")
        frame = np.asarray(frame)
        if frame.shape != (*self.frame_hw, 3):
            raise ValueError(
                f"frame shape {frame.shape} != serving contract "
                f"{(*self.frame_hw, 3)}; fix the ingest or start the server "
                f"with frame_hw={frame.shape[:2]}")
        if frame.dtype != np.uint8:
            raise ValueError(f"frame dtype {frame.dtype} != uint8")
        bbox = np.asarray(bbox, np.float32).reshape(4)
        fut: Future = Future()
        self._stage(_Request(fut, time.perf_counter()), frame, bbox)
        if self._closed.is_set() and not fut.done():
            # close() can win the race between the entry check above and the
            # staging: its drain has already run, so nothing would ever
            # resolve this future.
            try:
                fut.set_exception(RuntimeError("server is closed"))
            except InvalidStateError:
                pass  # the dispatcher's final batch resolved it concurrently
        return fut

    def score(self, frame: np.ndarray, bbox: np.ndarray,
              timeout: Optional[float] = None) -> ScoredPose:
        """Blocking submit()."""
        return self.submit(frame, bbox).result(timeout)

    def _stage(self, request: _Request, frame: np.ndarray, bbox: np.ndarray) -> None:
        """Reserves the open slot's next row for the request (opening a
        slot when none has a free row: an idle one, else a new one), then
        copies the frame and box into it outside the lock."""
        spare = None
        while True:
            with self._cv:
                if spare is not None:
                    self._free.append(spare)
                    self._slot_grows += 1
                if not self._pending or len(self._pending[-1].requests) == self._rows:
                    if self._free:
                        self._pending.append(self._free.pop())
                if self._pending and len(self._pending[-1].requests) < self._rows:
                    slot = self._pending[-1]
                    row = len(slot.requests)
                    slot.requests.append(request)
                    if row in (0, self._rows - 1):  # a slot to take, a full slot
                        self._cv.notify_all()
                    break
            # Every slot is held: page-locking a new one takes tens of ms
            # on the card, so it runs outside the lock and the dispatcher
            # and other submits go on meanwhile.
            spare = self._new_slot()
        try:
            slot.frames_np[row] = frame
            slot.boxes_np[row] = bbox
        finally:
            with self._cv:
                slot.copied += 1
                if slot.closed and slot.copied == len(slot.requests):
                    self._cv.notify_all()

    # -- dispatcher -----------------------------------------------------------
    def _collect_slot(self) -> Optional[_Slot]:
        """Block for the first request, then coalesce until the deadline or
        the slot's rows (the largest bucket) fill. The slot then leaves
        _pending, so later requests open another, and is returned once
        every row reserved in it is written."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._pending, timeout=0.05):
                return None
            slot = self._pending[0]
            self._cv.wait_for(lambda: len(slot.requests) == self._rows,
                              timeout=self.max_delay_s)
            self._pending.popleft()
            slot.closed = True
            if slot.copied < len(slot.requests):
                self._copy_waits += 1
                self._cv.wait_for(lambda: slot.copied == len(slot.requests))
        return slot

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            slot = self._collect_slot()
            if slot is None:
                continue
            batch = slot.requests
            try:
                n = len(batch)
                try:
                    reba, rula, euler, joint_cam = self._run_bucket(slot.frames[:n],
                                                                    slot.boxes[:n])
                finally:
                    # The run synchronised, so its upload from the slot is
                    # done: the slot takes new requests.
                    with self._cv:
                        slot.requests, slot.copied, slot.closed = [], 0, False
                        self._free.append(slot)
                bucket = self._bucket(n)
                now = time.perf_counter()
                with self._lock:
                    self._n_requests += n
                    self._n_batches += 1
                    self._batch_fills.append((n, bucket))
                    self._latencies.extend(now - r.t_submit for r in batch)
                for i, r in enumerate(batch):
                    # submit() may have failed this future already (it raced
                    # close()); skip it rather than poison the batch.
                    if not r.future.done():
                        r.future.set_result(ScoredPose(
                            int(reba[i]), int(rula[i]),
                            np.asarray(euler[i]), np.asarray(joint_cam[i])))
            except Exception as exc:  # a failed batch fails its own futures only
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(exc)

    # -- lifecycle / metrics ---------------------------------------------------
    def stats(self) -> Dict:
        """Serving counters: exact request/batch totals (``requests``,
        ``batches``), requests staged and not yet in a batch
        (``queue_depth``), per-batch (n_real, bucket) fills (``batch_fill``)
        and submit->result latency percentiles (seconds) over the most
        recent 4096-entry window. Staging (every request is written into a
        slot row at submit): ``slot_grows`` counts the slots allocated
        beyond the first two, ``copy_waits`` the batches whose dispatcher
        waited for a reserved row's copy."""
        with self._lock:
            lats = np.asarray(self._latencies)
            fills = list(self._batch_fills)
            out: Dict = {
                "requests": int(self._n_requests),
                "batches": int(self._n_batches),
                "queue_depth": sum(len(slot.requests) for slot in self._pending),
                "batch_fill": fills,
                "slot_grows": self._slot_grows,
                "copy_waits": self._copy_waits,
            }
        if len(lats):
            out.update(
                latency_p50=float(np.percentile(lats, 50)),
                latency_p95=float(np.percentile(lats, 95)),
                latency_p99=float(np.percentile(lats, 99)),
            )
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher; pending futures fail with RuntimeError. The
        bucket graphs are released once the dispatcher has stopped. Under a
        mesh rank 0 then sends the worker loops their sentinel, and the
        other ranks' close() waits for it (and re-raises a worker's error)."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._rank != 0:
            self._thread.join()
            self._release_steps()
            if self._worker_error is not None:
                raise RuntimeError("the serving worker loop failed") from self._worker_error
            return
        self._thread.join(timeout)
        if self._mesh is not None and not self._thread.is_alive():
            self._broadcast_batch(None, None, 0, False)
        with self._cv:
            pending, self._pending = self._pending, deque()
        for r in (r for slot in pending for r in slot.requests):
            if not r.future.done():
                r.future.set_exception(RuntimeError("server closed"))
        if not self._thread.is_alive():
            self._release_steps()

    def __enter__(self) -> "PoseScoringServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamSession:
    """Per-camera online session over a shared PoseScoringServer.

    Owns the per-stream state the server does not: a detector instance (so
    int8 activation scales can be per camera), a SORT filter, the
    largest-box target lock and the detection-stride backfill ring, the
    policy of StreamingScorer's online mode (streaming.OnlineTargetTracker),
    so a session's (frame, box) sequence equals the online scorer's on the
    same feed. Pose + REBA/RULA ride the server's bucket ladder, batched
    across all sessions that share it.

    >>> with PoseScoringServer(frame_hw=(450, 800)) as server:
    ...     cams = [StreamSession(server) for _ in range(4)]
    ...     for idx, fut in cams[0].push(frame_u8):
    ...         results[idx] = fut.result()

    Parameters
    ----------
    server:
        The shared PoseScoringServer (frames must match its frame_hw).
    detector:
        Person detector for THIS stream; defaults to the Predictor's policy
        (pipeline.build_detector on server.cfg, on the server's device:
        YOLOv3 when weights exist, else the full-frame stub). An int8
        detector calibrates on this stream's first detected frame unless
        ``calibrate(frames)`` was called first with representative frames.
    detection_stride:
        Detect every Nth pushed frame (default: the server config's
        DETECTOR.detection_stride); skipped frames backfill through the
        pending ring like the online streaming mode.
    ring_capacity:
        Pending-ring bound in frames: gaps that outgrow it flush
        oldest-first with the last detection's box held.
    """

    def __init__(self, server: PoseScoringServer, detector=None,
                 detection_stride: Optional[int] = None,
                 ring_capacity: int = 256):
        self.server = server
        self.detector = (detector if detector is not None
                         else build_detector(server.cfg, device=server.device))
        self.stride = int(server.cfg.DETECTOR.detection_stride
                          if detection_stride is None else detection_stride)
        if self.stride < 1:
            raise ValueError(f"detection_stride must be >= 1, got {self.stride}")
        # copy_pending: a pushed frame may be the caller's reused capture
        # buffer; frames waiting in the backfill ring must not alias it.
        self._tracker = OnlineTargetTracker(
            ring_capacity=int(ring_capacity), backfill=self.stride > 1,
            copy_pending=True)
        self._next_idx = 0

    def calibrate(self, frames: np.ndarray) -> None:
        """Explicit int8 detector calibration on representative frames for
        this camera. No-op for detectors without calibration state."""
        if getattr(self.detector, "needs_calibration", False):
            self.detector.calibrate(np.asarray(frames))

    @property
    def target_id(self) -> Optional[int]:
        """The currently followed SORT identity (None before lock-on)."""
        return self._tracker.target_id

    def push(self, frame: np.ndarray) -> List[Tuple[int, "Future[ScoredPose]"]]:
        """Feed the stream's next frame (H, W, 3 uint8, server frame_hw).

        Returns [(frame_idx, future)] for every frame that became scoreable:
        possibly none (no target yet, or waiting in the backfill ring),
        possibly EARLIER frames (a detection resolves the pending gap's
        interpolated boxes), in frame order. Frame indices count pushes
        from 0."""
        frame = np.asarray(frame)
        idx = self._next_idx
        self._next_idx += 1
        dets = None
        if idx % self.stride == 0:
            if getattr(self.detector, "needs_calibration", False):
                self.detector.calibrate(frame[None])
            dets = detect_frames(self.detector, frame[None])[0]
        return [
            (gidx, self.server.submit(rgb, np.asarray(box, np.float32)))
            for gidx, rgb, box in self._tracker.observe(idx, frame, dets)
        ]
