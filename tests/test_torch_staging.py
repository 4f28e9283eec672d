"""The pose estimator's staging ring (staging.StagingRing) and how
PoseEstimator._run_chunked uploads a chunk's parts.

On the CPU the ring's slots are plain memory, and the tests hold its fill to
the rows of the gathered array: x[ids] edge-padded by
parallel.mesh.pad_to_multiple and cut by parallel.mesh.shard_rows, for
contiguous, strided and shuffled ids, a ragged last chunk and a data rank's
share; the slots' reuse order and growth; the estimator on the CPU, which
stages every host part and reads the slots' host views, a failed chunk's
retry, and a chunk that mixes a device tensor with host boxes. The `cuda`
tests (skipped here) hold the pinned path on the card bit for bit: a
host pool against the same pool as a device tensor, run on host crops
against the pose step on the same crops uploaded plainly, and the fetch's
retry, which re-stages its chunk. On the card:

    python -m pytest tests/test_torch_staging.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows
from poserisk_release_tpu_torch.pipeline import PoseEstimator
from poserisk_release_tpu_torch.staging import HostRows, StagingRing, chunk_row_ids, gather_into
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _DataMesh:
    """The DeviceMesh surface parallel/mesh reads: a data axis of `n`, this
    rank at `index`."""

    mesh_dim_names = ("data",)

    def __init__(self, n, index):
        self.n, self.index = n, index

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, name):
        return self.index


def _pool(n=40, hw=(6, 10), seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    boxes = rng.uniform(1.0, 9.0, (n, 4)).astype(np.float32)
    return frames, boxes


def _unstaged(source, ids, rows, mesh=None):
    """One host part gathered, padded and cut as a tensor part is."""
    return shard_rows(pad_to_multiple(source[ids], rows)[0], mesh)


def _staged(ring, parts, rows, mesh=None):
    return ring.fill([HostRows(src, chunk_row_ids(ids, rows, mesh)) for src, ids in parts])


@pytest.mark.parametrize("kind", ["contiguous", "stride2", "shuffled"])
def test_fill_equals_the_gathered_rows(kind):
    frames, boxes = _pool()
    ids = {"contiguous": np.arange(8, 24),
           "stride2": np.arange(3, 35)[::2],  # a pose-stride-2 chunk's anchors
           "shuffled": np.random.default_rng(1).permutation(40)[:16]}[kind]
    ring = StagingRing("cpu")
    _, (f, b) = _staged(ring, [(frames, ids), (boxes, np.arange(len(ids)))], rows=16)
    assert f.dtype == torch.uint8 and b.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy(), frames[ids])
    np.testing.assert_array_equal(b.numpy(), boxes[np.arange(len(ids))])
    assert ring.chunks == 1 and ring.bytes == frames[ids].nbytes + 16 * 16


def test_a_part_of_a_mebibyte_or_more_is_taken_in_blocks_as_indexing_takes_it():
    frames, boxes = _pool(n=40, hw=(200, 200))
    ids = np.random.default_rng(2).permutation(40)[:19]  # 19 rows, 2.3 MB: 4 uneven blocks
    ring = StagingRing("cpu")
    _, (f, b) = _staged(ring, [(frames, ids), (boxes, ids)], rows=19)
    assert f.numpy().nbytes >= 1 << 20 and ring._pool is not None
    np.testing.assert_array_equal(f.numpy(), frames[ids])
    np.testing.assert_array_equal(b.numpy(), boxes[ids])


@pytest.mark.parametrize("n_rows", [1, 5, 7])
def test_ragged_chunk_repeats_the_edge_row_as_pad_to_multiple(n_rows):
    frames, boxes = _pool()
    ids = np.arange(30, 30 + n_rows)[::-1]
    _, (f, b) = _staged(StagingRing("cpu"), [(frames, ids), (boxes, ids)], rows=8)
    np.testing.assert_array_equal(f.numpy(), _unstaged(frames, ids, 8))
    np.testing.assert_array_equal(b.numpy(), _unstaged(boxes, ids, 8))
    assert f.shape[0] == 8 and (f.numpy()[n_rows:] == frames[ids[-1]]).all()


@pytest.mark.parametrize("n_data", [2, 4])
def test_data_rank_stages_its_shard_rows(n_data):
    frames, boxes = _pool()
    ids = np.arange(2, 13)  # 11 rows, padded to 16, then cut over the data axis
    for index in range(n_data):
        mesh = _DataMesh(n_data, index)
        _, (f, b) = _staged(StagingRing("cpu"), [(frames, ids), (boxes, ids)], 16, mesh)
        assert f.shape[0] == 16 // n_data
        np.testing.assert_array_equal(f.numpy(), _unstaged(frames, ids, 16, mesh))
        np.testing.assert_array_equal(b.numpy(), _unstaged(boxes, ids, 16, mesh))


def test_ring_reuses_its_slots_in_turn_and_serves_a_smaller_chunk_from_the_front():
    frames, boxes = _pool()
    ring = StagingRing("cpu")
    seen = []
    for ids in (np.arange(16), np.arange(16, 32), np.arange(5), np.arange(32, 40)):
        k, (f, b) = _staged(ring, [(frames, ids), (boxes, ids)], rows=len(ids))
        seen.append((k, f.data_ptr(), ring.capacity(k)))
        np.testing.assert_array_equal(f.numpy(), frames[ids])
        np.testing.assert_array_equal(b.numpy(), boxes[ids])
    assert [k for k, _, _ in seen] == [0, 1, 0, 1]
    # The 5- and 8-row chunks reuse the front of the slots the 16-row chunks grew.
    assert seen[2][1:] == seen[0][1:] and seen[3][1:] == seen[1][1:]
    assert seen[0][1] != seen[1][1]
    # A larger chunk grows its slot.
    k, _ = _staged(ring, [(frames, np.arange(40)), (boxes, np.arange(40))], rows=40)
    assert k == 0 and ring.capacity(0) > seen[0][2]
    assert ring.chunks == 5 and ring.waits == 0


def test_gather_into_checks_bounds_and_takes_negative_ids_as_indexing_does():
    frames, _ = _pool(n=6)
    out = np.empty((3, *frames.shape[1:]), np.uint8)
    gather_into(out, frames, np.array([-1, 0, -6]))
    np.testing.assert_array_equal(out, frames[[-1, 0, -6]])
    for bad in ([0, 6, 1], [-7, 0, 1]):
        with pytest.raises(IndexError):
            gather_into(out, frames, np.array(bad))


def _estimator(device, stride=1, chunk=8, crop=64):
    cfg = default_config().replace(PARALLEL={"frames_per_step": chunk},
                                   SPIN={"pose_stride": stride},
                                   MODEL={"input_shape": (crop, crop)})
    return PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device=device)


def _track(n_pool, n, hw, seed=3):
    """A tracked subset of a pool: sorted distinct frames, drifting boxes."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_pool, *hw, 3), dtype=np.uint8)
    ids = np.sort(rng.choice(n_pool, n, replace=False))
    h, w = hw
    boxes = np.stack([[w / 2 + (i % 7), h / 2 - (i % 5), 0.6 * h + i % 3, 0.6 * h]
                      for i in range(n)]).astype(np.float32)
    return frames, ids, boxes


class _FailingReadback:
    """A step output whose readback fails, as a failed chunk's would."""

    def cpu(self):
        raise RuntimeError("injected readback failure")


def _fail_first_readback(est, step_name):
    real = getattr(est, step_name)
    calls = []

    def step(*batches):
        out = real(*batches)
        calls.append(len(calls))
        return (_FailingReadback(), *out[1:]) if len(calls) == 1 else out

    setattr(est, step_name, step)
    return calls


@pytest.fixture(scope="module")
def cpu_estimator():
    return _estimator("cpu")


def test_cpu_stages_every_host_chunk_and_retries_a_failed_chunk(cpu_estimator):
    est = cpu_estimator
    frames, ids, boxes = _track(16, 11, (40, 56))
    before = est.upload_stats()
    want = est.run_from_frames(frames, ids, boxes)  # 2 chunks: 8 + a ragged 3
    calls = _fail_first_readback(est, "_pose_step_from_frames")
    try:
        got = est.run_from_frames(frames, ids, boxes)
    finally:
        del est._pose_step_from_frames
    assert len(calls) == 3  # 2 chunks, the first run twice
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # 2 + 2 chunks and the retry, each 8 frames and 8 boxes; the CPU never waits.
    assert est.upload_stats() == dict(
        before, staged_chunks=before["staged_chunks"] + 5,
        staged_bytes=before["staged_bytes"] + 5 * 8 * (frames[0].nbytes + 16))
    assert est._ring.waits == 0


@pytest.mark.parametrize("stride", [1, 2])
def test_device_frames_with_host_boxes_equal_the_all_host_run(cpu_estimator, stride):
    """A chunk whose frames are a tensor (the streaming scorer's shared
    window) and whose boxes are host rows: the frames are padded and cut on
    their device, the boxes staged, and the answers equal the run whose
    parts are all staged."""
    est = cpu_estimator if stride == 1 else _estimator("cpu", stride=stride)
    frames, ids, boxes = _track(16, 11, (40, 56))
    want = est.run_from_frames(frames, ids, boxes)
    before = est.upload_stats()
    got = est.run_from_frames(torch.as_tensor(frames), ids, boxes)
    for g, w in zip(got, want):
        assert g.shape == (11, 24, 3)
        np.testing.assert_array_equal(g, w)
    rows = 8 // stride
    assert est.upload_stats() == dict(before, staged_chunks=before["staged_chunks"] + 2,
                                      staged_bytes=before["staged_bytes"] + 2 * rows * 16)


def test_host_chunk_parts_are_host_rows_or_device_tensors(cpu_estimator):
    est = cpu_estimator
    frames, ids, boxes = _track(16, 11, (40, 56))
    seen = []
    run = est._run_chunked

    def recording(num_items, host_chunk, step_fn, chunk=0):
        seen.append(host_chunk(8, 8))
        return run(num_items, host_chunk, step_fn, chunk)

    est._run_chunked = recording
    try:
        est.run_from_frames(frames, ids, boxes)
        est.run_from_frames(torch.as_tensor(frames), ids, boxes)
    finally:
        del est._run_chunked
    (f, b), (ft, bt) = seen
    assert isinstance(f, HostRows) and f.source is frames
    np.testing.assert_array_equal(f.ids, ids[8:16])
    assert isinstance(b, HostRows) and np.array_equal(b.ids, np.arange(8, 11))
    assert isinstance(ft, torch.Tensor)
    np.testing.assert_array_equal(ft.numpy(), frames[ids[8:16]])
    assert isinstance(bt, HostRows)


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


HW = (256, 448)  # 4 rows a part of 1.38 MB: the gather's threads take it
N_POOL, N_TRACKED = 160, 93  # 12 chunks of 8, the last ragged (5 frames)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_host_pool_staged_bit_equal_to_device_pool(cuda_device, stride):
    est = _estimator(cuda_device, stride=stride, crop=224)
    frames, ids, boxes = _track(N_POOL, N_TRACKED, HW)
    got = est.run_from_frames(frames, ids, boxes)
    stats = est.upload_stats()
    want = est.run_from_frames(torch.as_tensor(frames, device=cuda_device), ids, boxes)
    for g, w in zip(got, want):
        assert g.shape == (N_TRACKED, 24, 3)
        np.testing.assert_array_equal(g, w)
    rows = 8 // stride
    assert stats == {"staged_chunks": 12,
                     "staged_bytes": 12 * rows * (HW[0] * HW[1] * 3 + 16),
                     "slot_waits": stats["slot_waits"]}
    # The device pool's chunks stage their boxes alone.
    after = est.upload_stats()
    assert after == dict(stats, staged_chunks=24, slot_waits=after["slot_waits"],
                         staged_bytes=stats["staged_bytes"] + 12 * rows * 16)


@pytest.mark.cuda
def test_host_crops_staged_bit_equal_to_plain_upload(cuda_device):
    est = _estimator(cuda_device, crop=224)
    crops = np.random.default_rng(5).random((21, 224, 224, 3), dtype=np.float32)
    got = est.run(crops)
    want = []
    with torch.inference_mode():
        for start in range(0, 21, 8):
            x = pad_to_multiple(torch.from_numpy(crops[start:start + 8]), 8)[0]
            out = est._pose_step(x.to(cuda_device))
            want.append([o.cpu().numpy()[:min(8, 21 - start)] for o in out])
    for g, w in zip(got, zip(*want)):
        np.testing.assert_array_equal(g, np.concatenate(w))
    assert est.upload_stats()["staged_chunks"] == 3
    assert est.upload_stats()["staged_bytes"] == 3 * 8 * crops[0].nbytes


@pytest.mark.cuda
def test_fetch_retry_restages_its_chunk(cuda_device):
    est = _estimator(cuda_device, crop=224)
    frames, ids, boxes = _track(N_POOL, N_TRACKED, HW)
    want = est.run_from_frames(torch.as_tensor(frames, device=cuda_device), ids, boxes)
    calls = _fail_first_readback(est, "_pose_step_from_frames")
    got = est.run_from_frames(frames, ids, boxes)
    assert len(calls) == 13
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # 12 chunks of the device pool's boxes, then 12 host chunks and the retry.
    assert est.upload_stats()["staged_chunks"] == 25
