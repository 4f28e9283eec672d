"""The port's PoseScoringServer and StreamSession against the JAX package's.

One JAX server (the small configuration of tests/test_serving.py: 64x64
crops, 64x96 frames, buckets 1 and 4) and one port server on the CPU with
the JAX server's SPIN weights (through the weight bridge) serve the same
requests. The port server on the CPU runs its step eagerly; on the card each
bucket is a CUDA graph, held against the eager step by the `cuda` test at
the end (skipped here) and by chip_smoke.py's serving_path.

Tolerances, as in tests/test_torch_pose.py: integer scores exact, Euler
angles within 1e-2 deg (with the +-180 wrap) and joints within 1e-2 mm. A
request's port result is also held bit for bit against the port's eager
path at the same batch shape (run_from_frames with chunk = bucket).

int8: each package calibrates its backbone by its own f32 walk, whose scales
agree within 1e-5 relative (tests/test_torch_int8_pipeline.py), so the
tests hold the port server's calibration to the JAX server's, then hand the
JAX quantized dicts to the port and hold the served result to the port's
eager int8 path on them.

Frames are drawn with numpy (the port's machine has no cv2). Nothing here
draws from the session `rng` fixture.
"""

import json
import os.path as osp
import sys
import threading
import time

import numpy as np
import pytest
import torch

import poserisk_release_tpu_torch as _pkg
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict, resnet_params_from_jax
from poserisk_release_tpu_torch.scoring.reba import REBAScorer
from poserisk_release_tpu_torch.scoring.rula import RULAScorer
from poserisk_release_tpu_torch.serving import PoseScoringServer, ScoredPose, StreamSession
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

with open(osp.join(osp.dirname(_pkg.__file__), "default_information.json")) as _f:
    INFO = json.load(_f)
HW = (64, 96)


def _requests(n, seed=0):
    """tests/test_serving.py's requests: noise frames, boxes drifting by 1 px."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)
    boxes = np.stack([np.array([48.0 + i, 32.0, 20.0 + i, 24.0], np.float32)
                      for i in range(n)])
    return frames, boxes


class _ContentBoxDetector:
    """tests/test_serving.py's detector: the bounding box of bright pixels,
    whatever the batching."""

    def __call__(self, frames_rgb):
        out = []
        for f in np.asarray(frames_rgb):
            ys, xs = np.where(f.mean(axis=2) > 100)
            out.append(np.zeros((0, 5), np.float32) if len(xs) < 10 else np.asarray(
                [[xs.min(), ys.min(), xs.max(), ys.max(), 0.9]], np.float32))
        return out


def _jax():
    """The JAX package's serving module and config, imported only by the
    tests that compare with it (the card's machine has no JAX)."""
    from poserisk_release_tpu import serving
    from tests.test_serving import _cfg

    return serving, _cfg


def _tree(x):
    import jax

    return jax.tree_util.tree_map(np.asarray, x)


def _cfg(**sections):
    return default_config().replace(MODEL={"input_shape": (64, 64)},
                                    PARALLEL={"frames_per_step": 4}).replace(**sections)


@pytest.fixture(scope="module")
def jax_server():
    serving, jax_cfg = _jax()
    srv = serving.PoseScoringServer(cfg=jax_cfg(), batch_sizes=(1, 4), max_delay_ms=500.0, frame_hw=HW,
                    warm=True)
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def variables(jax_server):
    return flax_to_state_dict(_tree(jax_server.estimator.variables))


@pytest.fixture(scope="module")
def server(variables):
    srv = PoseScoringServer(cfg=_cfg(), batch_sizes=(1, 4), max_delay_ms=500.0, frame_hw=HW,
                            warm=True, spin_variables=variables, device="cpu")
    yield srv
    srv.close()


def _port_server(variables, **kw):
    kw = {"cfg": _cfg(), "frame_hw": HW, "spin_variables": variables, "device": "cpu", **kw}
    return PoseScoringServer(**kw)


def _close(got: ScoredPose, want: ScoredPose):
    assert (got.reba, got.rula) == (want.reba, want.rula)
    assert got.euler_deg.shape == got.joint_cam_mm.shape == (24, 3)
    assert got.euler_deg.dtype == got.joint_cam_mm.dtype == np.float32
    d = np.abs(got.euler_deg - want.euler_deg)
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), 1e-2)  # deg, +-180 wrap
    np.testing.assert_allclose(got.joint_cam_mm, want.joint_cam_mm, atol=1e-2)  # mm


def _eager(server, frames, boxes, chunk):
    """The port's eager path at the bucket's batch shape: run_from_frames +
    the scorers."""
    euler, joint_cam, _ = server.estimator.run_from_frames(
        frames, np.arange(len(frames)), boxes, chunk=chunk)
    reba = [r["score"] for r in REBAScorer(device="cpu")(euler, joint_cam, INFO)]
    rula = [r["score"] for r in RULAScorer(device="cpu")(euler, joint_cam, INFO)]
    return reba, rula, euler, joint_cam


def _equal_to_eager(results, eager):
    reba, rula, euler, joint_cam = eager
    for i, res in enumerate(results):
        assert (res.reba, res.rula) == (reba[i], rula[i])
        np.testing.assert_array_equal(res.euler_deg, euler[i])
        np.testing.assert_array_equal(res.joint_cam_mm, joint_cam[i])


def test_single_request_matches_jax_server(jax_server, server):
    frames, boxes = _requests(1)
    got = server.score(frames[0], boxes[0], timeout=120)
    assert isinstance(got, ScoredPose)
    _close(got, jax_server.score(frames[0], boxes[0], timeout=120))
    _equal_to_eager([got], _eager(server, frames, boxes, chunk=1))


def test_coalesced_batch_pads_to_bucket_and_matches_jax(jax_server, server):
    """3 concurrent requests coalesce into ONE padded bucket-4 batch on both
    servers, and the port's results equal its eager path on the padded
    batch."""
    frames, boxes = _requests(3, seed=1)
    before = server.stats()["batches"]
    got = [f.result(timeout=120) for f in [server.submit(frames[i], boxes[i])
                                           for i in range(3)]]
    assert server.stats()["batch_fill"][before:] == [(3, 4)]
    want = [f.result(timeout=120) for f in [jax_server.submit(frames[i], boxes[i])
                                            for i in range(3)]]
    for g, w in zip(got, want):
        _close(g, w)
    _equal_to_eager(got, _eager(server, frames, boxes, chunk=4))


def test_threaded_submits_all_resolve(jax_server, server):
    """More client threads than cores, with a short switch interval: every
    future resolves and the counters lose no update."""
    n_threads, per_thread = 16, 2
    frames, boxes = _requests(n_threads, seed=2)
    out = [[] for _ in range(n_threads)]
    before = server.stats()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            for _ in range(per_thread):
                out[i].append(server.score(frames[i], boxes[i], timeout=120))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(len(o) == per_thread and all(isinstance(r, ScoredPose) for r in o)
               for o in out)
    after = server.stats()
    fills = after["batch_fill"][len(before["batch_fill"]):]
    assert after["requests"] - before["requests"] == sum(n for n, _ in fills) == 32
    assert after["batches"] - before["batches"] == len(fills)
    _close(out[0][0], jax_server.score(frames[0], boxes[0], timeout=120))


def test_shape_and_dtype_contract(server):
    frames, boxes = _requests(1)
    with pytest.raises(ValueError, match="frame shape"):
        server.submit(np.zeros((32, 32, 3), np.uint8), boxes[0])
    with pytest.raises(ValueError, match="uint8"):
        server.submit(frames[0].astype(np.float32), boxes[0])
    with pytest.raises(ValueError):
        server.submit(frames[0], np.zeros((2,), np.float32))


def test_constructor_contracts():
    with pytest.raises(ValueError, match="batch_sizes"):
        PoseScoringServer(cfg=_cfg(), batch_sizes=(4, 1), warm=False, device="cpu")
    with pytest.raises(ValueError, match="pose_stride"):
        PoseScoringServer(cfg=_cfg(SPIN={"pose_stride": 2}), warm=False, device="cpu")
    # A mesh needs a process group (tests/test_torch_parallel_ranks.py
    # serves on gloo ranks, the spatial axis among them).
    with pytest.raises(RuntimeError, match="process group"):
        PoseScoringServer(cfg=_cfg(PARALLEL={"num_devices": 2}), warm=False, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        PoseScoringServer(cfg=_cfg(PARALLEL={"spatial": 2}), warm=False, device="cpu")


def test_latency_metrics_populated(server):
    stats = server.stats()
    assert stats["requests"] >= 1
    assert stats["latency_p50"] > 0
    assert stats["latency_p99"] >= stats["latency_p50"]


def test_closed_server_rejects_and_close_is_idempotent(variables):
    srv = _port_server(variables, batch_sizes=(1,), warm=False)
    srv.close()
    srv.close()
    frames, boxes = _requests(1)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(frames[0], boxes[0])


def test_failed_bucket_fails_its_futures_and_server_recovers(variables):
    srv = _port_server(variables, batch_sizes=(1,), warm=True, max_delay_ms=0.0)
    try:
        frames, boxes = _requests(2, seed=10)
        real = srv._run_bucket
        calls = {"n": 0}

        def flaky(frames_, boxes_, allow_calibration=True):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device failure")
            return real(frames_, boxes_, allow_calibration)

        srv._run_bucket = flaky
        with pytest.raises(RuntimeError, match="transient device failure"):
            srv.score(frames[0], boxes[0], timeout=120)
        assert isinstance(srv.score(frames[1], boxes[1], timeout=120), ScoredPose)
    finally:
        srv.close()


def test_prefailed_future_does_not_poison_its_batch(variables):
    srv = _port_server(variables, batch_sizes=(4,), warm=True, max_delay_ms=0.0)
    # Park the dispatcher so both requests land in the queue before any
    # batch is collected.
    srv._closed.set()
    srv._thread.join(timeout=10)
    srv._closed.clear()
    frames, boxes = _requests(2, seed=6)
    fut_raced = srv.submit(frames[0], boxes[0])
    fut_ok = srv.submit(frames[1], boxes[1])
    fut_raced.set_exception(RuntimeError("raced with close"))
    t = threading.Thread(target=srv._dispatch_loop, daemon=True)
    t.start()
    try:
        assert isinstance(fut_ok.result(timeout=120), ScoredPose)
        with pytest.raises(RuntimeError, match="raced"):
            fut_raced.result(timeout=10)
    finally:
        srv._closed.set()
        t.join(timeout=10)
        srv.close()


def test_submit_racing_close_never_leaves_a_hung_future(variables):
    srv = _port_server(variables, batch_sizes=(1,), warm=False)
    frames, boxes = _requests(1)
    real_stage = srv._stage

    def close_then_stage(*args):  # the worst-case interleaving, made certain
        srv.close()
        real_stage(*args)

    srv._stage = close_then_stage
    fut = srv.submit(frames[0], boxes[0])
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)


class _Gate:
    """Holds the server's batches inside _run_bucket until released (the
    step slowed to a stop), recording each batch's host rows: the slot's
    base address and a copy of its real frames."""

    def __init__(self, srv, monkeypatch):
        self.entered, self.release = threading.Event(), threading.Event()
        self.slots, self.frames = [], []
        real = srv._run_bucket

        def run(frames, boxes, allow_calibration=True):
            self.slots.append(frames.data_ptr())
            self.frames.append(frames.numpy().copy())
            self.entered.set()
            self.release.wait(timeout=60)
            return real(frames, boxes, allow_calibration)

        monkeypatch.setattr(srv, "_run_bucket", run)


def test_padded_batch_rows_and_answers_equal_the_eager_step(server, monkeypatch):
    """2 requests in bucket 4: the step sees the 2 staged rows and pad rows
    holding the last real request, and each answer is bit-equal to the step
    on the batch the dispatcher used to stack (np.stack with edge repeats)."""
    frames, boxes = _requests(2, seed=13)
    seen = []
    step = server._steps[4]

    def recording(f, b):
        seen.append((f.numpy().copy(), b.numpy().copy()))
        return step(f, b)

    monkeypatch.setitem(server._steps, 4, recording)
    got = [f.result(timeout=120) for f in [server.submit(frames[i], boxes[i])
                                           for i in range(2)]]
    (f_in, b_in), = seen
    np.testing.assert_array_equal(f_in, frames[[0, 1, 1, 1]])
    np.testing.assert_array_equal(b_in, boxes[[0, 1, 1, 1]])
    with torch.inference_mode():
        want = step(torch.from_numpy(np.stack([frames[0], frames[1], frames[1], frames[1]])),
                    torch.from_numpy(np.stack([boxes[0], boxes[1], boxes[1], boxes[1]])))
    want = tuple(w.numpy() for w in want)
    _equal_to_eager(got, want)
    _equal_to_eager(got, _eager(server, frames, boxes, chunk=4))


def test_caller_reusing_its_buffers_after_submit_keeps_its_answer(server):
    """submit() owns its inputs once it returns: the caller overwrites its
    frame and box at once, before the batch runs, and the answer is the
    original request's."""
    frames, boxes = _requests(1, seed=14)
    frame, box = frames[0].copy(), boxes[0].copy()
    fut = server.submit(frame, box)
    frame[:] = 0
    box[:] = (1.0, 1.0, 2.0, 2.0)
    _equal_to_eager([fut.result(timeout=120)], _eager(server, frames, boxes, chunk=1))


def test_requests_during_a_batch_land_in_the_other_slot(server, monkeypatch):
    """While the first batch is held in its step, 2 more requests are
    written into another slot and resolve in the next batch."""
    frames, boxes = _requests(3, seed=15)
    gate = _Gate(server, monkeypatch)
    before = server.stats()
    first = server.submit(frames[0], boxes[0])
    assert gate.entered.wait(timeout=60)
    later = [server.submit(frames[i], boxes[i]) for i in (1, 2)]
    assert server.stats()["queue_depth"] == 2
    assert not any(f.done() for f in [first] + later)
    gate.release.set()
    got = [f.result(timeout=120) for f in [first] + later]
    after = server.stats()
    assert after["batch_fill"][len(before["batch_fill"]):] == [(1, 1), (2, 4)]
    assert len(gate.slots) == 2 and gate.slots[0] != gate.slots[1]
    np.testing.assert_array_equal(gate.frames[1], frames[1:])
    _equal_to_eager(got[:1], _eager(server, frames[:1], boxes[:1], chunk=1))
    _equal_to_eager(got[1:], _eager(server, frames[1:], boxes[1:], chunk=4))


def test_burst_beyond_two_slots_grows_the_pool_without_blocking(variables, monkeypatch):
    """130 requests arrive while the first batch is held: submit() never
    waits for the dispatcher (the burst ends with the batch still held),
    the pool grows past its two slots, and every future resolves, in
    batches of the slots' rows (64, 64, 2) after the held one."""
    srv = _port_server(variables, warm=False, max_delay_ms=1.0)
    try:
        frames, boxes = _requests(8, seed=16)
        gate = _Gate(srv, monkeypatch)
        first = srv.submit(frames[0], boxes[0])
        assert gate.entered.wait(timeout=60)
        futs = []
        burst = threading.Thread(target=lambda: futs.extend(
            srv.submit(frames[i % 8], boxes[i % 8]) for i in range(130)))
        burst.start()
        burst.join(timeout=60)
        assert not burst.is_alive()
        held = srv.stats()
        assert held["slot_grows"] >= 1 and held["queue_depth"] == 130
        gate.release.set()
        assert all(isinstance(f.result(timeout=300), ScoredPose) for f in [first] + futs)
        stats = srv.stats()
        assert [n for n, _ in stats["batch_fill"]] == [1, 64, 64, 2]
        assert stats["requests"] == 131
        assert stats["queue_depth"] == 0
    finally:
        srv.close()


class _HeldRows:
    """A slot's frame rows whose writes wait for a gate: a submit's copy
    that is still running when its batch closes."""

    def __init__(self, rows, gate):
        self.rows, self.gate = rows, gate

    def __setitem__(self, i, value):
        self.gate.wait(timeout=60)
        self.rows[i] = value


def test_batch_waits_for_a_reserved_rows_copy(variables):
    """The deadline closes a slot whose one row is still being copied: the
    dispatcher counts a copy wait, runs nothing until the row is written,
    and the answer is the written frame's."""
    srv = _port_server(variables, batch_sizes=(1, 4), warm=False, max_delay_ms=1.0)
    try:
        frames, boxes = _requests(1, seed=18)
        gate = threading.Event()
        for slot in srv._free:
            slot.frames_np = _HeldRows(slot.frames_np, gate)
        futs = []
        submitter = threading.Thread(target=lambda: futs.append(srv.submit(frames[0], boxes[0])))
        submitter.start()
        deadline = time.monotonic() + 60
        while srv.stats()["copy_waits"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = srv.stats()
        assert stats["copy_waits"] == 1 and stats["batches"] == 0
        gate.set()
        submitter.join(timeout=60)
        assert not submitter.is_alive()
        _equal_to_eager([futs[0].result(timeout=120)], _eager(srv, frames, boxes, chunk=1))
        assert srv.stats()["requests"] == 1
    finally:
        srv.close()


def test_request_counters_lose_no_update_after_a_threaded_run(server):
    """Every request of a threaded run (more client threads than cores, a
    short switch interval) is written straight into a slot and answered:
    the request total and the batches' fills lose no update."""
    n_threads, per_thread = 12, 3
    frames, boxes = _requests(n_threads, seed=17)
    before = server.stats()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            for _ in range(per_thread):
                server.submit(frames[i], boxes[i]).result(timeout=120)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = server.stats()
    assert after["requests"] - before["requests"] == 36
    assert sum(n for n, _ in after["batch_fill"][len(before["batch_fill"]):]) == 36
    assert after["queue_depth"] == 0
    assert 0 <= after["copy_waits"] <= after["batches"]


def _assert_same_calibration(port_q, jax_q):
    assert sorted(port_q) == sorted(jax_q)
    for name in jax_q:
        np.testing.assert_array_equal(port_q[name]["qkernel"], jax_q[name]["qkernel"])
        np.testing.assert_array_equal(port_q[name]["w_scale"], jax_q[name]["w_scale"])
        rel = abs(float(port_q[name]["in_scale"]) / float(jax_q[name]["in_scale"]) - 1.0)
        assert rel < 1e-5, (name, rel)


def _jax_quant(jax_srv):
    return resnet_params_from_jax(_tree(jax_srv.estimator._quant_backbone))


def test_spin_int8_warmup_never_calibrates_on_zeros(variables):
    """Warm-up frames are black; the first REAL batch calibrates, on both
    servers alike (the same scales). With the JAX quantized dicts handed
    across, the captured-anew step serves the port's eager int8 result. (Its
    angles are not held to the JAX server's: on these random weights an
    ulp of f32 epilogue moves activations at .5 ties of the next conv by an
    int8 step, 2.3 deg here, tests/test_torch_int8_pipeline.py.)"""
    from poserisk_release_tpu.ops.crop import crop_batch as jax_crop_batch

    frames, boxes = _requests(1, seed=3)
    serving, jax_cfg = _jax()
    jax_srv = serving.PoseScoringServer(cfg=jax_cfg(), batch_sizes=(1,), frame_hw=HW,
                                        warm=False, spin_int8=True)
    srv = _port_server(variables, batch_sizes=(1,), warm=True, spin_int8=True)
    try:
        assert srv.estimator.spin_needs_calibration  # zeros did NOT calibrate
        res = srv.score(frames[0], boxes[0], timeout=120)
        assert not srv.estimator.spin_needs_calibration  # the real batch did
        again = srv.score(frames[0], boxes[0], timeout=120)
        np.testing.assert_array_equal(again.euler_deg, res.euler_deg)
        # The JAX server's first-batch calibration (its _run_bucket) on the
        # same batch, without compiling its int8 step.
        jax_srv.estimator._ensure_spin_quantized(jax_crop_batch(
            frames, boxes, scale=1.2, out_size=64))
        jax_q = _jax_quant(jax_srv)
        _assert_same_calibration(srv.estimator.quant_params, jax_q)
        srv.estimator.load_quant_backbone(jax_q)
        srv._release_steps()
        srv._steps = srv._build_steps()
        handed = srv.score(frames[0], boxes[0], timeout=120)
        _equal_to_eager([handed], _eager(srv, frames, boxes, chunk=1))
    finally:
        srv.close()
        jax_srv.close()


def test_spin_int8_explicit_calibration_crops(variables):
    """calibration_crops quantize before any request, and the served result
    is the port's eager int8 path's on that backbone."""
    frames, boxes = _requests(1, seed=4)
    calib = np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    srv = _port_server(variables, batch_sizes=(1,), warm=False, spin_int8=True,
                       calibration_crops=calib)
    try:
        assert not srv.estimator.spin_needs_calibration
        res = srv.score(frames[0], boxes[0], timeout=120)
        _equal_to_eager([res], _eager(srv, frames, boxes, chunk=1))
    finally:
        srv.close()


def _person_frame(x, shade=190, bg=25):
    img = np.full((*HW, 3), bg, np.uint8)
    img[10:55, x:x + 29] = (shade, 160, 140)
    return img


def test_stream_session_copies_pending_frames(server):
    """A caller reusing ONE capture buffer across pushes scores as a caller
    passing fresh frames: frames waiting in the backfill ring are copies."""

    def run(reuse):
        sess = StreamSession(server, detector=_ContentBoxDetector(), detection_stride=4,
                             ring_capacity=16)
        buf = np.zeros((*HW, 3), np.uint8)
        futs = []
        for i in range(5):
            frame = _person_frame(8 + i, shade=150 + 20 * i)
            if reuse:
                buf[:] = frame
                futs.extend(sess.push(buf))
                buf[:] = 0  # the caller recycles its buffer at once
            else:
                futs.extend(sess.push(frame))
        return [(i, f.result(timeout=120)) for i, f in futs]

    reused, fresh = run(True), run(False)
    assert [i for i, _ in reused] == [i for i, _ in fresh] == list(range(5))
    for (_, a), (_, b) in zip(reused, fresh):
        assert (a.reba, a.rula) == (b.reba, b.rula)
        np.testing.assert_array_equal(a.euler_deg, b.euler_deg)


def test_stream_session_backfill_covers_gaps(server):
    sess = StreamSession(server, detector=_ContentBoxDetector(), detection_stride=4,
                         ring_capacity=16)
    assert sess.target_id is None
    out = sess.push(_person_frame(8))  # detection step 0: locks on and scores
    assert [i for i, _ in out] == [0]
    for j in (1, 2, 3):
        assert sess.push(_person_frame(8 + j)) == []  # pending in the ring
    out = sess.push(_person_frame(12))  # detection step 4: backfills 1..3
    assert [i for i, _ in out] == [1, 2, 3, 4]
    for _i, fut in out:
        assert isinstance(fut.result(timeout=120), ScoredPose)
    assert sess.target_id is not None


def test_stream_session_matches_jax_session(jax_server, server):
    """One camera at detection_stride 4 through a session on each server:
    the same frames scored, the same scores, angles and joints within the
    tolerances."""
    frames = [_person_frame(4 + 2 * i) for i in range(10)]
    got, want = [], []
    jax_session = _jax()[0].StreamSession
    for srv, cls, out in ((server, StreamSession, got), (jax_server, jax_session, want)):
        sess = cls(srv, detector=_ContentBoxDetector(), detection_stride=4, ring_capacity=16)
        futs = [pair for frame in frames for pair in sess.push(frame)]
        out.extend((i, f.result(timeout=180)) for i, f in futs)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(9))
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)


def test_pose_and_score_step_copies_nothing_from_the_host(server, monkeypatch):
    """The bucket step is capturable: after a first call it makes no tensor
    from host data and reads nothing back (no .item/.cpu/.numpy), so a CUDA
    graph can record it (the rule tables are cached per device)."""
    frames, boxes = _requests(4, seed=11)
    step = server._make_step()
    f, b = torch.from_numpy(frames), torch.from_numpy(boxes)
    with torch.inference_mode():
        want = step(f, b)

    def refuse(*args, **kwargs):
        raise AssertionError("host copy or sync inside the step")

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.inference_mode():
        got = step(f, b)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bucket graphs exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bucket_graph_replay_matches_eager_step(cuda_device):
    """On the card each bucket is a captured graph; its replay equals the
    eager step at the same batch shape, from a caller's arrays and from a
    slot's rows with n < bucket, and each replay launches K1 once."""
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

    frames, boxes = _requests(4, seed=12)
    with PoseScoringServer(cfg=_cfg(), batch_sizes=(1, 4), frame_hw=HW, warm=True,
                           max_delay_ms=0.0, device=cuda_device) as srv:
        for b in (1, 4):
            bucket = srv._steps[b]
            assert bucket.graph is not None and bucket.k1_per_replay == 1
            launches = crop_batch_cuda.launches
            got = srv._run_bucket(frames[:b], boxes[:b])
            assert crop_batch_cuda.launches == launches + 1
            with torch.inference_mode():
                want = srv._make_step()(torch.as_tensor(frames[:b], device=cuda_device),
                                        torch.as_tensor(boxes[:b], device=cuda_device))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.cpu().numpy())
        # The dispatcher's path: 3 rows written into a pinned slot, replayed
        # in bucket 4 with the pad row filled on the card, bit-equal to the
        # eager step on the batch padded on the host.
        slot = srv._new_slot()
        assert slot.frames.is_pinned()
        slot.frames_np[:3], slot.boxes_np[:3] = frames[:3], boxes[:3]
        launches = crop_batch_cuda.launches
        got = srv._run_bucket(slot.frames[:3], slot.boxes[:3])
        assert crop_batch_cuda.launches == launches + 1
        padded = [0, 1, 2, 2]
        with torch.inference_mode():
            want = srv._make_step()(torch.as_tensor(frames[padded], device=cuda_device),
                                    torch.as_tensor(boxes[padded], device=cuda_device))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.cpu().numpy())
