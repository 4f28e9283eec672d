"""The serve runner: an open loop of cameras against PoseScoringServer.

The server runs at the mix's buckets and coalescing delay, warm (every
bucket's CUDA graph captured in set-up). One generator thread walks the
merged schedule of all cameras and submits each request when it is due,
whatever the server is doing; each request is timed from its due time to
the moment its Future resolves, so a stall counts against every request
queued behind it. Set-up ends with `warmup_s` of the same open loop.
latency_p50_ms and latency_p95_ms are taken over every
request due in the window; a request that fails or does not finish within
a minute after the window counts in `failed`. The traced run profiles
`stretch_s` seconds from 30% of the window on.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from benchmark.core import check, faults, harness, program, trace, traffic, weights
from benchmark.reference import hmr as ref_hmr

WAIT_AFTER_S = 60.0


def build(cell: harness.Cell, mix: Dict, seed: int, device):
    """(server, the HMR weights it was handed, on the host)."""
    config = cell.config
    smpl_path = program.smpl_dir(seed)
    hmr_host = weights.to_host(weights.hmr_params(seed, device, config["assumed"]["init"],
                                                  tuple(mix["frame_hw"])))
    return program.server(config, mix, weights.to_device(hmr_host, device), smpl_path,
                          program.info(config), device), hmr_host


def warm(server, sched: traffic.Schedule, n: int) -> None:
    """Real requests through the dispatcher before the window: one burst
    that fills the largest bucket, then single requests."""
    futs = [server.submit(sched.frames[sched.frame[i % len(sched.frame)]],
                          sched.boxes[i % len(sched.boxes)]) for i in range(n)]
    for f in futs:
        f.result(timeout=120)
    for i in range(4):
        server.submit(sched.frames[sched.frame[i]], sched.boxes[i]).result(timeout=120)


class Answers:
    """Each request's answer kept in flat arrays (no Python object per
    request stays alive, so the collector's passes do not grow with the
    window), filled from the Futures' callbacks."""

    def __init__(self, n: int):
        self.done_at = np.full(n, np.nan)
        self.reba = np.zeros(n, np.int64)
        self.rula = np.zeros(n, np.int64)
        self.euler = np.zeros((n, 24, 3), np.float32)
        self.joints = np.zeros((n, 24, 3), np.float32)
        self.lock = threading.Lock()
        self.pending = n
        self.all_done = threading.Event()
        if n == 0:
            self.all_done.set()

    def callback(self, i: int):
        def done(fut):
            t = time.perf_counter()
            with self.lock:
                try:
                    if fut.exception() is None:
                        r = fut.result()
                        self.reba[i], self.rula[i] = r.reba, r.rula
                        self.euler[i], self.joints[i] = r.euler_deg, r.joint_cam_mm
                        self.done_at[i] = t
                finally:
                    self.pending -= 1
                    if self.pending == 0:
                        self.all_done.set()
        return done


def window(server, sched: traffic.Schedule, seconds: float, traced: bool, stretch_s: float):
    """Submits every request of the schedule at its due time; returns
    (latencies s (nan where missing), answers, lateness s, stretch, stats
    before, stats after)."""
    n = len(sched.due_s)
    answers = Answers(n)
    stats0 = server.stats()
    st = trace.Stretch()
    late = np.zeros(n)
    t0 = time.perf_counter() + 0.01
    for i in range(n):
        due = t0 + sched.due_s[i]
        if traced and st.prof is None and sched.due_s[i] >= 0.3 * seconds:
            st.start()
        if st.active and sched.due_s[i] >= 0.3 * seconds + stretch_s:
            st.end()
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - due
        with trace.span("submit", traced):
            fut = server.submit(sched.frames[sched.frame[i]], sched.boxes[i])
        fut.add_done_callback(answers.callback(i))
        del fut
    answers.all_done.wait(timeout=max(0.0, t0 + seconds + WAIT_AFTER_S - time.perf_counter()))
    st.stop()
    with answers.lock:
        lat = answers.done_at - (t0 + sched.due_s)
    return lat, answers, late, st, stats0, server.stats()


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        overrides: Dict = None) -> harness.RunRecord:
    overrides = overrides or {}
    mix, config = dict(cell.mix, **overrides.get("mix", {})), cell.config
    harness.note("start")
    sched = traffic.camera_schedule(mix, seed, seconds)
    harness.note("schedule and frames")
    server, hmr_host = build(cell, mix, seed, device)
    harness.note("weights and server (graphs captured)")
    warm(server, sched, int(mix["buckets"][-1]))
    # The open loop itself for warmup_s at the cell's rate (its own phases),
    # so the window starts on a server and host already in their steady state.
    window(server, traffic.camera_schedule(mix, seed + 1, float(mix["warmup_s"])),
           float(mix["warmup_s"]), False, 0.0)
    harness.note("warm requests and warm-up traffic")
    if overrides.get("fault"):
        server = faults.Server(server, overrides["fault"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    if traced:
        trace.prime()
    setup_s = harness.process_age_s()

    lat, answers, late, st, s0, s1 = window(server, sched, seconds, traced,
                                            float(mix["stretch_s"]))
    summary = st.summary()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    ok = np.isfinite(lat)
    print(f"[bench] generator lateness p50 {np.median(late) * 1e3:.3f} ms, "
          f"p99 {np.percentile(late, 99) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms",
          file=sys.stderr)
    e2e = {}
    if ok.any():
        e2e = {"latency_p50_ms": float(np.percentile(lat[ok], 50) * 1e3),
               "latency_p95_ms": float(np.percentile(lat[ok], 95) * 1e3)}
    n_batches = s1["batches"] - s0["batches"]
    fills = s1["batch_fill"][len(s0["batch_fill"]):] if len(s1["batch_fill"]) < 4096 \
        else s1["batch_fill"][-n_batches:]
    rec = harness.RunRecord(setup_s=setup_s, e2e=e2e, attempted=len(lat),
                            failed=int((~ok).sum()), memory_peak_bytes=peak, trace=summary)
    rec.serve = {"requests": s1["requests"] - s0["requests"], "batches": n_batches,
                 "fills": fills}

    def judge(control: bool = False):
        """The compared numbers and their limits; control=True puts the
        reference in TF32 in the program's place."""
        server.close()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        add_info = program.info(config)
        idx = np.flatnonzero(ok)
        pick = idx[traffic.sample(len(idx), int(mix["check_requests"]), seed)]
        smpl = {key: torch.from_numpy(v).to(device)
                for key, v in weights.smpl_arrays(seed).items()
                if key in ("v_template", "J_regressor")}
        hp = weights.to_device(hmr_host, device)
        frames, boxes = sched.frames[sched.frame[pick]], sched.boxes[pick]
        rot, ref_joints = check.reference_pose(hp, smpl, frames, boxes, device)
        if control:
            rot_c, joints = check.reference_pose(hp, smpl, frames, boxes, device, tf32=True)
            euler = ref_hmr.rotmat_to_euler_deg(torch.from_numpy(rot_c)).numpy()
            mism = 0
        else:
            euler, joints = answers.euler[pick], answers.joints[pick]
            mism = check.score_mismatch(answers.euler[idx], answers.reba[idx],
                                        answers.rula[idx], add_info)
        pose_nums = check.pose_numbers(euler, joints, rot, ref_joints)
        return check.judge(config["limits"], None, pose_nums, mism)

    rec.check = judge
    return rec
