"""The harness on the CPU: names resolve, traffic is seeded, arrivals are
timed from their due time, the cost counts add up, and nothing loads JAX."""

import json
import os.path as osp
import re
import subprocess
import sys
import threading
import time
from collections import namedtuple
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark import costs
from benchmark.core import harness, serve, traffic

BENCH = harness.load_benchmark()
ScoredPose = namedtuple("ScoredPose", "reba rula euler_deg joint_cam_mm")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = harness.resolve(BENCH, w["name"])
        assert cell.mix["runner"] in ("video", "serve")
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moves = {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert m["moves"] in moves, (w["name"], m["name"])
            mod = harness.reader(m["name"])
            assert mod.MOVES == m["moves"] and callable(mod.read)


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and osp.isfile(osp.join(harness.ROOT, c["file"]))
        with open(osp.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_readers_return_nothing_without_a_trace():
    rec = harness.RunRecord(setup_s=1.0, e2e={}, attempted=1, failed=0, memory_peak_bytes=0)
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"]).read(rec) is None


@pytest.mark.parametrize("mix", ["video_windows"])
def test_video_traffic_is_seeded(mix):
    m = dict(traffic.load_mix(mix), pool_frames=6, clip_frames=6, frame_hw=[45, 80])
    a, b, c = (traffic.video_plan(m, s) for s in (2 ** 31 + 5, 2 ** 31 + 5, 17))
    assert np.array_equal(a.frames, b.frames) and np.array_equal(a.boxes(3), b.boxes(3))
    assert not np.array_equal(a.frames, c.frames)
    assert a.frames.shape == c.frames.shape and a.boxes(0).shape == c.boxes(0).shape


@pytest.mark.parametrize("mix", ["serve_cameras", "serve_1cam"])
def test_camera_schedule_is_seeded_and_every_seed_sends_as_much(mix):
    m = dict(traffic.load_mix(mix), pool_frames=3, frame_hw=[45, 80])
    a, b, c = (traffic.camera_schedule(m, s, 2.0) for s in (7, 7, 2 ** 31 + 11))
    assert np.array_equal(a.due_s, b.due_s) and np.array_equal(a.boxes, b.boxes)
    assert len(a.due_s) == len(c.due_s) == int(m["cameras"]) * int(2.0 * m["fps"])
    assert np.all(np.diff(a.due_s) >= 0)
    for cam in range(int(m["cameras"])):
        d = np.diff(a.due_s[a.cam == cam])
        assert np.allclose(d, 1.0 / m["fps"])


class _SlowServer:
    """Answers each request `delay` s after it is submitted; the submit of
    request `stall_at` blocks `stall` s first, as a busy server would."""

    def __init__(self, delay, stall_at, stall):
        self.delay, self.stall_at, self.stall, self.n = delay, stall_at, stall, 0

    def stats(self):
        return {"requests": self.n, "batches": self.n, "batch_fill": []}

    def submit(self, frame, bbox):
        self.n += 1
        if self.n - 1 == self.stall_at:
            time.sleep(self.stall)
        fut = Future()
        answer = ScoredPose(1, 1, np.zeros((24, 3)), np.zeros((24, 3)))
        threading.Timer(self.delay, fut.set_result, args=(answer,)).start()
        return fut


def test_latency_counts_from_the_due_time():
    sched = traffic.Schedule(due_s=np.arange(20) * 0.01, cam=np.zeros(20, int),
                             frame=np.zeros(20, int), boxes=np.zeros((20, 4), np.float32),
                             frames=np.zeros((1, 2, 2, 3), np.uint8))
    lat, results, late, _st, _s0, _s1 = serve.window(_SlowServer(0.005, 10, 0.1), sched,
                                                     0.2, False, 0.0)
    assert np.all(np.isfinite(lat))
    assert np.all(lat[:10] < 0.05)
    # The stall delays request 10 and all behind it due within it: their
    # latency holds the wait, measured from when each was due.
    assert lat[10] >= 0.1 and lat[11] >= 0.09 and late[11] >= 0.08


def test_conv_flops_against_a_hand_sum():
    # 3x3 conv, 32 -> 64 channels, on a 16x8 output: 2 * 9 * 32 * 64 * 128.
    assert costs.conv_flops(32, 64, 3, 16, 8) == 2 * 9 * 32 * 64 * 128
    assert abs(costs.yolo_flops(416, 416) / 1e9 - 65.86) < 0.01  # darknet's BFLOPs
    assert abs(costs.hmr_flops() / 1e9 - 8.195) < 0.01


def test_kernel_bytes_against_hand_sums():
    # A box wholly outside the frame reads nothing: the output alone.
    out = 224 * 224 * 3 * 4
    assert costs.k1_bytes(np.array([[-900.0, -900.0, 100.0, 100.0]]), 450, 800) == out
    # A box inside the frame: count the source pixels by walking the samples.
    box = (400.0, 225.0, 300.0, 300.0)
    step = 300.0 * 1.2 / 224
    seen = []
    for c, size in ((box[1], 450), (box[0], 800)):
        idx = set()
        for o in range(224):
            x = c + (o - 112) * step
            i0 = int(np.floor(x))
            idx.add(i0)
            if x - i0 > 0:
                idx.add(i0 + 1)
        seen.append(len(idx))
    assert costs.k1_bytes(np.array([box]), 450, 800) == out + seen[0] * seen[1] * 3
    # The rect letterbox of 450x800 onto 416x288 reads every source row and
    # column, and writes the whole f32 canvas.
    r, c, ch, cw = costs.letterbox_source_sets(450, 800)
    assert (ch, cw, len(r), len(c)) == (288, 416, 450, 800)
    assert costs.k2_bytes(2, 450, 800) == 2 * (288 * 416 * 3 * 4 + 450 * 800 * 3)


def test_a_fresh_interpreter_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.costs, benchmark.control, benchmark.sweep\n"
            "from benchmark.core import harness, check, serve, video, trace, traffic, weights\n"
            "from benchmark.reference import hmr, yolo, rules, precision\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'poserisk_release_tpu'}\n"
            "assert not bad, bad\n") % harness.ROOT
    subprocess.run([sys.executable, "-c", code], check=True, cwd=harness.ROOT)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import hmr, yolo, rules, precision\n"
            "from benchmark.core import check\n"
            "import benchmark.costs\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'poserisk_release_tpu_torch', 'jax', 'poserisk_release_tpu'}\n"
            "assert not bad, bad\n") % harness.ROOT
    subprocess.run([sys.executable, "-c", code], check=True, cwd=harness.ROOT)


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True)
    if "is_available() is False" not in out.stderr:
        pytest.skip("this machine has a CUDA card")
    assert out.returncode != 0 and out.stdout.strip() == ""
