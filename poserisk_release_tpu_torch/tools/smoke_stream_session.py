"""N camera sessions (serving.StreamSession) over one warm PoseScoringServer.

    SESS_STREAMS=3 SESS_FRAMES=24 SESS_STRIDE=4 python -m poserisk_release_tpu_torch.tools.smoke_stream_session

The counterpart of the JAX repo's tools/smoke_stream_session_tpu.py: the
per-stream serving surface (StreamSession + the server's bucket ladder 1 /
4 / 16, one CUDA graph per bucket on the card) on synthetic moving-person
frames at the production ingest size (450x800), pushed through
SESS_STREAMS sessions on threads sharing one warm server, each with a
bright-pixel box detector at detection stride SESS_STRIDE. Prints one JSON
line with the JAX tool's keys (per-request latency percentiles, the
cross-stream batch fills) plus the device and K1's launches. Runs on the
card; SESS_CPU=1 names the CPU.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

HW = (450, 800)
# The JAX tool's knobs and their defaults.
KNOBS = {"SESS_STREAMS": "3", "SESS_FRAMES": "24", "SESS_STRIDE": "4"}


class ContentBoxDetector:
    """A deterministic bright-pixel box: the box around every pixel whose
    channel mean exceeds 100, score 0.9 (no weights needed)."""

    def __call__(self, frames_rgb):
        out = []
        for f in np.asarray(frames_rgb):
            ys, xs = np.where(f.mean(axis=2) > 100)
            if len(xs) < 10:
                out.append(np.zeros((0, 5), np.float32))
            else:
                out.append(np.asarray([[xs.min(), ys.min(), xs.max(), ys.max(), 0.9]],
                                      np.float32))
        return out


def session_frame(stream: int, i: int) -> np.ndarray:
    """Stream `stream`'s frame i: a dark 450x800 frame with a filled
    160x310 block whose left edge moves 3 px a frame (the JAX tool's
    cv2.rectangle, both corners included, drawn with numpy)."""
    img = np.full((*HW, 3), 25, np.uint8)
    x = 60 + 40 * stream + 3 * i
    img[90:401, x:x + 161] = (190, 160, 140)
    return img


def knob(name: str) -> int:
    return int(os.environ.get(name, KNOBS[name]))


def run(device, n_streams: int, n_frames: int, stride: int) -> dict:
    """The sessions over one server on `device`; returns the JSON record."""
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.serving import PoseScoringServer, StreamSession
    from poserisk_release_tpu_torch.tools.timing import device_name

    k1 = crop_batch_cuda.launches
    t0 = time.perf_counter()
    with PoseScoringServer(frame_hw=HW, batch_sizes=(1, 4, 16), max_delay_ms=5.0,
                           device=device) as server:
        t_warm = time.perf_counter() - t0
        sessions = [StreamSession(server, detector=ContentBoxDetector(), detection_stride=stride,
                                  ring_capacity=64) for _ in range(n_streams)]
        futures = [[] for _ in range(n_streams)]

        def feed(s: int) -> None:
            for i in range(n_frames):
                futures[s].extend(sessions[s].push(session_frame(s, i)))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=feed, args=(s,)) for s in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [[(i, f.result(timeout=600)) for i, f in futs] for futs in futures]
        elapsed = time.perf_counter() - t0
        stats = server.stats()
    n_scored = sum(len(r) for r in results)
    return {
        "metric": "stream_session_requests_per_sec",
        "value": round(n_scored / elapsed, 2),
        "unit": f"scored frames/sec wall, {n_streams} sessions x {n_frames} frames, "
                f"stride {stride}, {HW[0]}x{HW[1]}",
        "scored": n_scored,
        "pushed": n_streams * n_frames,
        "warm_sec": round(t_warm, 1),
        "elapsed_sec": round(elapsed, 2),
        "batches": stats["batches"],
        "cross_stream_fills": stats["batch_fill"][-8:],
        "latency_p50_ms": round(stats.get("latency_p50", 0) * 1e3, 1),
        "latency_p99_ms": round(stats.get("latency_p99", 0) * 1e3, 1),
        "per_stream_reba_head": [[r.reba for _, r in res[:5]] for res in results],
        "device": device_name(device),
        "k1_launches": crop_batch_cuda.launches - k1,
    }


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch import _build
    from poserisk_release_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if os.environ.get("SESS_CPU", "0") == "1" else None)
    if device.type == "cuda":
        _build.build(["crop"])
    rec = run(device, knob("SESS_STREAMS"), knob("SESS_FRAMES"), knob("SESS_STRIDE"))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
