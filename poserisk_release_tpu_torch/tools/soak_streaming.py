"""A long-clip --streaming soak: the two-pass StreamingScorer over thousands of frames.

    SOAK_FRAMES=10240 python -m poserisk_release_tpu_torch.tools.soak_streaming

The counterpart of the JAX repo's tools/soak_streaming_tpu.py: SOAK_FRAMES
(10240) synthetic frames of SOAK_H x SOAK_W (180x320) through the
two-pass streaming.StreamingScorer (the --streaming CLI path's engine) at
window SOAK_WINDOW (256), fast (bf16 SPIN) unless SOAK_FAST=0, with the
Predictor's detector policy (pipeline.build_detector: the full-frame stub
without YOLO weights). Records the wall-clock frames/s, the peak host RSS
(the bounded-memory claim), the scored-frame count and the card's
max_memory_allocated. Prints one JSON line with the JAX tool's keys.

The frames come from an in-memory stream in place of the video decoder
(streaming._window_stream; a moving filled block on a dark frame, each
window made when the scorer asks for it), so no mp4 is written and opencv
is not needed: clip_write_sec is the stream's set-up, clip_mb is None.
One window of frames goes through the scorer first, outside the count, so
rss_before holds what loading the libraries' kernels takes. Runs on the
card; SOAK_CPU=1 names the CPU.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

# The JAX tool's knobs and their defaults.
KNOBS = {"SOAK_FRAMES": "10240", "SOAK_H": "180", "SOAK_W": "320", "SOAK_WINDOW": "256",
         "SOAK_FAST": "1"}


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


class PeakRss:
    """The peak of rss_mb(), sampled every `period` s on a thread while
    the context is open."""

    def __init__(self, period: float = 0.05):
        self.period = period
        self.peak = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_mb())
            time.sleep(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2)


def soak_frame(i: int, h: int, w: int) -> np.ndarray:
    """Frame i of the soak clip: the JAX tool's frame (a dark frame and a
    filled block, both corners included, moving 1 px a frame and wrapping
    every w // 3 frames), drawn with numpy."""
    img = np.full((h, w, 3), 30, np.uint8)
    x = int(w * 0.15) + (i % max(1, w // 3))
    img[h // 8:h - h // 8 + 1, x:x + w // 4 + 1] = (180, 150, 130)
    return img


class SoakStream:
    """In-memory stand-in for io/video._window_stream: the same items,
    ("meta", fps), ("window", start, frames), ("end", total)."""

    def __init__(self, n_frames: int, h: int, w: int):
        self.n_frames, self.h, self.w = n_frames, h, w

    def __call__(self, video_path, window, max_frames, workers=1):
        total = self.n_frames if max_frames is None else min(self.n_frames, max_frames)
        yield ("meta", 30.0)
        for start in range(0, total, window):
            n = min(window, total - start)
            yield ("window", start, np.stack([soak_frame(start + k, self.h, self.w)
                                              for k in range(n)]))
        yield ("end", total)


def knob(name: str) -> int:
    return int(os.environ.get(name, KNOBS[name]))


def run(device, frames: int, h: int, w: int, window: int, fast: bool) -> dict:
    """The soak on `device`; returns the JSON record."""
    from poserisk_release_tpu_torch import streaming
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
    from poserisk_release_tpu_torch.pipeline import build_detector, load_add_info
    from poserisk_release_tpu_torch.tools.timing import device_name, peak_bytes

    cfg = default_config()
    info = load_add_info(cfg, "")
    t0 = time.perf_counter()
    source = SoakStream(frames, h, w)
    t_write = time.perf_counter() - t0
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)
    scorer = streaming.StreamingScorer(cfg=cfg, detector=build_detector(cfg, device=device),
                                       window=window, fast=fast, device=device)
    real = streaming._window_stream
    try:
        # One window first, uncounted: the libraries' lazily loaded kernels
        # and the allocators' first blocks are not the clip's memory.
        streaming._window_stream = SoakStream(min(window, frames), h, w)
        scorer("synthetic.mp4", info)
        k1 = crop_batch_cuda.launches
        streaming._window_stream = source
        rss_before = rss_mb()
        with PeakRss() as rss:
            t0 = time.perf_counter()
            result = scorer("synthetic.mp4", info)
            elapsed = time.perf_counter() - t0
    finally:
        streaming._window_stream = real
    return {
        "metric": "streaming_soak_fps",
        "value": round(frames / elapsed, 2),
        "unit": f"frames/sec wall-clock, two-pass --streaming, {h}x{w}, window {window}"
                f"{', bf16' if fast else ''}, in-memory frames",
        "frames": frames,
        "frames_scored": len(result.frames),
        "elapsed_sec": round(elapsed, 1),
        "clip_write_sec": round(t_write, 1),
        "clip_mb": None,
        "decoded_clip_mb": round(frames * h * w * 3 / 1e6, 1),
        "rss_before_mb": round(rss_before, 1),
        "rss_peak_mb": round(rss.peak, 1),
        "rss_growth_mb": round(rss.peak - rss_before, 1),
        "reba_stats": [float(x) for x in result.stats("reba")],
        "device": device_name(device),
        "max_memory_allocated": peak_bytes(device),
        "k1_launches": crop_batch_cuda.launches - k1,
    }


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch import _build
    from poserisk_release_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if os.environ.get("SOAK_CPU", "0") == "1" else None)
    if device.type == "cuda":
        _build.build(["crop"])
    rec = run(device, knob("SOAK_FRAMES"), knob("SOAK_H"), knob("SOAK_W"), knob("SOAK_WINDOW"),
              os.environ.get("SOAK_FAST", KNOBS["SOAK_FAST"]) == "1")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
