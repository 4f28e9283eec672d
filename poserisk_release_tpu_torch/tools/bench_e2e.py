"""Wall-clock end-to-end Predictor benchmark of the port, host stages included.

    python -m poserisk_release_tpu_torch.tools.bench_e2e [--frames 600] [--synthetic]
        [--no_plots] [--render] [--decode_workers N] [--cpu]

The counterpart of the JAX repo's tools/bench_e2e.py. It times what a user
runs: a clip -> decode -> detect + track (overlapped) -> crop -> SPIN ->
angles -> scoring -> stats, plots and result txts (+ the annotated video
with --render), through pipeline.Predictor with fast=True, and prints one
JSON line: the JAX tool's keys (metric e2e_wallclock_fps, value, unit,
elapsed_sec, stage_timings_sec from Predictor.timings) plus `decoder`.

The detector runs the real YOLOv3 forward (rect canvas, int8, calibrated
explicitly on 8 seeded frames before the warm-up) on every window; its
boxes come from random weights, so RealComputeStubBoxDetector replaces them
with a fixed person box and the track stays scoreable. A warm clip of
window + remainder frames and the scorers at the measured length warm
every shape before the timed run.

The clip is synth_video's: a dark noise base, a moving rectangle and a
circle (the JAX tool's frames, pixel for pixel). By default it is written
as an mp4 and decoded with opencv (`decoder: cv2`). --synthetic hands the
same frames to the Predictor in place of the decoder instead
(io.video._window_stream replaced by SyntheticStream, `decoder:
synthetic`): for a machine without opencv; the "decode" in the stage split
is then a copy of each window. Without opencv and without --synthetic the
tool raises; it never switches sources by itself. Likewise the score plots
need matplotlib: --no_plots skips them (the unit says so), and without
matplotlib and without --no_plots the tool raises.

It runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os.path as osp
import tempfile
import time

import numpy as np

WINDOW = 64
FRAME_W, FRAME_H = 800, 450


class RealComputeStubBoxDetector:
    """Runs the real detector forward on each window, returns a fixed box
    [0.3 W, 0.1 H, 0.7 W, 0.95 H, 0.99] per frame."""

    def __init__(self, yolo):
        self.yolo = yolo

    def __call__(self, frames_rgb):
        self.yolo(frames_rgb)  # the device work happens here
        N, H, W = frames_rgb.shape[0], frames_rgb.shape[1], frames_rgb.shape[2]
        box = np.array([[W * 0.3, H * 0.1, W * 0.7, H * 0.95, 0.99]], np.float32)
        return [box.copy() for _ in range(N)]


def _fill_circle(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """opencv's filled circle (cv2.circle, thickness -1, 8-connected, no
    shift): its midpoint walk, one horizontal span per row it reaches."""
    H, W = img.shape[:2]

    def span(y, x1, x2):
        if 0 <= y < H and x2 >= 0 and x1 < W:
            img[y, max(x1, 0):min(x2, W - 1) + 1] = color

    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def synth_frames(n_frames: int, w: int = FRAME_W, h: int = FRAME_H) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames of the JAX tool's synth_video, drawn
    with numpy: the seeded base, a filled rectangle moving 1 px a frame
    (40-frame cycle), a filled circle above it."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 50, (h, w, 3)).astype(np.uint8)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    for i in range(n_frames):
        img = frames[i]
        img[:] = base
        x = int(w * 0.3) + (i % 40)
        img[45:int(h * 0.9) + 1, x:x + int(w * 0.25) + 1] = (180, 150, 130)
        _fill_circle(img, x + int(w * 0.12), 80, 25, (200, 180, 160))
    return frames


def synth_video(path: str, n_frames: int, w: int = FRAME_W, h: int = FRAME_H,
                fps: float = 30.0) -> None:
    """synth_frames written as an mp4 (needs opencv)."""
    from poserisk_release_tpu_torch.io.video import write_video

    write_video(synth_frames(n_frames, w, h), fps=fps, file_path=path)


class SyntheticStream:
    """Stands in for io.video._window_stream on frames made in advance: the
    same items, ("meta", fps), ("window", start, frames RGB), ("end",
    total). Each window is a fresh RGB copy of the BGR frames, what decoding
    their mp4 yields but for its compression."""

    def __init__(self, frames_bgr: np.ndarray, fps: float = 30.0):
        self.frames, self.fps = frames_bgr, fps

    def __call__(self, video_path, window, max_frames, workers=1):
        total = len(self.frames) if max_frames is None else min(len(self.frames), max_frames)
        yield ("meta", self.fps)
        for start in range(0, total, window):
            stop = min(start + window, total)
            yield ("window", start, np.ascontiguousarray(self.frames[start:stop, :, :, ::-1]))
        yield ("end", total)


@contextlib.contextmanager
def _replaced(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _require(module: str, flag: str, what: str) -> None:
    try:
        importlib.import_module(module)
    except ImportError as exc:
        raise RuntimeError(
            f"bench_e2e needs {module} to {what}; pass {flag} to run without it") from exc


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=600)
    parser.add_argument("--render", action="store_true",
                        help="include the annotated-video render stage")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--decode_workers", type=int, default=1,
                        help="decode threads (io.video.iter_windows_parallel)")
    parser.add_argument("--synthetic", action="store_true",
                        help="feed the frames in place of the video decoder (no opencv)")
    parser.add_argument("--no_plots", action="store_true",
                        help="skip the score plots (no matplotlib)")
    args = parser.parse_args(argv)

    from poserisk_release_tpu_torch import pipeline
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.io import video
    from poserisk_release_tpu_torch.models.detector import (
        YoloDetector,
        fold_bn_params,
        init_yolo_params,
    )

    device = resolve_device("cpu" if args.cpu else None)
    if not args.synthetic:
        _require("cv2", "--synthetic", "write and decode the clip")
    if not args.no_plots:
        _require("matplotlib", "--no_plots", "plot the scores")

    yolo = YoloDetector(params=fold_bn_params(init_yolo_params()), batch_size=WINDOW,
                        rect=True, int8=True, device=device)
    # Calibrated before the warm-up, so the warm run already takes the int8
    # path (else the first call calibrates on its first window).
    yolo.calibrate(np.random.RandomState(1).randint(0, 256, (8, FRAME_H, FRAME_W, 3))
                   .astype(np.uint8))
    # Through DatasetConfig, so a bad worker count raises as in the CLI.
    cfg = default_config().replace(DATASET={"decode_workers": args.decode_workers})
    predictor = pipeline.Predictor(cfg=cfg, detector=RealComputeStubBoxDetector(yolo),
                                   visualize=args.render, fast=True, device=device)
    warm_frames = WINDOW + (args.frames % WINDOW or WINDOW)

    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        if args.no_plots:
            plain = pipeline.post_process_scores
            stack.enter_context(_replaced(
                pipeline, "post_process_scores",
                lambda *a, **kw: plain(*a, **dict(kw, make_plot=False))))

        def run(n_frames: int, name: str, clip=None):
            """Run the Predictor on an n-frame clip; returns its seconds
            (the clip is made or written before the clock starts)."""
            path = osp.join(tmp, name + ".mp4")
            if args.synthetic:
                with _replaced(video, "_window_stream", SyntheticStream(clip)):
                    t0 = time.perf_counter()
                    predictor(path, "/nonexistent.json", osp.join(tmp, name))
                    return time.perf_counter() - t0
            synth_video(path, n_frames)
            t0 = time.perf_counter()
            predictor(path, "/nonexistent.json", osp.join(tmp, name))
            return time.perf_counter() - t0

        # The warm clip hits the measured run's shapes: full windows plus
        # the trailing remainder window.
        run(warm_frames, "warm", synth_frames(warm_frames) if args.synthetic else None)
        # Scoring chunks by frame count: warm the scorers at the measured
        # length.
        add_info = pipeline.load_add_info(predictor.cfg, "/nonexistent.json")
        zeros = np.zeros((args.frames, 24, 3))
        predictor.reba(zeros, None, add_info)
        predictor.rula(zeros, None, add_info)
        elapsed = run(args.frames, "out",
                      synth_frames(args.frames) if args.synthetic else None)

    fps = args.frames / elapsed
    record = {
        "metric": "e2e_wallclock_fps",
        "value": round(fps, 2),
        "unit": f"frames/sec end-to-end (decode+detect+track+crop+SPIN+score"
                f"{'+render' if args.render else ''}{', no plots' if args.no_plots else ''}"
                f", wall clock)",
        "elapsed_sec": round(elapsed, 3),
        "stage_timings_sec": {k: round(v, 3) for k, v in predictor.timings.items()},
        "decoder": "synthetic" if args.synthetic else "cv2",
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
