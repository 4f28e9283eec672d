"""The one traffic generator: every mix is a data file under benchmark/traffic/.

A mix names its runner ("video" or "serve") and its parameters. From a
mix and a seed this module makes the frames, the tracked boxes and the
arrival schedule; the same seed gives the same inputs, and every seed
gives the same amount of work (sizes and counts come from the mix, only
contents and phases from the seed).

Frames are 450x800 uint8 RGB, the reference's ingest cap, drawn as the
port's synthetic clip draws them (a dark noise base, a filled rectangle and
a disc above it) at the positions of a person track. A track is a
person-sized box [cx, cy, s, s] (squared, as SORT's output is squared for
the crop) moving on slow sinusoids, standing in for the tracker's output.
"""

from __future__ import annotations

import json
import os.path as osp
from dataclasses import dataclass
from typing import Dict

import numpy as np

TRAFFIC_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "traffic")


def load_mix(name: str) -> Dict:
    with open(osp.join(TRAFFIC_DIR, name + ".json")) as f:
        return json.load(f)


def _rng(seed: int, salt: int) -> np.random.RandomState:
    return np.random.RandomState((int(seed) * 7919 + salt) % (2 ** 32))


def track_boxes(n: int, frame_hw, seed: int, salt: int = 0, start: int = 0) -> np.ndarray:
    """(n, 4) float32 [cx, cy, s, s] of one person track, frames start..start+n."""
    H, W = frame_hw
    r = _rng(seed, 100 + salt)
    phase = r.uniform(0, 2 * np.pi, 4)
    period = r.uniform(90, 240, 4)  # frames
    t = np.arange(start, start + n, dtype=np.float64)
    cx = W * (0.5 + 0.25 * np.sin(2 * np.pi * t / period[0] + phase[0]))
    cy = H * (0.55 + 0.08 * np.sin(2 * np.pi * t / period[1] + phase[1]))
    side = H * (0.7 + 0.15 * np.sin(2 * np.pi * t / period[2] + phase[2]))
    return np.stack([cx, cy, side, side], 1).astype(np.float32)


def _disc(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    H, W = img.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, H)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, W)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = color


def frames_for(boxes: np.ndarray, frame_hw, seed: int) -> np.ndarray:
    """(n, H, W, 3) uint8 frames, one person figure at each box."""
    H, W = frame_hw
    r = _rng(seed, 1)
    base = r.randint(0, 50, (H, W, 3)).astype(np.uint8)
    body = r.randint(110, 230, 3).astype(np.uint8)
    head = r.randint(110, 230, 3).astype(np.uint8)
    out = np.empty((len(boxes), H, W, 3), np.uint8)
    for i, (cx, cy, s, _) in enumerate(boxes):
        img = out[i]
        img[:] = base
        w, h = int(s * 0.3), int(s * 0.6)
        x0, y0 = int(cx - w / 2), int(cy - h / 3)
        img[max(y0, 0):max(y0 + h, 0), max(x0, 0):max(x0 + w, 0)] = body
        _disc(img, int(cx), int(y0 - s * 0.1), int(s * 0.09), head)
    return out


@dataclass
class VideoPlan:
    """A clip of pool frames, cycled: clip k's frames are the pool, its
    boxes the track's frames k * clip .. (k + 1) * clip."""
    frames: np.ndarray
    frame_hw: tuple
    clip: int
    window: int
    seed: int

    def boxes(self, k: int) -> np.ndarray:
        return track_boxes(self.clip, self.frame_hw, self.seed, 0, k * self.clip)


def video_plan(mix: Dict, seed: int) -> VideoPlan:
    hw = tuple(mix["frame_hw"])
    pool = int(mix["pool_frames"])
    frames = frames_for(track_boxes(pool, hw, seed), hw, seed)
    return VideoPlan(frames, hw, int(mix["clip_frames"]), int(mix["window"]), int(seed))


@dataclass
class Schedule:
    """Open-loop arrivals: request i is due at due_s[i] (seconds after the
    window opens) from camera cam[i], carrying pool frame frame[i] and
    box boxes[i]."""
    due_s: np.ndarray
    cam: np.ndarray
    frame: np.ndarray
    boxes: np.ndarray
    frames: np.ndarray


def camera_schedule(mix: Dict, seed: int, seconds: float) -> Schedule:
    """N cameras at `fps`, each with its phase drawn from the seed; every
    camera sends exactly floor(seconds * fps) requests in the window."""
    hw = tuple(mix["frame_hw"])
    n_cam, fps = int(mix["cameras"]), float(mix["fps"])
    per_cam = int(seconds * fps)
    pool = int(mix["pool_frames"])
    r = _rng(seed, 2)
    phase = r.uniform(0, 1.0 / fps, n_cam) if mix.get("phase", "seeded") == "seeded" \
        else np.zeros(n_cam)
    k = np.arange(per_cam)
    due = (phase[:, None] + k[None, :] / fps).reshape(-1)
    cam = np.repeat(np.arange(n_cam), per_cam)
    idx = np.argsort(due, kind="stable")
    due, cam = due[idx], cam[idx]
    step = np.concatenate([np.arange(per_cam)] * n_cam)[idx]
    boxes = np.empty((len(due), 4), np.float32)
    for c in range(n_cam):
        sel = cam == c
        boxes[sel] = track_boxes(per_cam, hw, seed, 1 + c)[step[sel]]
    frames = frames_for(track_boxes(pool, hw, seed), hw, seed)
    frame = (cam * 7 + step) % pool
    return Schedule(due, cam, frame.astype(np.int64), boxes, frames)


def sample(n_total: int, n: int, seed: int) -> np.ndarray:
    """Sorted indices of a sample of n out of n_total drawn from the seed."""
    return np.sort(_rng(seed, 3).permutation(n_total)[:n]).astype(np.int64)
