"""Annotated result video, behaviour-parity renderer.

visualize_result parity (reference lib/core/base.py:284-327): 720-wide
resized frame + 280px black side panel; per-frame texts; score/box read at
the even-snapped track index idx//2*2 (base.py:312 quirk); 'Not detected
target' on frames outside the track; green bbox drawn with the reference's
corner math (vis_utils.py:278-294). Frames come from memory (no jpg re-read).

Own copy of the JAX package's renderer. cv2 is imported inside the functions
so that importing the module needs no opencv. The 3D pose figure belongs to
the debug_frame path, which arrives with the full vertex LBS.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np


def draw_box_cxcywh(img_bgr: np.ndarray, box: np.ndarray) -> np.ndarray:
    import cv2

    img = img_bgr.copy()
    color, thickness = (0, 255, 0), 2
    x_min = int(box[0]) - int(box[2]) // 2
    y_min = int(box[1]) - int(box[3]) // 2
    x_max = int(box[0]) + int(box[2]) // 2
    y_max = int(box[1]) + int(box[3]) // 2
    img = cv2.line(img, (x_min, y_min), (x_min, y_max), color, thickness)
    img = cv2.line(img, (x_min, y_min), (x_max, y_min), color, thickness)
    img = cv2.line(img, (x_min, y_max), (x_max, y_max), color, thickness)
    img = cv2.line(img, (x_max, y_min), (x_max, y_max), color, thickness)
    return img


def compose_result_frame(
    frame_rgb: np.ndarray,  # (H, W, 3) uint8 clip frame
    i: int,  # clip frame index
    track_frames: np.ndarray,  # (T,) frame indices of the target track
    bboxes: np.ndarray,  # (T, 4) cxcywh of the target track
    scores: np.ndarray,  # (T,) per-track-frame final scores
    joint_names: Sequence[str],
    logs: np.ndarray,  # (T, len(joint_names)) log entries
    title: str = "REBA",
) -> np.ndarray:
    """ONE pre-encode output canvas (BGR uint8), the reference's per-frame
    loop body (base.py:305-325): side-panel texts, even-snapped (idx//2*2)
    score/box reads, 'Not detected target' branch, INTER_AREA frame resize
    into the left 720 columns. Split from the writer loop so pixel-parity
    tests compare canvases BEFORE the lossy mp4 encode
    (tests/test_render_pixel_parity.py vs the reference restatement oracle).

    Dtype note: the reference draws on a float64 canvas and casts with
    np.uint8 at write time; OpenCV 5's putText asserts CV_8U, so both this
    renderer and the oracle draw on uint8 directly. AA text rasterized on
    uint8 rounds where the float canvas truncated -- a cv2-4.x-only LSB
    class on antialiased glyph edges, gone on any cv2 that can still run
    the reference."""
    import cv2

    height, width = frame_rgb.shape[0], frame_rgb.shape[1]
    resize_w = 720
    resize_h = int(height * resize_w / width)
    canvas_w = resize_w + 280
    canvas_h = resize_h

    font = cv2.FONT_HERSHEY_SIMPLEX
    color = (255, 255, 255)
    canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    img = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR)

    cv2.putText(canvas, "frame: " + str(i), (resize_w + 15, canvas_h - 14),
                font, 0.5, color, 1, cv2.LINE_AA)

    if i in track_frames:
        idx = int(np.where(track_frames == i)[0][0])
        idx = idx // 2 * 2  # reference quirk: even-index snap
        img = draw_box_cxcywh(img, bboxes[idx])
        cv2.putText(canvas, title + " Score: " + str(scores[idx]),
                    (resize_w + 15, 35), font, 0.7, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.putText(canvas, "- Score per Joints ", (resize_w + 15, 122),
                    font, 0.6, color, 1, cv2.LINE_AA)
        for j, joint in enumerate(joint_names):
            cv2.putText(canvas, joint + ": " + str(logs[idx][j]),
                        (resize_w + 15, 153 + 24 * j), font, 0.5, color, 1, cv2.LINE_AA)
    else:
        cv2.putText(canvas, "Not detected target", (resize_w + 15, canvas_h - 65),
                    font, 0.6, color, 1, cv2.LINE_AA)

    img = cv2.resize(img, (resize_w, resize_h), interpolation=cv2.INTER_AREA)
    canvas[:resize_h, :resize_w, :] = img
    return canvas


def render_result_video(
    frames_rgb: np.ndarray,  # (N, H, W, 3) uint8, ALL frames of the clip
    bboxes: np.ndarray,  # (T, 4) cxcywh of the target track
    timestamp,  # (0, track_frames, total_frames)
    fps: float,
    scores: np.ndarray,  # (T,) per-track-frame final scores
    joint_names: Sequence[str],
    logs: np.ndarray,  # (T, len(joint_names)) log entries
    output_path: str,
    title: str = "REBA",
) -> str:
    import cv2

    height, width = frames_rgb.shape[1], frames_rgb.shape[2]
    resize_w = 720
    resize_h = int(height * resize_w / width)
    canvas_w = resize_w + 280
    canvas_h = resize_h

    out_file = osp.join(output_path, title + "_video.mp4")
    writer = cv2.VideoWriter(out_file, 0x7634706D, fps, (canvas_w, canvas_h))
    track_frames = timestamp[1]

    for i in range(frames_rgb.shape[0]):
        writer.write(compose_result_frame(
            frames_rgb[i], i, track_frames, bboxes, scores, joint_names,
            logs, title,
        ))
    writer.release()
    return out_file
