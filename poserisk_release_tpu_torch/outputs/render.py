"""Annotated result video, behaviour-parity renderer.

visualize_result parity (reference lib/core/base.py:284-327): 720-wide
resized frame + 280px black side panel; per-frame texts; score/box read at
the even-snapped track index idx//2*2 (base.py:312 quirk); 'Not detected
target' on frames outside the track; green bbox drawn with the reference's
corner math (vis_utils.py:278-294). Frames come from memory (no jpg re-read).

ResultVideoWriter writes the video window by window (the streaming
scorer's pass 2; render_result_video is its one-window case). Also the
--debug_frame 3D skeleton figure (vis_3d_pose, vis_utils.py parity). Own
copy of the JAX package's renderer. cv2 and matplotlib are imported inside
the functions, so importing the module needs neither.
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
    writer = ResultVideoWriter(output_path, title, fps, frames_rgb.shape[1:3], joint_names,
                               timestamp[1], bboxes)
    writer.write_window(frames_rgb, 0, scores, logs)
    return writer.close()


class ResultVideoWriter:
    """The annotated video written window by window (render_result_video is
    one window of the whole clip): the reference's canvas, codec and file
    name, with the track's scores/logs grown as windows are scored, as the
    streaming scorer needs.

    Fed in windows, the bytes equal one whole-clip write:
    compose_result_frame reads a track entry only at the even-snapped
    position of the CURRENT frame (idx//2*2 snaps down), so a frame can be
    written as soon as the window holding it has been scored."""

    def __init__(self, output_path: str, title: str, fps: float,
                 frame_hw, joint_names: Sequence[str],
                 track_frames: np.ndarray, bboxes: np.ndarray):
        import cv2

        height, width = int(frame_hw[0]), int(frame_hw[1])
        resize_w = 720
        resize_h = int(height * resize_w / width)
        self.out_file = osp.join(output_path, title + "_video.mp4")
        self._writer = cv2.VideoWriter(
            self.out_file, 0x7634706D, fps, (resize_w + 280, resize_h))
        self._title = title
        self._joint_names = joint_names
        self._track_frames = np.asarray(track_frames)
        self._bboxes = np.asarray(bboxes)

    def write_window(self, frames_rgb: np.ndarray, start_idx: int,
                     scores, logs) -> None:
        """scores/logs: the track-so-far lists in frame order; they must
        cover every track position up to this window's last selected frame,
        which holds when each window is scored before it is written."""
        scores = np.asarray(scores)
        for k in range(frames_rgb.shape[0]):
            self._writer.write(compose_result_frame(
                frames_rgb[k], start_idx + k, self._track_frames,
                self._bboxes, scores, self._joint_names, logs, self._title,
            ))

    def close(self) -> str:
        self._writer.release()
        return self.out_file


SMPL_RIGHT_JOINTS = (2, 5, 8, 11, 14, 17, 19, 21, 23)


def axis_equal_3d(ax) -> None:
    """Equalise a 3-D axes' aspect from its CURRENT limits
    (vis_utils.py:172-179 parity): each axis is re-centred on its midpoint
    with half-range = half the largest current extent. Called after
    vis_3d_pose's fixed +-800 limits it is an exact no-op, matching the
    reference's call order."""
    extents = np.array([getattr(ax, f"get_{dim}lim")() for dim in "xyz"])
    sz = extents[:, 1] - extents[:, 0]
    centers = np.mean(extents, axis=1)
    r = max(abs(sz)) / 2
    for ctr, dim in zip(centers, "xyz"):
        getattr(ax, f"set_{dim}lim")(ctr - r, ctr + r)


def vis_3d_pose(kps_3d: np.ndarray, skeleton: Sequence, file_path: str, frame: int = 0) -> None:
    """The reference's 3D skeleton figure of one frame's joints (mm)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    fig.set_size_inches(5, 3.75)

    for i1, i2 in skeleton:
        xs = np.array([kps_3d[i1, 0], kps_3d[i2, 0]])
        ys = np.array([kps_3d[i1, 1], kps_3d[i2, 1]])
        zs = np.array([kps_3d[i1, 2], kps_3d[i2, 2]])
        ax.plot(xs, zs, -ys, c="r", linewidth=1)
        for j in (i1, i2):
            c = "g" if j in SMPL_RIGHT_JOINTS else "b"
            ax.scatter(kps_3d[j, 0], kps_3d[j, 2], -kps_3d[j, 1], c=c, marker="o")

    ax.set_xlabel("X axis")
    ax.set_ylabel("Z axis")
    ax.set_zlabel("Y axis")
    ax.set_xlim3d(-800, 800)
    ax.set_ylim3d(-800, 800)
    ax.set_zlim3d(-800, 800)
    ax.set_title(f"3D Skeleton - frame: {frame}")
    axis_equal_3d(ax)  # reference call order (vis_utils.py:230); no-op here
    fig.savefig(file_path)
    plt.close(fig=fig)
