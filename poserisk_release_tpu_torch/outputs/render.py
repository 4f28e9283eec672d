"""Annotated result video, behaviour-parity renderer.

visualize_result parity (reference lib/core/base.py:284-327): 720-wide
resized frame + 280px black side panel; per-frame texts; score/box read at
the even-snapped track index idx//2*2 (base.py:312 quirk); 'Not detected
target' on frames outside the track; green bbox drawn with the reference's
corner math (vis_utils.py:278-294). Frames come from memory (no jpg re-read).

ResultVideoWriter writes the video window by window (the streaming
scorer's pass 2; render_result_video is its one-window case). Also the
--debug_frame 3D skeleton figure (vis_3d_pose, vis_utils.py parity), the
2-D keypoint overlays (vis_coco_skeleton, vis_keypoints,
vis_keypoints_with_skeleton, vis_2d_pose) and the joint-cam video
(render_joint_cam_video). Own copy of the JAX package's renderer. cv2 and matplotlib are imported inside
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


# ---------------------------------------------------------------------------
# 2-D keypoint overlays and the joint-cam video (the JAX renderer's extras).
# ---------------------------------------------------------------------------
COCO_PART_COLORS = (
    # face x4, left arm x2, right leg x2, left leg x2, shoulder/hip links x4,
    # center body x2, right arm x2 (vis_utils.py:28-62 palette, RGB 0-1)
    (1.0, 0.6, 0.2), (1.0, 0.6, 0.2), (1.0, 0.6, 0.2), (1.0, 0.6, 0.2),
    (0.4, 1.0, 0.4), (0.2, 1.0, 0.2),
    (1.0, 0.4, 1.0), (1.0, 0.2, 1.0),
    (1.0, 0.4, 0.4), (1.0, 0.2, 0.2),
    (0.6, 1.0, 0.6), (0.6, 0.8, 1.0), (1.0, 0.6, 0.6), (1.0, 0.6, 1.0),
    (1.0, 0.8, 0.6), (1.0, 0.7, 0.4),
    (0.4, 0.7, 1.0), (0.2, 0.6, 1.0),
)


def vis_coco_skeleton(img_bgr: np.ndarray, kps_2xk: np.ndarray, skeleton,
                      given_color=(0, 1, 0), alpha: float = 1.0) -> np.ndarray:
    """Single-color skeleton overlay (vis_utils.py:27-91 behaviour: edges and
    endpoint circles in the given color, alpha-blended). Quirk preserved:
    the reference scales given_color WITHOUT the R/B swap it applies to its
    palette (vis_utils.py:64-65), so a non-symmetric given_color draws with
    its channels in RGB order on the BGR canvas -- exactly as upstream."""
    import cv2

    color = (given_color[0] * 255, given_color[1] * 255, given_color[2] * 255)
    canvas = np.ascontiguousarray(img_bgr, np.uint8).copy()
    for i1, i2 in skeleton:
        p1 = (int(kps_2xk[0, i1]), int(kps_2xk[1, i1]))
        p2 = (int(kps_2xk[0, i2]), int(kps_2xk[1, i2]))
        cv2.line(canvas, p1, p2, color=color, thickness=2, lineType=cv2.LINE_AA)
        cv2.circle(canvas, p1, radius=2, color=color, thickness=3, lineType=cv2.LINE_AA)
        cv2.circle(canvas, p2, radius=2, color=color, thickness=3, lineType=cv2.LINE_AA)
    return cv2.addWeighted(np.ascontiguousarray(img_bgr, np.uint8), 1.0 - alpha, canvas, alpha, 0)


def vis_keypoints(img_bgr: np.ndarray, kps: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Rainbow keypoint dots (vis_utils.py:94-112 behaviour)."""
    import cv2
    import matplotlib

    cmap = matplotlib.colormaps["rainbow"]
    colors = [cmap(i) for i in np.linspace(0, 1, len(kps) + 2)]
    colors = [(c[2] * 255, c[1] * 255, c[0] * 255) for c in colors]
    canvas = np.ascontiguousarray(img_bgr, dtype=np.uint8).copy()
    for i, point in enumerate(kps):
        cv2.circle(canvas, (int(point[0]), int(point[1])), radius=3,
                   color=colors[i], thickness=-1, lineType=cv2.LINE_AA)
    return cv2.addWeighted(np.ascontiguousarray(img_bgr, np.uint8), 1.0 - alpha, canvas, alpha, 0)


def vis_keypoints_with_skeleton(
    img_bgr: np.ndarray, kps_3xk: np.ndarray, skeleton: Sequence,
    kp_thresh: float = 0.4, alpha: float = 1.0,
) -> np.ndarray:
    """Skeleton edges + joints, colored per edge (vis_utils.py:115-151)."""
    import cv2
    import matplotlib

    cmap = matplotlib.colormaps["rainbow"]
    colors = [cmap(i) for i in np.linspace(0, 1, len(skeleton))]
    colors = [(c[2] * 255, c[1] * 255, c[0] * 255) for c in colors]
    canvas = np.ascontiguousarray(img_bgr, np.uint8).copy()
    for l, (i1, i2) in enumerate(skeleton):
        p1 = (int(kps_3xk[0, i1]), int(kps_3xk[1, i1]))
        p2 = (int(kps_3xk[0, i2]), int(kps_3xk[1, i2]))
        if kps_3xk[2, i1] > kp_thresh and kps_3xk[2, i2] > kp_thresh:
            cv2.line(canvas, p1, p2, color=colors[l], thickness=2, lineType=cv2.LINE_AA)
        if kps_3xk[2, i1] > kp_thresh:
            cv2.circle(canvas, p1, radius=3, color=colors[l], thickness=-1, lineType=cv2.LINE_AA)
        if kps_3xk[2, i2] > kp_thresh:
            cv2.circle(canvas, p2, radius=3, color=colors[l], thickness=-1, lineType=cv2.LINE_AA)
    return cv2.addWeighted(np.ascontiguousarray(img_bgr, np.uint8), 1.0 - alpha, canvas, alpha, 0)


def vis_2d_pose(pred_xy: np.ndarray, img_bgr, skeleton: Sequence,
                out_dir: str, prefix: str = "vis2dpose") -> str:
    """2-D pose overlay jpg, parity with the reference's vis_2d_pose
    (reference lib/utils/vis_utils.py:154-170): (K, 2+) predictions
    with confidence forced to 1, drawn with the per-edge rainbow skeleton,
    written '{prefix}_{isoformat}_2d_joint.jpg'. The reference writes into
    its global cfg.vis_dir; here the directory is an argument. Returns the
    written path."""
    import datetime
    import os
    import os.path as osp

    import cv2

    if isinstance(img_bgr, str):
        img_bgr = cv2.imread(img_bgr, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    canvas = np.ascontiguousarray(img_bgr, np.uint8).copy()
    kps = np.ones((3, len(pred_xy)))
    kps[0, :], kps[1, :] = pred_xy[:, 0], pred_xy[:, 1]
    canvas = vis_keypoints_with_skeleton(canvas, kps, skeleton)
    now = datetime.datetime.now()
    file_name = f"{prefix}_{now.isoformat()[:-7]}_2d_joint.jpg"
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, file_name)
    cv2.imwrite(path, canvas)
    return path


def render_joint_cam_video(
    joint_cams: np.ndarray,  # (T, J, 3) mm
    track_frames: np.ndarray,
    skeleton: Sequence,
    output_path: str,
    fps: float = 20.0,
    even_snap: bool = True,
) -> str:
    """Working rebuild of the reference's visualize_joint_cam debug method
    (base.py:399-420, which crashes on an undefined variable): renders the
    per-frame 3D skeleton figures and stitches estimation_result.mp4,
    preserving the j//2*2 even-index snap."""
    import os
    import tempfile

    import cv2

    tmp_dir = tempfile.mkdtemp(prefix="joint_cam_")
    paths = []
    for j, frame_id in enumerate(track_frames):
        idx = (j // 2 * 2) if even_snap else j
        path = osp.join(tmp_dir, f"joint_cam_{int(frame_id)}.png")
        vis_3d_pose(joint_cams[min(idx, len(joint_cams) - 1)], skeleton, path,
                    frame=int(frame_id))
        paths.append(path)

    first = cv2.imread(paths[0])
    h, w = first.shape[:2]
    out_file = osp.join(output_path, "estimation_result.mp4")
    writer = cv2.VideoWriter(out_file, 0x7634706D, fps, (w, h))
    for p in paths:
        canvas = cv2.resize(cv2.imread(p), (w, h), interpolation=cv2.INTER_AREA)
        writer.write(np.uint8(canvas))
    writer.release()
    for p in paths:
        os.remove(p)
    os.rmdir(tmp_dir)
    return out_file
