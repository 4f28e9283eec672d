"""Keypoint-driven bbox derivation + temporal smoothing (host-side).

Port of the reference's optional keypoint crop path: smooth_bbox.py
(reference lib/utils/smooth_bbox.py:9-121, itself from
akanazawa/human_dynamics) plus CropDataset's joints2d branch
(reference data/demo_dataset.py:46-53), which converts the smoothed
[cx, cy, scale] params back to square person-height boxes via
150/scale. Never hit on the demo path (joints2d=None) but part of the
library surface. Own copy of the JAX package's io/keypoints.py (numpy and
scipy).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import medfilt

PERSON_TARGET_PX = 150.0


def kp_to_bbox_param(kp: Optional[np.ndarray], vis_thresh: float) -> Optional[np.ndarray]:
    """(K, 3) keypoints -> [cx, cy, scale] with scale = 150/person_height,
    or None when invisible/degenerate."""
    if kp is None:
        return None
    kp = np.asarray(kp)
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    person_height = float(np.linalg.norm(max_pt - min_pt))
    if person_height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    return np.append(center, PERSON_TARGET_PX / person_height)


def get_all_bbox_params(
    kps: Sequence[Optional[np.ndarray]], vis_thresh: float = 2
) -> Tuple[np.ndarray, int, int]:
    """Per-frame bbox params with linear interpolation over gaps.

    Returns (params (M, 3), start_index inclusive, end_index exclusive) over
    the input frame range, matching the reference's loop semantics (leading/
    trailing missing frames are dropped, interior gaps interpolated).
    """
    params: List[np.ndarray] = []
    start_index = -1
    gap = 0
    i = -1
    for i, kp in enumerate(kps):
        p = kp_to_bbox_param(kp, vis_thresh)
        if p is None:
            gap += 1
            continue
        if start_index == -1:
            start_index = i
            gap = 0
        if gap > 0:
            prev = params[-1]
            interp = np.stack(
                [np.linspace(a, b, gap + 2) for a, b in zip(prev, p)]
            ).T[1:-1]
            params.extend(interp)
            gap = 0
        params.append(np.asarray(p, np.float64))
    # Non-empty results are float64 like the reference's (its float32 empty
    # seed promotes on the first vstack with a float64 param row); only the
    # all-missing case keeps the float32 empty.
    stacked = np.stack(params) if params else np.empty((0, 3), np.float32)
    return stacked, start_index, i - gap + 1


def smooth_bbox_params(
    bbox_params: np.ndarray, kernel_size: int = 11, sigma: float = 8
) -> np.ndarray:
    """Median then gaussian filtering per parameter trajectory."""
    med = np.stack([medfilt(t, kernel_size) for t in bbox_params.T]).T
    return np.stack([gaussian_filter1d(t, sigma) for t in med.T]).T


def get_smooth_bbox_params(
    kps: Sequence[Optional[np.ndarray]],
    vis_thresh: float = 2,
    kernel_size: int = 11,
    sigma: float = 3,
) -> Tuple[np.ndarray, int, int]:
    params, start, end = get_all_bbox_params(kps, vis_thresh)
    smoothed = smooth_bbox_params(params, kernel_size, sigma)
    smoothed = np.vstack((np.zeros((start, 3)), smoothed))
    return smoothed, start, end


def bboxes_from_joints2d(
    joints2d: Sequence[Optional[np.ndarray]], vis_thresh: float = 0.3
) -> Tuple[np.ndarray, int, int]:
    """The CropDataset joints2d branch (demo_dataset.py:46-53): raw (not
    smoothed) params, scale inverted back to person-height pixels, square
    boxes. Returns (bboxes (M, 4) cxcywh, time_pt1, time_pt2)."""
    params, t0, t1 = get_all_bbox_params(joints2d, vis_thresh=vis_thresh)
    if t0 == -1:
        raise ValueError("no visible keypoints in any frame")
    side = PERSON_TARGET_PX / params[:, 2]
    bboxes = np.stack([params[:, 0], params[:, 1], side, side]).T
    return bboxes.astype(np.float32), t0, t1


# ---------------------------------------------------------------------------
# Training-preprocessing keypoint utilities (reference _img_utils.py)
# ---------------------------------------------------------------------------
def get_bbox_from_kp2d(kp_2d: np.ndarray) -> np.ndarray:
    """Keypoints -> square-ish [cx, cy, w, h] bbox, parity with the reference
    (reference lib/utils/_img_utils.py:295-313): extent of the points,
    aspect kept by w = h = max(w, h) (elementwise via np.where) scaled 1.1.
    Accepts (K, 2+) for one frame or (T, K, 2+) batched -> (4,) or (4, T)
    (the reference's transposed batched layout, kept as-is)."""
    kp_2d = np.asarray(kp_2d)
    if kp_2d.ndim > 2:
        ul = np.array([kp_2d[:, :, 0].min(axis=1), kp_2d[:, :, 1].min(axis=1)])
        lr = np.array([kp_2d[:, :, 0].max(axis=1), kp_2d[:, :, 1].max(axis=1)])
    else:
        ul = np.array([kp_2d[:, 0].min(), kp_2d[:, 1].min()])
        lr = np.array([kp_2d[:, 0].max(), kp_2d[:, 1].max()])
    w = lr[0] - ul[0]
    h = lr[1] - ul[1]
    c_x, c_y = ul[0] + w / 2, ul[1] + h / 2
    w = h = np.where(w / h > 1, w, h)
    w = h = h * 1.1
    return np.array([c_x, c_y, w, h])


def normalize_2d_kp(kp_2d: np.ndarray, crop_size: int = 224, inv: bool = False) -> np.ndarray:
    """Map crop-pixel keypoints to [-1, 1] (or back with inv=True), parity
    with the reference (reference lib/utils/_img_utils.py:315-324)."""
    kp_2d = np.asarray(kp_2d, np.float64)
    ratio = 1.0 / crop_size
    if not inv:
        return 2.0 * kp_2d * ratio - 1.0
    return (kp_2d + 1.0) / (2 * ratio)


def affine_transform_points(kp_2d: np.ndarray, cx: float, cy: float,
                            width: float, height: float, out_w: int, out_h: int,
                            scale: float, rot_deg: float = 0.0) -> np.ndarray:
    """Apply the crop warp's forward affine to (K, 2) points -- the closed
    form of the reference's gen_trans_from_patch_cv + trans_point2d
    (reference lib/utils/_img_utils.py:40-67,137-140): the linear part
    is diag(out/src) @ R(-rot) about the bbox center."""
    kp = np.asarray(kp_2d, np.float64)[..., :2]
    rot = np.pi * rot_deg / 180.0
    cs, sn = np.cos(rot), np.sin(rot)
    src_w, src_h = width * scale, height * scale
    d = kp - np.array([cx, cy])
    # R(-rot): the inverse of the source-frame rotation
    rx = d[..., 0] * cs + d[..., 1] * sn
    ry = -d[..., 0] * sn + d[..., 1] * cs
    out = np.stack(
        [rx * (out_w / src_w) + out_w * 0.5, ry * (out_h / src_h) + out_h * 0.5],
        axis=-1,
    )
    return out


def transform_keypoints(kp_2d: np.ndarray, center_x: float, center_y: float,
                        width: float, height: float, patch_width: int,
                        patch_height: int, scale: float = 1.2,
                        rot_deg: float = 0.0) -> np.ndarray:
    """Reference `transfrom_keypoints` [sic] (reference lib/utils/
    _img_utils.py:129-153) with the augmentation resolved to explicit
    (scale, rot) arguments instead of internal random sampling; the
    reference's non-augmented call uses scale=1.2."""
    return affine_transform_points(
        kp_2d, center_x, center_y, width, height, patch_width, patch_height,
        scale, rot_deg,
    )


# Drop-in alias preserving the reference's typo'd public name.
transfrom_keypoints = transform_keypoints
