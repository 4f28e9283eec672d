"""The comparison that decides `correct`: the program's outputs against the plain reference.

The reference (benchmark/reference/) is handed the same weights, frames and
boxes as the program, derives the rest itself (BatchNorm unfolded, its own
letterbox and crop geometry) and runs once the window has closed and the
program's state is freed, in 64-row blocks, with TF32 off. The control is
the same reference with TF32 on (`tf32=True`), the precision step below
the configuration's strict f32.

Numbers, each held to its configuration's limit (`limits` in the file):
- det_box_gap_px: over the sampled frames, the widest L-inf distance in
  frame pixels from a box the detector returned to its match among the
  boxes the reference decodes for that frame (candidates down to half the
  threshold; the match is the nearest by max(L-inf px, SCORE_PX x score
  gap), since boxes clipped to the frame share their corners).
- det_score_gap: the score gap to that match.
- det_count_gap: sum over frames of |boxes returned - boxes the reference
  keeps|, over the boxes the reference keeps.
- rot_gap_deg: the widest angle between the rotation of a returned Euler
  triple (XYZ, degrees) and the reference's rotation of that joint;
  rot_gap_p50_deg: the median of the same angles, steady from seed to seed
  where the widest swings with the worst-conditioned frame.
- joint_gap_mm: the widest gap of a returned root-centred joint, mm.
- score_mismatch: frames whose returned REBA or RULA score differs from
  the reference's rule chains applied to the returned Euler angles.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import hmr as ref_hmr
from benchmark.reference import precision
from benchmark.reference import rules as ref_rules
from benchmark.reference import yolo as ref_yolo

BLOCK = 64
SCORE_PX = 1000.0


@torch.no_grad()
def reference_detections(params, frames_u8: np.ndarray, threshold: float, nms_thr: float,
                         device, tf32: bool = False, img_size: int = 416) -> List:
    precision.set_tf32(tf32)
    out = []
    for s in range(0, len(frames_u8), BLOCK):
        x = torch.from_numpy(np.ascontiguousarray(frames_u8[s:s + BLOCK])).to(device)
        out += ref_yolo.detect(params, x, threshold, nms_thr, img_size)
    precision.set_tf32(False)
    return out


@torch.no_grad()
def reference_pose(params, smpl, frames_u8: np.ndarray, boxes: np.ndarray, device,
                   tf32: bool = False):
    """(rotations (n, 24, 3, 3) float64, joints (n, 24, 3) mm float64)."""
    precision.set_tf32(tf32)
    rots, joints = [], []
    for s in range(0, len(frames_u8), BLOCK):
        f = torch.from_numpy(np.ascontiguousarray(frames_u8[s:s + BLOCK])).to(device)
        b = torch.from_numpy(np.ascontiguousarray(boxes[s:s + BLOCK], np.float32)).to(device)
        r = ref_hmr.rotations(params, f, b)
        rots.append(r.double().cpu())
        joints.append(ref_hmr.joints_mm(smpl, r).double().cpu())
    precision.set_tf32(False)
    return torch.cat(rots).numpy(), torch.cat(joints).numpy()


def detector_numbers(port: List[np.ndarray], ref: List) -> Dict[str, float]:
    box_gap = score_gap = 0.0
    miss = n_ref = 0
    for boxes, (cand, kept) in zip(port, ref):
        n_ref += len(kept)
        miss += abs(len(boxes) - len(kept))
        for b in np.asarray(boxes, np.float64).reshape(-1, 5):
            if not len(cand):
                box_gap = math.inf
                continue
            d = np.abs(cand[:, :4] - b[:4]).max(axis=1)
            ds = np.abs(cand[:, 4] - b[4])
            j = int(np.argmin(np.maximum(d, SCORE_PX * ds)))
            box_gap = max(box_gap, float(d[j]))
            score_gap = max(score_gap, float(ds[j]))
    return {"det_box_gap_px": box_gap, "det_score_gap": score_gap,
            "det_count_gap": miss / max(n_ref, 1)}


def pose_numbers(euler: np.ndarray, joints: np.ndarray, ref_rot: np.ndarray,
                 ref_joints: np.ndarray) -> Dict[str, float]:
    R = ref_hmr.euler_deg_to_rotmat(torch.from_numpy(np.asarray(euler, np.float64))).numpy()
    fro = np.sqrt(((R - ref_rot) ** 2).sum(axis=(-1, -2)))
    angle = 2 * np.degrees(np.arcsin(np.clip(fro / (2 * math.sqrt(2)), 0, 1)))
    if angle.size:
        print("[bench] rotation gap deg p50 %.3g p99 %.3g max %.3g" % tuple(
            np.quantile(angle, [0.5, 0.99, 1.0])), file=sys.stderr)
    return {"rot_gap_deg": float(angle.max(initial=0.0)),
            "rot_gap_p50_deg": float(np.median(angle)) if angle.size else 0.0,
            "joint_gap_mm": float(np.abs(np.asarray(joints, np.float64) - ref_joints).max(initial=0.0))}


def score_mismatch(euler: np.ndarray, reba: np.ndarray, rula: np.ndarray, info: Dict) -> int:
    bad = 0
    for e, a, b in zip(np.asarray(euler, np.float64), reba, rula):
        ra, _ = ref_rules.reba_frame(e, info["REBA"])
        rb, _ = ref_rules.rula_frame(e, info["RULA"])
        bad += int(ra != int(a) or rb != int(b))
    return bad


def judge(limits: Dict, det: Optional[Dict] = None, pose: Optional[Dict] = None,
          scores: Optional[int] = None):
    numbers = {}
    if det is not None:
        numbers.update(det)
    if pose is not None:
        numbers.update(pose)
    if scores is not None:
        numbers["score_mismatch"] = scores
    return numbers, {k: limits[k] for k in numbers}
