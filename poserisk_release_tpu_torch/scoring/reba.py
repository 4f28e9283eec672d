"""REBA scoring as a vectorised, branchless PyTorch engine (port of the
JAX package's scoring/reba.py).

The reference scores one frame at a time through a chain of Python if/elif
rules (reference lib/utils/reba.py:50-392). Here every rule is a
select chain over the whole frame axis (scoring.common.chain), so a clip's
REBA sequence is a few hundred elementwise ops on the scorer's device.

PARITY IS SPEC: the reference rule code contains asymmetries and dead
branches (documented in SURVEY.md section 2.11). Those behaviours are
deliberately reproduced and unit-tested, notably:
  * trunk_side_bending always contributes 0 (reba.py:150-156);
  * neck_bending returns 1 (not 2) for angle >= 20 because the elif
    condition `angle<20 or angle<-5` can't catch it (reba.py:166-172);
  * the right-arm branch of upper_arm_bending reads the LEFT shoulder's
    angles when the right z-angle is outside (20, 110) (reba.py:232-238);
  * the right-arm rotation bonus of upper_arm_abducted_rotated increments
    the LEFT score (reba.py:331);
  * in the elevated-arm branch of upper_arm_bending the `a2>20 or a2<70`
    condition covers all reals, so the score is 1 iff |a2|<20 else 2.

Euler angle layout: poses are (F, 24, 3) XYZ Euler degrees, joint order
as in body.smpl.JOINTS_NAME.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import JOINT_INDEX
from poserisk_release_tpu_torch.device import resolve_device
from poserisk_release_tpu_torch.scoring import tables
from poserisk_release_tpu_torch.scoring.common import (
    chain,
    device_table,
    frame_scores_chunked,
    table_gather,
)

EVAL_ITEMS = ["Trunk", "Neck", "Leg", "Upper_arm (L,R)", "Lower_arm (L,R)", "Wrist (L,R)"]

# add_info["REBA"] keys, flattened to a fixed-order vector for the jit graph.
INFO_KEYS = (
    "Legs_bilateral_weight_bearing/walking",
    "Sitting",
    "Load/Force Score",
    "Arm_supported_leaning_L",
    "Arm_supported_leaning_R",
    "Coupling",
    "Activity_Score",
)


def pack_info(add_info: Dict) -> np.ndarray:
    info = add_info["REBA"] if "REBA" in add_info else add_info
    return np.array([info[k] for k in INFO_KEYS], np.int32)


def _trunk_bending(a):
    return chain(
        [
            (torch.abs(a) < 5, 1),
            (((a > 5) & (a < 20)) | ((a > -20) & (a < -5)), 2),
            (((a > 20) & (a < 60)) | (a < -20), 3),
            (a > 60, 4),
        ],
        1,
    )


def _trunk_twist(a):
    return chain([(torch.abs(a) < 10, 0), (torch.abs(a) > 10, 1)], 0)


def _trunk_side_bending(a):
    # Reference quirk: all branches return 0 (reba.py:150-156).
    return torch.zeros_like(a, dtype=torch.int32)


def _neck_bending(a):
    return chain(
        [
            ((a > -5) & (a < 20), 1),
            ((a < 20) | (a < -5), 2),
        ],
        1,
    )


def _neck_twist(a1, a2):
    return chain(
        [
            ((torch.abs(a1) < 10) & (torch.abs(a2) < 10), 0),
            ((torch.abs(a1) > 10) | (torch.abs(a2) > 10), 1),
        ],
        0,
    )


def _leg_bending(a1, a2, sitting):
    def knee(a):
        return chain(
            [
                (a < 30, 0),
                ((a > 30) & (a < 60), 1),
                ((a > 60) & (sitting > 0), 2),
            ],
            0,
        )

    return torch.maximum(knee(a1), knee(a2))


def _upper_arm_bending(lz, ly, rz, ry):
    # Left arm: a1 = L_Shoulder.z, a2 = L_Shoulder.y.
    left_lowered = chain(  # -110 < a1 < -20
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) | ((ly > -45) & (ly < -20)), 2),
            ((ly > -90) & (ly <= -45), 3),
            (ly < -90, 4),
        ],
        1,
    )
    left_raised = chain(  # a1 > -20; `(a2>20)|(a2<70)` covers all reals => 2.
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) | (ly < 70), 2),
            (ly > 70, 2),
            ((ly > -70) & (ly < -20), 4),
            (ly < -70, 4),
        ],
        1,
    )
    score_l = chain(
        [
            ((lz > -110) & (lz < -20), left_lowered),
            (lz > -20, left_raised),
        ],
        1,
    )

    # Right arm. Quirk: outside (20, 110) the reference re-tests the LEFT
    # arm's angles (reba.py:232-238).
    right_main = chain(  # 20 < rz < 110
        [
            (torch.abs(ry) < 20, 1),
            ((ry < -20) | ((ry > 20) & (ry <= 45)), 2),
            ((ry > 45) & (ry <= 90), 3),
            (ry > 90, 4),
        ],
        1,
    )
    score_r = chain(
        [
            ((rz > 20) & (rz < 110), right_main),
            (lz > -20, left_raised),  # quirk: left-arm variables
        ],
        1,
    )
    return score_l, score_r


def _shoulder_rise(a):
    return chain([(torch.abs(a) < 10, 0), (torch.abs(a) >= 10, 1)], 0)


def _upper_arm_abducted_rotated(lz, lx, ly, rz, rx, ry):
    # Left arm (a1=L.z, a2=L.x, a3=L.y).
    left_lowered = chain(  # -110 < lz < -20; lz < 45 always true here.
        [
            ((lz < 45) & (torch.abs(lx) < 10), 0),
            ((lz > 45) | (torch.abs(lx) > 10), 1),
        ],
        0,
    )
    # Raised branch: the select chain is effectively 1 for every ly, then
    # +1 when |lx| > 10 (the inner if at reba.py:311).
    left_raised_base = chain(
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) | (ly < 70), 1),
            (ly > 70, 0),
            ((ly > -70) & (ly < -20), 1),
            (ly < -70, 0),
        ],
        0,
    )
    left_raised = left_raised_base + (torch.abs(lx) > 10).to(torch.int32)
    score_l = chain(
        [
            ((lz > -110) & (lz < -20), left_lowered),
            (lz > -20, left_raised),
        ],
        0,
    )

    # Right arm (a4=R.z, a5=R.x, a6=R.y).
    right_main = chain(  # 20 < rz < 110
        [
            ((rz > 45) & (torch.abs(rx) < 10), 0),
            ((rz < 45) | (torch.abs(rx) > 10), 1),
        ],
        0,
    )
    right_low = chain(  # rz < 20
        [
            (torch.abs(ry) < 20, 1),
            ((ry > -70) & (ry < -20), 1),
            (ry < -70, 0),
            ((ry > 20) & (ry < 70), 1),
            (ry > 70, 0),
        ],
        0,
    )
    score_r = chain(
        [
            ((rz > 20) & (rz < 110), right_main),
            (rz < 20, right_low),
        ],
        0,
    )
    # Quirk (reba.py:331): in the rz < 20 branch the |rx| > 10 rotation bonus
    # is added to the LEFT score, not the right one.
    bonus_to_left = ((~((rz > 20) & (rz < 110))) & (rz < 20) & (torch.abs(rx) > 10)).to(
        torch.int32
    )
    return score_l + bonus_to_left, score_r


def _lower_arm_bending(l_max, r_max):
    score_l = chain(
        [
            ((l_max > -100) & (l_max < -60), 1),
            ((l_max < -100) | ((l_max > -60) & (l_max < 0)), 2),
        ],
        1,
    )
    score_r = chain(
        [
            ((r_max > 60) & (r_max < 100), 1),
            ((r_max > 100) | ((r_max > 0) & (r_max < 60)), 2),
        ],
        1,
    )
    return score_l, score_r


def _wrist_bending(a):
    return chain([(torch.abs(a) < 15, 1), (torch.abs(a) > 15, 2)], 1)


def _wrist_side_or_twist(a1, a2):
    return chain(
        [
            ((torch.abs(a1) < 10) & (torch.abs(a2) < 10), 0),
            ((torch.abs(a1) > 10) | (torch.abs(a2) > 10), 1),
        ],
        0,
    )


def _j(name: str) -> int:
    return JOINT_INDEX[name]


def reba_frame_scores(euler_deg: torch.Tensor, info: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Score every frame of a clip in one fused graph.

    euler_deg: (F, 24, 3) XYZ Euler angles in degrees.
    info: packed add_info vector (see INFO_KEYS).
    Returns per-frame component scores (clipped, as logged by the reference)
    plus the final REBA score.
    """
    e = euler_deg
    legs_input, sitting, load_force, arm_sup_l, arm_sup_r, coupling, activity = [
        info[i] for i in range(7)
    ]

    torso = e[:, _j("Torso")]
    neck_a = e[:, _j("Neck")]

    trunk = (
        _trunk_bending(torso[:, 0])
        + _trunk_twist(torso[:, 1])
        + _trunk_side_bending(torso[:, 2])
    )
    neck = _neck_bending(neck_a[:, 0]) + _neck_twist(neck_a[:, 2], neck_a[:, 1])
    leg = legs_input + _leg_bending(e[:, _j("L_Knee"), 0], e[:, _j("R_Knee"), 0], sitting)

    trunk = torch.clamp(trunk, 1, 5)
    neck = torch.clamp(neck, 1, 3)
    leg = torch.clamp(leg, 1, 4)
    group_a = table_gather(device_table(tables.REBA_TABLE_A, e.device),
                           trunk - 1, neck - 1, leg - 1)
    group_a = group_a + load_force

    ub_l, ub_r = _upper_arm_bending(
        e[:, _j("L_Shoulder"), 2], e[:, _j("L_Shoulder"), 1],
        e[:, _j("R_Shoulder"), 2], e[:, _j("R_Shoulder"), 1],
    )
    ub_l = ub_l - arm_sup_l
    ub_r = ub_r - arm_sup_r
    sr_l = _shoulder_rise(e[:, _j("L_Thorax"), 2])
    sr_r = _shoulder_rise(e[:, _j("R_Thorax"), 2])
    ab_l, ab_r = _upper_arm_abducted_rotated(
        e[:, _j("L_Shoulder"), 2], e[:, _j("L_Shoulder"), 0], e[:, _j("L_Shoulder"), 1],
        e[:, _j("R_Shoulder"), 2], e[:, _j("R_Shoulder"), 0], e[:, _j("R_Shoulder"), 1],
    )
    upper_l = torch.clamp(ub_l + sr_l + ab_l, 1, 6)
    upper_r = torch.clamp(ub_r + sr_r + ab_r, 1, 6)

    la_l, la_r = _lower_arm_bending(
        torch.maximum(e[:, _j("L_Elbow"), 1], e[:, _j("L_Elbow"), 2]),
        torch.maximum(e[:, _j("R_Elbow"), 1], e[:, _j("R_Elbow"), 2]),
    )
    lower_l = torch.clamp(la_l, 1, 2)
    lower_r = torch.clamp(la_r, 1, 2)

    wrist_l = torch.clamp(
        _wrist_bending(e[:, _j("L_Wrist"), 2])
        + _wrist_side_or_twist(e[:, _j("L_Wrist"), 1], e[:, _j("L_Wrist"), 0]),
        1,
        3,
    )
    wrist_r = torch.clamp(
        _wrist_bending(e[:, _j("R_Wrist"), 2])
        + _wrist_side_or_twist(e[:, _j("R_Wrist"), 1], e[:, _j("R_Wrist"), 0]),
        1,
        3,
    )

    table_b = device_table(tables.REBA_TABLE_B, e.device)
    group_b_l = table_gather(table_b, upper_l - 1, lower_l - 1, wrist_l - 1)
    group_b_r = table_gather(table_b, upper_r - 1, lower_r - 1, wrist_r - 1)
    group_b = torch.maximum(group_b_l, group_b_r) + coupling

    score_a = torch.clamp(group_a, 1, 12)
    score_b = torch.clamp(group_b, 1, 12)
    final = table_gather(device_table(tables.REBA_TABLE_C, e.device),
                         score_a - 1, score_b - 1) + activity

    return {
        "trunk": trunk,
        "neck": neck,
        "leg": leg,
        "upper_arm": torch.stack([upper_l, upper_r], dim=-1),
        "lower_arm": torch.stack([lower_l, lower_r], dim=-1),
        "wrist": torch.stack([wrist_l, wrist_r], dim=-1),
        "score": final,
    }


def format_angle_logs(euler_deg: np.ndarray, add_info: Dict) -> List[Dict[str, str]]:
    """Per-frame debug angle logs, byte-identical to the reference's
    angle_log dict contents (keys in rule-invocation order, same f-string
    formats, including the mislabelled upper_arm_abducted_rotated entry that
    logs L_Shoulder.y / R_Shoulder.z in the R slot, reba.py:334)."""
    del add_info  # REBA logs don't depend on the info values
    logs = []
    for pose in np.asarray(euler_deg):
        t = pose[_j("Torso")]
        n = pose[_j("Neck")]
        lsh, rsh = pose[_j("L_Shoulder")], pose[_j("R_Shoulder")]
        lth, rth = pose[_j("L_Thorax")], pose[_j("R_Thorax")]
        lel, rel = pose[_j("L_Elbow")], pose[_j("R_Elbow")]
        lwr, rwr = pose[_j("L_Wrist")], pose[_j("R_Wrist")]
        lmax, rmax = max(lel[1], lel[2]), max(rel[1], rel[2])
        logs.append(
            {
                "trunk_bending": f"{t[0]:.1f}",
                "trunk_twist": f"{t[1]:.1f}",
                "trunk_side_bending": f"{t[2]:.1f}",
                "neck_bending": f"{n[0]:.1f}",
                "neck_twist": f"{n[2]:.1f},{n[1]:.1f}",
                "leg_bending": f"L {pose[_j('L_Knee')][0]:.1f} R {pose[_j('R_Knee')][0]:.1f}",
                "upper_arm_bending": f"L {lsh[2]:.1f},{lsh[1]:.1f} R {rsh[2]:.1f},{rsh[1]:.1f}",
                "shoulder_rise": f"L {lth[2]:.1f} R {rth[2]:.1f}",
                "upper_arm_abducted_rotated": f"L {lsh[2]:.1f},{lsh[0]:.1f} R {lsh[1]:.1f},{rsh[2]:.1f}",
                "lower_arm_bending": f"L {lmax:.1f} R {rmax:.1f}",
                "wrist_bending": f"L {lwr[2]:.1f} R {rwr[2]:.1f}",
                "wrist_side_bending_or_twisted": f"L {lwr[1]:.1f},{lwr[0]:.1f} R {rwr[1]:.1f},{rwr[0]:.1f}",
            }
        )
    return logs


class REBAScorer:
    """Host-facing scorer with the reference REBA class's call contract.

    __call__(poses, joint_cams, add_info) -> [{'score': int,
    'log_score': [trunk, neck, leg, 'uL,uR', 'lL,lR', 'wL,wR']}, ...]
    (joint_cams is accepted for signature parity; like the reference's live
    rules, it is never read -- reba.py threads it through but no active rule
    uses it.)
    """

    def __init__(self, debug: bool = False, device=None):
        self.debugging = debug
        self.device = resolve_device(device)
        self.eval_items = list(EVAL_ITEMS)
        self.log: List[Dict[str, str]] = []

    def __call__(self, poses, joint_cams, add_info) -> List[Dict]:
        del joint_cams
        poses = np.asarray(poses, np.float64)
        out = frame_scores_chunked(reba_frame_scores, poses, pack_info(add_info),
                                   self.device)
        if self.debugging:
            self.log = format_angle_logs(poses, add_info)

        results = []
        for i in range(poses.shape[0]):
            u = out["upper_arm"][i]
            l = out["lower_arm"][i]
            w = out["wrist"][i]
            results.append(
                {
                    "score": int(out["score"][i]),
                    "log_score": [
                        int(out["trunk"][i]),
                        int(out["neck"][i]),
                        int(out["leg"][i]),
                        f"{u[0]},{u[1]}",
                        f"{l[0]},{l[1]}",
                        f"{w[0]},{w[1]}",
                    ],
                }
            )
        return results

    @staticmethod
    def action_level(score):
        score = round(score)
        for bucket, level, name in tables.REBA_ACTION_LEVELS:
            if score in bucket:
                return level, name
        if score >= 11:
            return tables.REBA_ACTION_LEVEL_HIGH
        return None, None
