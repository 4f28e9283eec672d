"""RULA scoring as a vectorised, branchless PyTorch engine (port of the
JAX package's scoring/rula.py).

Mirror of scoring/reba.py for the RULA rule set
(reference lib/utils/rula.py:66-422). Reference quirks reproduced as
spec (SURVEY.md section 2.11):
  * right upper_arm_bending with -70<a3<110 and |a4|<20 assigns `angle4 = 1`
    instead of a score, leaving score2 = 0 for that case AND changing the
    logged angle to 1.0 (rula.py:183);
  * the right-arm elif tests `angle3 < 20` so a3 <= -70 falls into the
    "low" branch while a3 >= 110 scores 1 (rula.py:188);
  * upper_arm_abducted logs angle2 (L_Shoulder.y) in the R slot
    (rula.py:284);
  * in upper_arm_abducted's right arm there is no trailing else, so
    a3 >= 110 keeps score 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from poserisk_release_tpu_torch.body.smpl import JOINT_INDEX
from poserisk_release_tpu_torch.scoring import tables
from poserisk_release_tpu_torch.scoring.common import chain, frame_scores_chunked, table_gather

EVAL_ITEMS = [
    "Upper_arm (L,R)", "Lower_arm (L,R)", "Wrist (L,R)", "Wrist_twist (L,R)",
    "Neck", "Trunk", "Leg",
]

INFO_KEYS = (
    "Arm_supported_leaning_L",
    "Arm_supported_leaning_R",
    "A_Muscle_use_L",
    "A_Muscle_use_R",
    "A_Load/Force_L",
    "A_Load/Force_R",
    "Legs_bilateral_weight_bearing",
    "B_Muscle_use",
    "B_Load/Force",
)


def pack_info(add_info: Dict) -> np.ndarray:
    info = add_info["RULA"] if "RULA" in add_info else add_info
    return np.array([info[k] for k in INFO_KEYS], np.int32)


def _table(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(table, device=device)


def _j(name: str) -> int:
    return JOINT_INDEX[name]


def _upper_arm_bending(lz, ly, rz, ry):
    left_main = chain(  # -70 < lz < 110
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) | ((ly > -45) & (ly < -20)), 2),
            ((ly > -90) & (ly <= -45), 3),
            (ly < -90, 4),
        ],
        1,
    )
    left_high = chain(  # lz > -20 (reachable only for lz >= 110)
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) & (ly < 70), 2),
            (ly > 70, 2),
            ((ly > -70) & (ly < -20), 4),
            (ly < -70, 4),
        ],
        1,
    )
    score_l = chain(
        [
            ((lz > -70) & (lz < 110), left_main),
            (lz > -20, left_high),
        ],
        1,
    )

    # Right arm. Quirk (rula.py:183): in the main branch with |ry| < 20 the
    # reference assigns angle4 = 1 (not score2), so the score stays 0.
    right_main = chain(  # -70 < rz < 110
        [
            (torch.abs(ry) < 20, 0),  # quirk: score2 keeps its initial 0
            ((ry < -20) | ((ry > 20) & (ry <= 45)), 2),
            ((ry > 45) & (ry <= 90), 3),
            (ry > 90, 4),
        ],
        1,
    )
    right_low = chain(  # rz < 20 (reachable only for rz <= -70)
        [
            (torch.abs(ry) < 20, 1),
            ((ry > -70) & (ry < -20), 2),
            (ry < -70, 2),
            ((ry > 20) & (ry < 70), 4),
            (ry > 70, 4),
        ],
        1,
    )
    score_r = chain(
        [
            ((rz > -70) & (rz < 110), right_main),
            (rz < 20, right_low),
        ],
        1,
    )
    return score_l, score_r


def _shoulder_rise(a):
    return chain([(torch.abs(a) < 10, 0), (torch.abs(a) >= 10, 1)], 0)


def _upper_arm_abducted(lz, ly, rz, ry):
    left_lowered = chain(  # -110 < lz < -20; lz < 45 always true here => 0
        [
            (lz < 45, 0),
            (lz > 45, 1),
        ],
        0,
    )
    left_raised = chain(  # lz > -20
        [
            (torch.abs(ly) < 20, 1),
            ((ly > 20) & (ly < 70), 1),
            (ly > 70, 0),
            ((ly > -70) & (ly < -20), 1),
            (ly < -70, 0),
        ],
        0,
    )
    score_l = chain(
        [
            ((lz > -110) & (lz < -20), left_lowered),
            (lz > -20, left_raised),
        ],
        0,
    )

    right_main = chain(  # 20 < rz < 110
        [
            (rz > 45, 0),
            (rz < 45, 1),
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
    # No trailing else in the reference: rz >= 110 (or rz == 20) keeps 0.
    score_r = chain(
        [
            ((rz > 20) & (rz < 110), right_main),
            (rz < 20, right_low),
        ],
        0,
    )
    return score_l, score_r


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


def _bent_from_midline(lx, rx):
    score_l = chain(
        [
            ((lx < 10) | ((lx > -45) & (lx < -10)), 0),
            ((lx > 10) | (lx < -45), 1),
        ],
        0,
    )
    score_r = chain(
        [
            ((rx > -10) | ((rx > 10) & (rx < 45)), 0),
            ((rx < -10) | (rx > 45), 1),
        ],
        0,
    )
    return score_l, score_r


def _wrist_bending(a):
    return chain(
        [
            (torch.abs(a) < 1, 1),
            ((torch.abs(a) > 1) & (torch.abs(a) < 15), 2),
            (torch.abs(a) > 15, 3),
        ],
        1,
    )


def _wrist_side_bending(a):
    return chain([(torch.abs(a) < 10, 0), (torch.abs(a) > 10, 1)], 0)


def _wrist_twist(a):
    return chain([(torch.abs(a) < 45, 1), (torch.abs(a) > 45, 2)], 1)


def _trunk_bending(a):
    return chain(
        [
            (torch.abs(a) < 5, 1),
            ((a > 5) & (a < 20), 2),
            ((a > 20) & (a < 60), 3),
            (a > 60, 4),
        ],
        1,
    )


def _abs_threshold(a, thr):
    return chain([(torch.abs(a) < thr, 0), (torch.abs(a) > thr, 1)], 0)


def _neck_bending(a):
    return chain(
        [
            ((a > -5) & (a < 10), 1),
            ((a > 10) & (a < 20), 2),
            (a > 20, 3),
            (a < -5, 4),
        ],
        1,
    )


def _neck_side_or_twist(a1, a2):
    return chain(
        [
            ((torch.abs(a1) < 10) & (torch.abs(a2) < 10), 0),
            ((torch.abs(a1) > 10) | (torch.abs(a2) > 10), 1),
        ],
        0,
    )


def rula_frame_scores(euler_deg: torch.Tensor, info: torch.Tensor) -> Dict[str, torch.Tensor]:
    e = euler_deg
    (arm_sup_l, arm_sup_r, a_muscle_l, a_muscle_r, a_load_l, a_load_r,
     legs_input, b_muscle, b_load) = [info[i] for i in range(9)]

    ub_l, ub_r = _upper_arm_bending(
        e[:, _j("L_Shoulder"), 2], e[:, _j("L_Shoulder"), 1],
        e[:, _j("R_Shoulder"), 2], e[:, _j("R_Shoulder"), 1],
    )
    ub_l = ub_l - arm_sup_l
    ub_r = ub_r - arm_sup_r
    sr_l = _shoulder_rise(e[:, _j("L_Thorax"), 2])
    sr_r = _shoulder_rise(e[:, _j("R_Thorax"), 2])
    ab_l, ab_r = _upper_arm_abducted(
        e[:, _j("L_Shoulder"), 2], e[:, _j("L_Shoulder"), 1],
        e[:, _j("R_Shoulder"), 2], e[:, _j("R_Shoulder"), 1],
    )
    upper_l = torch.clamp(ub_l + sr_l + ab_l, 1, 6)
    upper_r = torch.clamp(ub_r + sr_r + ab_r, 1, 6)

    la_l, la_r = _lower_arm_bending(
        torch.maximum(e[:, _j("L_Elbow"), 1], e[:, _j("L_Elbow"), 2]),
        torch.maximum(e[:, _j("R_Elbow"), 1], e[:, _j("R_Elbow"), 2]),
    )
    bm_l, bm_r = _bent_from_midline(e[:, _j("L_Thorax"), 0], e[:, _j("R_Thorax"), 0])
    lower_l = torch.clamp(la_l + bm_l, 1, 3)
    lower_r = torch.clamp(la_r + bm_r, 1, 3)

    wrist_l = torch.clamp(
        _wrist_bending(e[:, _j("L_Wrist"), 2]) + _wrist_side_bending(e[:, _j("L_Wrist"), 1]),
        1, 4,
    )
    wrist_r = torch.clamp(
        _wrist_bending(e[:, _j("R_Wrist"), 2]) + _wrist_side_bending(e[:, _j("R_Wrist"), 1]),
        1, 4,
    )
    twist_l = torch.clamp(_wrist_twist(e[:, _j("L_Wrist"), 0]), 1, 2)
    twist_r = torch.clamp(_wrist_twist(e[:, _j("R_Wrist"), 0]), 1, 2)

    table_a = _table(tables.RULA_TABLE_A, e.device)
    group_a_l = table_gather(table_a, upper_l - 1, lower_l - 1, wrist_l - 1, twist_l - 1)
    group_a_r = table_gather(table_a, upper_r - 1, lower_r - 1, wrist_r - 1, twist_r - 1)
    group_a = torch.maximum(
        group_a_l + a_muscle_l + a_load_l, group_a_r + a_muscle_r + a_load_r
    )

    neck_a = e[:, _j("Neck")]
    torso = e[:, _j("Torso")]
    neck = torch.clamp(
        _neck_bending(neck_a[:, 0]) + _neck_side_or_twist(neck_a[:, 2], neck_a[:, 1]), 1, 6
    )
    trunk = torch.clamp(
        _trunk_bending(torso[:, 0])
        + _abs_threshold(torso[:, 1], 10)  # trunk_twisted
        + _abs_threshold(torso[:, 2], 10),  # trunk_side_bending
        1, 6,
    )
    leg = torch.clamp(legs_input.expand(neck.shape), 1, 2)
    group_b = (
        table_gather(_table(tables.RULA_TABLE_B, e.device), neck - 1, trunk - 1, leg - 1)
        + b_muscle + b_load
    )

    score_a = torch.clamp(group_a, 1, 7)
    score_b = torch.clamp(group_b, 1, 7)
    final = table_gather(_table(tables.RULA_TABLE_C, e.device), score_a - 1, score_b - 1)

    return {
        "upper_arm": torch.stack([upper_l, upper_r], dim=-1),
        "lower_arm": torch.stack([lower_l, lower_r], dim=-1),
        "wrist": torch.stack([wrist_l, wrist_r], dim=-1),
        "wrist_twist": torch.stack([twist_l, twist_r], dim=-1),
        "neck": neck,
        "trunk": trunk,
        "leg": leg,
        "score": final,
    }


def format_angle_logs(euler_deg: np.ndarray, add_info: Dict) -> List[Dict[str, str]]:
    """Reference-identical RULA angle logs (keys in rule-invocation order).

    Includes the rula.py:183 quirk where the logged right upper-arm y angle
    becomes 1.0 when -70 < R_Shoulder.z < 110 and |R_Shoulder.y| < 20, and
    the rula.py:284 quirk logging L_Shoulder.y in upper_arm_abducted's R slot.
    """
    del add_info
    logs = []
    for pose in np.asarray(euler_deg):
        t = pose[_j("Torso")]
        n = pose[_j("Neck")]
        lsh, rsh = pose[_j("L_Shoulder")], pose[_j("R_Shoulder")]
        lth, rth = pose[_j("L_Thorax")], pose[_j("R_Thorax")]
        lel, rel = pose[_j("L_Elbow")], pose[_j("R_Elbow")]
        lwr, rwr = pose[_j("L_Wrist")], pose[_j("R_Wrist")]
        lmax, rmax = max(lel[1], lel[2]), max(rel[1], rel[2])
        ry_logged = (
            1.0 if (-70 < rsh[2] < 110 and abs(rsh[1]) < 20) else rsh[1]
        )
        logs.append(
            {
                "upper_arm_bending": f"L {lsh[2]:.1f},{lsh[1]:.1f} R {rsh[2]:.1f},{ry_logged:.1f}",
                "shoulder_rise": f"L {lth[2]:.1f} R {rth[2]:.1f}",
                "upper_arm_abducted": f"L {lsh[2]:.1f} R {lsh[1]:.1f}",
                "lower_arm_bending": f"L {lmax:.1f} R {rmax:.1f}",
                "bent_from_midline_or_out_to_side": f"L {lth[0]:.1f} R {rth[0]:.1f}",
                "wrist_bending": f"L {lwr[2]:.1f} R {rwr[2]:.1f}",
                "wrist_side_bending": f"L {lwr[1]:.1f} R {rwr[1]:.1f}",
                "wrist_twist": f"L {lwr[0]:.1f} R {rwr[0]:.1f}",
                "neck_bending": f"{n[0]:.1f}",
                "neck_side_bending_twisted": f"{n[2]:.1f}, {n[1]:.1f}",
                "trunk_bending": f"{t[0]:.1f}",
                "trunk_twisted": f"{t[1]:.1f}",
                "trunk_side_bending": f"{t[2]:.1f}",
            }
        )
    return logs


class RULAScorer:
    """Host-facing scorer matching the reference RULA class's call contract."""

    def __init__(self, debug: bool = False, device="cpu"):
        self.debugging = debug
        self.device = device
        self.eval_items = list(EVAL_ITEMS)
        self.log: List[Dict[str, str]] = []

    def __call__(self, poses, joint_cams, add_info) -> List[Dict]:
        del joint_cams
        poses = np.asarray(poses, np.float64)
        out = frame_scores_chunked(rula_frame_scores, poses, pack_info(add_info),
                                   self.device)
        if self.debugging:
            self.log = format_angle_logs(poses, add_info)

        results = []
        for i in range(poses.shape[0]):
            u = out["upper_arm"][i]
            l = out["lower_arm"][i]
            w = out["wrist"][i]
            wt = out["wrist_twist"][i]
            results.append(
                {
                    "score": int(out["score"][i]),
                    "log_score": [
                        f"{u[0]},{u[1]}",
                        f"{l[0]},{l[1]}",
                        f"{w[0]},{w[1]}",
                        f"{wt[0]},{wt[1]}",
                        int(out["neck"][i]),
                        int(out["trunk"][i]),
                        int(out["leg"][i]),
                    ],
                }
            )
        return results

    @staticmethod
    def action_level(score):
        score = round(score)
        for bucket, level, name in tables.RULA_ACTION_LEVELS:
            if score in bucket:
                return level, name
        if score >= 7:
            return tables.RULA_ACTION_LEVEL_HIGH
        return None, None
