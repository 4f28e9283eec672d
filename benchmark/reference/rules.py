"""The reference's per-frame REBA and RULA rule chains, one frame at a time.

A frozen copy of the reference's decision logic (lib/utils/reba.py and
rula.py, every quirk included) with the published REBA (Hignett &
McAtamney, 2000) and RULA (McAtamney & Corlett, 1993) tables written out
here, over SMPL's 24-joint order. It reads a frame's (24, 3) XYZ Euler
angles in degrees and the additional-information dict, and imports nothing
of the program.
"""

import numpy as np

JOINTS_NAME = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
)
J = {n: i for i, n in enumerate(JOINTS_NAME)}


class tables:
    """The published score tables."""

    REBA_TABLE_A = np.array(
        [
            [[1, 2, 3, 4], [1, 2, 3, 4], [3, 3, 5, 6]],
            [[2, 3, 4, 5], [3, 4, 5, 6], [4, 5, 6, 7]],
            [[2, 4, 5, 6], [4, 5, 6, 7], [5, 6, 7, 8]],
            [[3, 5, 6, 7], [5, 6, 7, 8], [6, 7, 8, 9]],
            [[4, 6, 7, 8], [6, 7, 8, 9], [7, 8, 9, 9]],
        ],
        dtype=np.int32,
    )

    REBA_TABLE_B = np.array(
        [
            [[1, 2, 2], [1, 2, 3]],
            [[1, 2, 3], [2, 3, 4]],
            [[3, 4, 5], [4, 5, 5]],
            [[4, 5, 5], [5, 6, 7]],
            [[6, 7, 8], [7, 8, 8]],
            [[7, 8, 8], [8, 9, 9]],
        ],
        dtype=np.int32,
    )

    REBA_TABLE_C = np.array(
        [
            [1, 1, 1, 2, 3, 3, 4, 5, 6, 7, 7, 7],
            [1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 7, 8],
            [2, 3, 3, 3, 4, 5, 6, 7, 7, 8, 8, 8],
            [3, 4, 4, 4, 5, 6, 7, 8, 8, 9, 9, 9],
            [4, 4, 4, 5, 6, 7, 8, 8, 9, 9, 9, 9],
            [6, 6, 6, 7, 8, 8, 9, 9, 10, 10, 10, 10],
            [7, 7, 7, 8, 9, 9, 9, 10, 10, 11, 11, 11],
            [8, 8, 8, 9, 10, 10, 10, 10, 10, 11, 11, 11],
            [9, 9, 9, 10, 10, 10, 11, 11, 11, 12, 12, 12],
            [10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 12, 12],
            [11, 11, 11, 11, 12, 12, 12, 12, 12, 12, 12, 12],
            [12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12],
        ],
        dtype=np.int32,
    )

    RULA_TABLE_A = np.array(
        [
            [
                [[1, 2], [2, 2], [2, 3], [3, 3]],
                [[2, 2], [2, 2], [3, 3], [3, 3]],
                [[2, 3], [3, 3], [3, 3], [4, 4]],
            ],
            [
                [[2, 3], [3, 3], [3, 4], [4, 4]],
                [[3, 3], [3, 3], [3, 4], [4, 4]],
                [[3, 4], [4, 4], [4, 4], [5, 5]],
            ],
            [
                [[3, 3], [4, 4], [4, 4], [5, 5]],
                [[3, 4], [4, 4], [4, 4], [5, 5]],
                [[4, 4], [4, 4], [4, 5], [5, 5]],
            ],
            [
                [[4, 4], [4, 4], [4, 5], [5, 5]],
                [[4, 4], [4, 4], [4, 5], [5, 5]],
                [[4, 4], [4, 5], [5, 5], [6, 6]],
            ],
            [
                [[5, 5], [5, 5], [5, 6], [6, 7]],
                [[5, 6], [6, 6], [6, 7], [7, 7]],
                [[6, 6], [6, 7], [7, 7], [7, 8]],
            ],
            [
                [[7, 7], [7, 7], [7, 8], [8, 9]],
                [[8, 8], [8, 8], [8, 9], [9, 9]],
                [[9, 9], [9, 9], [9, 9], [9, 9]],
            ],
        ],
        dtype=np.int32,
    )

    RULA_TABLE_B = np.array(
        [
            [[1, 3], [2, 3], [3, 4], [5, 5], [6, 6], [7, 7]],
            [[2, 3], [2, 3], [4, 5], [5, 5], [6, 7], [7, 7]],
            [[3, 3], [3, 4], [4, 5], [5, 5], [6, 7], [7, 7]],
            [[5, 5], [5, 6], [6, 7], [7, 7], [7, 7], [8, 8]],
            [[7, 7], [7, 7], [7, 8], [8, 8], [8, 8], [8, 8]],
            [[8, 8], [8, 8], [8, 8], [8, 9], [9, 9], [9, 9]],
        ],
        dtype=np.int32,
    )

    RULA_TABLE_C = np.array(
        [
            [1, 2, 3, 3, 4, 5, 5],
            [2, 2, 3, 4, 4, 5, 5],
            [3, 3, 3, 4, 4, 5, 6],
            [3, 3, 3, 4, 5, 6, 6],
            [4, 4, 4, 5, 6, 7, 7],
            [5, 5, 6, 6, 7, 7, 7],
            [5, 5, 6, 7, 7, 7, 7],
        ],
        dtype=np.int32,
    )



# --------------------------------------------------------------------------
# REBA
# --------------------------------------------------------------------------
def reba_frame(pose, info):
    """pose: (24, 3) Euler degrees. info: add_info['REBA'] dict.
    Returns (final_score, [trunk, neck, leg, uL, uR, lL, lR, wL, wR])."""
    tx, ty, tz = pose[J["Torso"]]
    nx, ny, nz = pose[J["Neck"]]

    # trunk_bending
    if abs(tx) < 5:
        tb = 1
    elif (5 < tx < 20) or (-20 < tx < -5):
        tb = 2
    elif (20 < tx < 60) or tx < -20:
        tb = 3
    elif tx > 60:
        tb = 4
    else:
        tb = 1
    # trunk_twist
    tt = 1 if abs(ty) > 10 else 0
    # trunk_side_bending: always 0 in the reference
    trunk = int(np.clip(tb + tt + 0, 1, 5))

    # neck_bending
    if -5 < nx < 20:
        nb = 1
    elif nx < 20 or nx < -5:
        nb = 2
    else:
        nb = 1
    # neck_twist
    if abs(nz) < 10 and abs(ny) < 10:
        nt = 0
    elif abs(nz) > 10 or abs(ny) > 10:
        nt = 1
    else:
        nt = 0
    neck = int(np.clip(nb + nt, 1, 3))

    # legs
    def knee(a):
        if a < 30:
            return 0
        elif 30 < a < 60:
            return 1
        elif a > 60 and info["Sitting"] > 0:
            return 2
        return 0

    leg_raw = info["Legs_bilateral_weight_bearing/walking"] + max(
        knee(pose[J["L_Knee"]][0]), knee(pose[J["R_Knee"]][0])
    )
    leg = int(np.clip(leg_raw, 1, 4))

    group_a = tables.REBA_TABLE_A[trunk - 1][neck - 1][leg - 1] + info["Load/Force Score"]

    # upper_arm_bending
    lz, ly = pose[J["L_Shoulder"]][2], pose[J["L_Shoulder"]][1]
    rz, ry = pose[J["R_Shoulder"]][2], pose[J["R_Shoulder"]][1]

    def left_raised(a2):
        if abs(a2) < 20:
            return 1
        elif a2 > 20 or a2 < 70:
            return 2
        elif a2 > 70:
            return 2
        elif -70 < a2 < -20:
            return 4
        elif a2 < -70:
            return 4
        return 1

    if -110 < lz < -20:
        if abs(ly) < 20:
            ub_l = 1
        elif ly > 20 or (-45 < ly < -20):
            ub_l = 2
        elif -90 < ly <= -45:
            ub_l = 3
        elif ly < -90:
            ub_l = 4
        else:
            ub_l = 1
    elif lz > -20:
        ub_l = left_raised(ly)
    else:
        ub_l = 1
    ub_l -= info["Arm_supported_leaning_L"]

    if 20 < rz < 110:
        if abs(ry) < 20:
            ub_r = 1
        elif ry < -20 or (20 < ry <= 45):
            ub_r = 2
        elif 45 < ry <= 90:
            ub_r = 3
        elif ry > 90:
            ub_r = 4
        else:
            ub_r = 1
    elif lz > -20:  # reference quirk: left-arm variables
        ub_r = left_raised(ly)
    else:
        ub_r = 1
    ub_r -= info["Arm_supported_leaning_R"]

    # shoulder_rise
    sr_l = 1 if abs(pose[J["L_Thorax"]][2]) >= 10 else 0
    sr_r = 1 if abs(pose[J["R_Thorax"]][2]) >= 10 else 0

    # upper_arm_abducted_rotated
    lx = pose[J["L_Shoulder"]][0]
    rx = pose[J["R_Shoulder"]][0]
    if -110 < lz < -20:
        if lz < 45 and abs(lx) < 10:
            ab_l = 0
        elif lz > 45 or abs(lx) > 10:
            ab_l = 1
        else:
            ab_l = 0
    elif lz > -20:
        if abs(ly) < 20:
            ab_l = 1
        elif ly > 20 or ly < 70:
            ab_l = 1
        elif ly > 70:
            ab_l = 0
        elif -70 < ly < -20:
            ab_l = 1
        elif ly < -70:
            ab_l = 0
        else:
            ab_l = 0
        if abs(lx) > 10:
            ab_l += 1
    else:
        ab_l = 0

    if 20 < rz < 110:
        if rz > 45 and abs(rx) < 10:
            ab_r = 0
        elif rz < 45 or abs(rx) > 10:
            ab_r = 1
        else:
            ab_r = 0
    elif rz < 20:
        if abs(ry) < 20:
            ab_r = 1
        elif -70 < ry < -20:
            ab_r = 1
        elif ry < -70:
            ab_r = 0
        elif 20 < ry < 70:
            ab_r = 1
        elif ry > 70:
            ab_r = 0
        else:
            ab_r = 0
        if abs(rx) > 10:
            ab_l += 1  # reference quirk: bonus lands on the LEFT score
    else:
        ab_r = 0

    upper = np.clip(np.array([ub_l + sr_l + ab_l, ub_r + sr_r + ab_r]), 1, 6)

    # lower_arm_bending
    lmax = max(pose[J["L_Elbow"]][1], pose[J["L_Elbow"]][2])
    rmax = max(pose[J["R_Elbow"]][1], pose[J["R_Elbow"]][2])
    if -100 < lmax < -60:
        la_l = 1
    elif lmax < -100 or (-60 < lmax < 0):
        la_l = 2
    else:
        la_l = 1
    if 60 < rmax < 100:
        la_r = 1
    elif rmax > 100 or (0 < rmax < 60):
        la_r = 2
    else:
        la_r = 1
    lower = np.clip(np.array([la_l, la_r]), 1, 2)

    # wrist
    def wb(a):
        return 2 if abs(a) > 15 else 1

    def wst(a1, a2):
        if abs(a1) < 10 and abs(a2) < 10:
            return 0
        elif abs(a1) > 10 or abs(a2) > 10:
            return 1
        return 0

    lw, rw = pose[J["L_Wrist"]], pose[J["R_Wrist"]]
    wrist = np.clip(
        np.array([wb(lw[2]) + wst(lw[1], lw[0]), wb(rw[2]) + wst(rw[1], rw[0])]), 1, 3
    )

    b_l = tables.REBA_TABLE_B[upper[0] - 1][lower[0] - 1][wrist[0] - 1]
    b_r = tables.REBA_TABLE_B[upper[1] - 1][lower[1] - 1][wrist[1] - 1]
    group_b = max(b_l, b_r) + info["Coupling"]

    a_c = int(np.clip(group_a, 1, 12))
    b_c = int(np.clip(group_b, 1, 12))
    final = tables.REBA_TABLE_C[a_c - 1][b_c - 1] + info["Activity_Score"]
    return int(final), [trunk, neck, leg, *upper.tolist(), *lower.tolist(), *wrist.tolist()]


# --------------------------------------------------------------------------
# RULA
# --------------------------------------------------------------------------
def rula_frame(pose, info):
    """pose: (24, 3) Euler degrees. info: add_info['RULA'] dict.
    Returns (final, [uL,uR,lL,lR,wL,wR,wtL,wtR,neck,trunk,leg])."""
    lz, ly = pose[J["L_Shoulder"]][2], pose[J["L_Shoulder"]][1]
    rz, ry = pose[J["R_Shoulder"]][2], pose[J["R_Shoulder"]][1]

    # upper_arm_bending
    if -70 < lz < 110:
        if abs(ly) < 20:
            ub_l = 1
        elif ly > 20 or (-45 < ly < -20):
            ub_l = 2
        elif -90 < ly <= -45:
            ub_l = 3
        elif ly < -90:
            ub_l = 4
        else:
            ub_l = 1
    elif lz > -20:
        if abs(ly) < 20:
            ub_l = 1
        elif 20 < ly < 70:
            ub_l = 2
        elif ly > 70:
            ub_l = 2
        elif -70 < ly < -20:
            ub_l = 4
        elif ly < -70:
            ub_l = 4
        else:
            ub_l = 1
    else:
        ub_l = 1
    ub_l -= info["Arm_supported_leaning_L"]

    ub_r = 0
    if -70 < rz < 110:
        if abs(ry) < 20:
            pass  # reference quirk (rula.py:183): assigns angle, score stays 0
        elif ry < -20 or (20 < ry <= 45):
            ub_r = 2
        elif 45 < ry <= 90:
            ub_r = 3
        elif ry > 90:
            ub_r = 4
        else:
            ub_r = 1
    elif rz < 20:
        if abs(ry) < 20:
            ub_r = 1
        elif -70 < ry < -20:
            ub_r = 2
        elif ry < -70:
            ub_r = 2
        elif 20 < ry < 70:
            ub_r = 4
        elif ry > 70:
            ub_r = 4
        else:
            ub_r = 1
    else:
        ub_r = 1
    ub_r -= info["Arm_supported_leaning_R"]

    sr_l = 1 if abs(pose[J["L_Thorax"]][2]) >= 10 else 0
    sr_r = 1 if abs(pose[J["R_Thorax"]][2]) >= 10 else 0

    # upper_arm_abducted
    if -110 < lz < -20:
        ab_l = 0 if lz < 45 else (1 if lz > 45 else 0)
    elif lz > -20:
        if abs(ly) < 20:
            ab_l = 1
        elif 20 < ly < 70:
            ab_l = 1
        elif ly > 70:
            ab_l = 0
        elif -70 < ly < -20:
            ab_l = 1
        elif ly < -70:
            ab_l = 0
        else:
            ab_l = 0
    else:
        ab_l = 0

    ab_r = 0
    if 20 < rz < 110:
        if rz > 45:
            ab_r = 0
        elif rz < 45:
            ab_r = 1
        else:
            ab_r = 0
    elif rz < 20:
        if abs(ry) < 20:
            ab_r = 1
        elif -70 < ry < -20:
            ab_r = 1
        elif ry < -70:
            ab_r = 0
        elif 20 < ry < 70:
            ab_r = 1
        elif ry > 70:
            ab_r = 0
        else:
            ab_r = 0

    upper = np.clip(np.array([ub_l + sr_l + ab_l, ub_r + sr_r + ab_r]), 1, 6)

    # lower arm (same thresholds as REBA) + midline deviation
    lmax = max(pose[J["L_Elbow"]][1], pose[J["L_Elbow"]][2])
    rmax = max(pose[J["R_Elbow"]][1], pose[J["R_Elbow"]][2])
    if -100 < lmax < -60:
        la_l = 1
    elif lmax < -100 or (-60 < lmax < 0):
        la_l = 2
    else:
        la_l = 1
    if 60 < rmax < 100:
        la_r = 1
    elif rmax > 100 or (0 < rmax < 60):
        la_r = 2
    else:
        la_r = 1

    ltx = pose[J["L_Thorax"]][0]
    rtx = pose[J["R_Thorax"]][0]
    if ltx < 10 or (-45 < ltx < -10):
        bm_l = 0
    elif ltx > 10 or ltx < -45:
        bm_l = 1
    else:
        bm_l = 0
    if rtx > -10 or (10 < rtx < 45):
        bm_r = 0
    elif rtx < -10 or rtx > 45:
        bm_r = 1
    else:
        bm_r = 0
    lower = np.clip(np.array([la_l + bm_l, la_r + bm_r]), 1, 3)

    # wrist
    def wb(a):
        if abs(a) < 1:
            return 1
        elif 1 < abs(a) < 15:
            return 2
        elif abs(a) > 15:
            return 3
        return 1

    def ws(a):
        return 1 if abs(a) > 10 else 0

    def wt(a):
        return 2 if abs(a) > 45 else 1

    lw, rw = pose[J["L_Wrist"]], pose[J["R_Wrist"]]
    wrist = np.clip(np.array([wb(lw[2]) + ws(lw[1]), wb(rw[2]) + ws(rw[1])]), 1, 4)
    wrist_twist = np.clip(np.array([wt(lw[0]), wt(rw[0])]), 1, 2)

    a_l = tables.RULA_TABLE_A[upper[0] - 1][lower[0] - 1][wrist[0] - 1][wrist_twist[0] - 1]
    a_r = tables.RULA_TABLE_A[upper[1] - 1][lower[1] - 1][wrist[1] - 1][wrist_twist[1] - 1]
    group_a = max(
        a_l + info["A_Muscle_use_L"] + info["A_Load/Force_L"],
        a_r + info["A_Muscle_use_R"] + info["A_Load/Force_R"],
    )

    nx, ny, nz = pose[J["Neck"]]
    tx, ty, tz = pose[J["Torso"]]
    if -5 < nx < 10:
        nb = 1
    elif 10 < nx < 20:
        nb = 2
    elif nx > 20:
        nb = 3
    elif nx < -5:
        nb = 4
    else:
        nb = 1
    if abs(nz) < 10 and abs(ny) < 10:
        nst = 0
    elif abs(nz) > 10 or abs(ny) > 10:
        nst = 1
    else:
        nst = 0
    neck = int(np.clip(nb + nst, 1, 6))

    if abs(tx) < 5:
        tb = 1
    elif 5 < tx < 20:
        tb = 2
    elif 20 < tx < 60:
        tb = 3
    elif tx > 60:
        tb = 4
    else:
        tb = 1
    ttw = 1 if abs(ty) > 10 else 0
    tsb = 1 if abs(tz) > 10 else 0
    trunk = int(np.clip(tb + ttw + tsb, 1, 6))

    leg = int(np.clip(info["Legs_bilateral_weight_bearing"], 1, 2))
    group_b = (
        tables.RULA_TABLE_B[neck - 1][trunk - 1][leg - 1]
        + info["B_Muscle_use"] + info["B_Load/Force"]
    )

    a_c = int(np.clip(group_a, 1, 7))
    b_c = int(np.clip(group_b, 1, 7))
    final = tables.RULA_TABLE_C[a_c - 1][b_c - 1]
    return int(final), [
        *upper.tolist(), *lower.tolist(), *wrist.tolist(), *wrist_twist.tolist(),
        neck, trunk, leg,
    ]
