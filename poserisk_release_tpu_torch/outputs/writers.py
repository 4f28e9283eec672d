"""File writers with reference-identical formats: obj mesh, debug CSVs.

Formats pinned to the reference:
  * save_obj: 'v x y z' with str(float) and 'f a/a b/b c/c' 1-based
    (reference lib/utils/vis_utils.py:238-245);
  * pose_log.csv (base.py:329-349), {title}_score_log.csv and
    {title}_eval_pose_log.csv (base.py:351-397) -- same headers, same
    frame-gap behaviour (rows for undetected frames carry only the index).
"""

from __future__ import annotations

import csv
import os.path as osp
from typing import Dict, List, Sequence

import numpy as np


def save_obj(vertices: np.ndarray, faces: np.ndarray | None, file_name: str) -> None:
    with open(file_name, "w") as f:
        for v in vertices:
            f.write("v " + str(v[0]) + " " + str(v[1]) + " " + str(v[2]) + "\n")
        if faces is not None:
            for face in faces:
                a, b, c = int(face[0]) + 1, int(face[1]) + 1, int(face[2]) + 1
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")


def pose_to_str(poses: np.ndarray) -> List[List[str]]:
    """Per-frame, per-joint '(x, y, z)' strings (vis_utils.py:9-16 format)."""
    out = []
    for pose in poses:
        out.append([f"({p[0]:.3f}, {p[1]:.3f}, {p[2]:.3f})" for p in pose])
    return out


def save_csv_pose_log(
    pose_str: List[List[str]],
    timestamp,
    debug_joints: Sequence[str],
    joints_name_upper: Sequence[str],
    output_path: str,
) -> None:
    with open(osp.join(output_path, "pose_log.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["Frame", "Joint Pose"] + list(debug_joints))
        frames = timestamp[1]
        for i in range(timestamp[0], timestamp[-1]):
            row = [i]
            if i in frames:
                idx = int(np.where(frames == i)[0][0])
                row.append("")
                for joint in debug_joints:
                    joint_idx = list(joints_name_upper).index(joint.upper())
                    row.append(str(pose_str[idx][joint_idx]))
            wr.writerow(row)


def save_score_log_csv(
    timestamp,
    scores: np.ndarray,
    joint_names: Sequence[str],
    logs: np.ndarray,
    output_path: str,
    title: str,
) -> None:
    with open(osp.join(output_path, title + "_score_log.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["Frame", "Final_score", "Joint Score"] + list(joint_names))
        frames = timestamp[1]
        for i in range(timestamp[0], timestamp[-1]):
            row = [i]
            if i in frames:
                idx = int(np.where(frames == i)[0][0])
                row.append(str(scores[idx]))
                row.append("")
                for j, _ in enumerate(joint_names):
                    row.append(str(logs[idx][j]))
            wr.writerow(row)


def save_eval_pose_log_csv(
    timestamp,
    pose_logs: List[Dict[str, str]],
    output_path: str,
    title: str,
) -> None:
    with open(osp.join(output_path, title + "_eval_pose_log.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        eval_names = list(pose_logs[0].keys())
        wr.writerow(["Frame", ""] + eval_names)
        frames = timestamp[1]
        for i in range(timestamp[0], timestamp[-1]):
            row = [i]
            if i in frames:
                idx = int(np.where(frames == i)[0][0])
                row.append("")
                for name in eval_names:
                    row.append(str(pose_logs[idx][name]))
            wr.writerow(row)
