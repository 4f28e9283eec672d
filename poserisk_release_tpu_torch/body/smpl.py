"""SMPL body model: chumpy-free asset loading + metadata (numpy; the LBS op
moves the tables to its device).

The reference loads SMPL .pkl files through chumpy at every startup
(reference lib/smplpytorch/smplpytorch/native/webuser/serialization.py:1-39)
and exposes joint metadata via a wrapper class
(reference lib/utils/smpl.py:7-45). Here:

  * `convert_pkl_to_npz` is a one-time host tool that deserialises the SMPL
    pickle WITHOUT chumpy (a stub unpickler maps chumpy arrays to ndarrays)
    and writes a plain .npz.
  * `SMPLModel.load` reads the .npz (or builds a deterministic synthetic
    model when no real asset is present, for tests/benchmarks) and exposes
    the parameter arrays as numpy (ops.lbs.smpl_params_to_torch places
    them on a device).
  * Joint names / skeleton / flip pairs / extended 29-row joint regressor
    (5 one-hot face-keypoint rows for vertices 331/2802/6262/3489/3990)
    match lib/utils/smpl.py:16-42.
"""

from __future__ import annotations

import io
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_BETAS = 10

JOINTS_NAME: Tuple[str, ...] = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
)
JOINTS_NAME_UPPER = tuple(n.upper() for n in JOINTS_NAME)
JOINT_INDEX: Dict[str, int] = {n: i for i, n in enumerate(JOINTS_NAME)}

SKELETON: Tuple[Tuple[int, int], ...] = (
    (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5), (5, 8), (8, 11),
    (0, 3), (3, 6), (6, 9), (9, 14), (14, 17), (17, 19), (19, 21), (21, 23),
    (9, 13), (13, 16), (16, 18), (18, 20), (20, 22), (9, 12), (12, 15),
)

FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
    (20, 21), (22, 23), (25, 26), (27, 28),
)

FACE_KPS_VERTEX = (331, 2802, 6262, 3489, 3990)  # nose, L eye, R eye, L ear, R ear

# Per-joint segment colors for part visualisation (lib/utils/smpl.py:35-36).
PART_SEGMENTS_COLOR = (
    "silver", "blue", "green", "salmon", "turquoise", "olive", "lavender",
    "darkblue", "lime", "khaki", "cyan", "darkgreen", "beige", "coral",
    "crimson", "red", "aqua", "chartreuse", "indigo", "teal", "violet",
    "orchid", "orange", "gold",
)

ROOT_JOINT_IDX = JOINT_INDEX["Pelvis"]

# Canonical SMPL kinematic tree (parent of each of the 24 joints). The root's
# parent entry in the pkl is 2**32-1; the root transform is handled specially
# so the value is unused -- we store 0 here and never index with it for joint 0.
KINTREE_PARENTS: Tuple[int, ...] = (
    0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21
)


class _ChumpyStubArray:
    """Placeholder reconstructed in place of chumpy.Ch objects on unpickle."""

    def __init__(self, *args, **kwargs):
        self.__dict__["x"] = args[0] if args else None

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self):
        return np.asarray(self.__dict__.get("x"))


class _ChumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStubArray
        return super().find_class(module, name)


def _to_array(value) -> np.ndarray:
    if isinstance(value, _ChumpyStubArray):
        value = value.r
    if hasattr(value, "toarray"):  # scipy sparse (J_regressor)
        value = value.toarray()
    if hasattr(value, "r") and not isinstance(value, np.ndarray):
        value = value.r
    return np.asarray(value)


def convert_pkl_to_npz(pkl_path: str, npz_path: str) -> None:
    """One-time host tool: SMPL chumpy pickle -> plain npz parameter file."""
    with open(pkl_path, "rb") as f:
        data = _ChumpyUnpickler(io.BytesIO(f.read()), encoding="latin1").load()

    out = {
        "v_template": _to_array(data["v_template"]).astype(np.float32),
        "shapedirs": _to_array(data["shapedirs"]).astype(np.float32),
        "posedirs": _to_array(data["posedirs"]).astype(np.float32),
        "J_regressor": _to_array(data["J_regressor"]).astype(np.float32),
        "weights": _to_array(data["weights"]).astype(np.float32),
        "kintree_parents": _to_array(data["kintree_table"])[0].astype(np.int64),
        "faces": _to_array(data["f"]).astype(np.int32),
    }
    betas = data.get("betas")
    out["betas"] = (
        _to_array(betas).astype(np.float32)
        if betas is not None
        else np.zeros(out["shapedirs"].shape[-1], np.float32)
    )
    np.savez(npz_path, **out)


def synthetic_smpl_arrays(
    num_verts: int = NUM_VERTS, num_joints: int = NUM_JOINTS, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic, structurally faithful stand-in for a real SMPL asset.

    Used by tests and by benchmark runs when the real (licensed) SMPL pickle
    is not present. Shapes, dtypes, kinematic tree, and normalisation
    properties (J_regressor rows and skinning weights rows sum to 1) match
    the real model so the LBS code path is identical.
    """
    rng = np.random.RandomState(seed)
    kintree = np.array(KINTREE_PARENTS[:num_joints], np.int64)

    # Rest-pose joint locations: a rough humanoid so kinematics are sane.
    joints = np.zeros((num_joints, 3), np.float32)
    for j in range(1, num_joints):
        direction = rng.normal(size=3).astype(np.float32)
        direction /= np.linalg.norm(direction) + 1e-6
        joints[j] = joints[kintree[j]] + direction * 0.12

    # Vertices scattered around their governing joint.
    owner = rng.randint(0, num_joints, size=num_verts)
    v_template = joints[owner] + rng.normal(scale=0.05, size=(num_verts, 3)).astype(np.float32)

    # Skinning weights: soft assignment to owner + its parent.
    weights = np.zeros((num_verts, num_joints), np.float32)
    w_own = rng.uniform(0.6, 1.0, size=num_verts).astype(np.float32)
    weights[np.arange(num_verts), owner] = w_own
    weights[np.arange(num_verts), kintree[owner]] += 1.0 - w_own
    weights /= weights.sum(axis=1, keepdims=True)

    # Joint regressor: average of the vertices owned by each joint.
    j_reg = np.zeros((num_joints, num_verts), np.float32)
    for j in range(num_joints):
        members = np.where(owner == j)[0]
        if len(members) == 0:
            members = np.array([j % num_verts])
        j_reg[j, members] = 1.0 / len(members)

    shapedirs = rng.normal(scale=0.01, size=(num_verts, 3, NUM_BETAS)).astype(np.float32)
    posedirs = rng.normal(scale=0.001, size=(num_verts, 3, 9 * (num_joints - 1))).astype(
        np.float32
    )

    # Arbitrary (non-degenerate) triangulation for obj export paths.
    faces = np.stack(
        [
            np.arange(num_verts - 2),
            np.arange(1, num_verts - 1),
            np.arange(2, num_verts),
        ],
        axis=1,
    ).astype(np.int32)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_reg,
        "weights": weights,
        "kintree_parents": kintree,
        "faces": faces,
        "betas": np.zeros(NUM_BETAS, np.float32),
    }


@dataclass(frozen=True)
class SMPLModel:
    """Immutable SMPL parameter set (numpy on the host; ops.lbs places it on a device)."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, 10)
    posedirs: np.ndarray  # (V, 3, 9*(J-1))
    J_regressor: np.ndarray  # (J, V)
    weights: np.ndarray  # (V, J)
    kintree_parents: np.ndarray  # (J,)
    faces: np.ndarray  # (F, 3)
    betas: np.ndarray  # (10,) template betas (used when input betas are all-zero)
    gender: str = "neutral"

    @property
    def num_verts(self) -> int:
        return int(self.v_template.shape[0])

    @property
    def num_joints(self) -> int:
        return int(self.J_regressor.shape[0])

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], gender: str = "neutral") -> "SMPLModel":
        return cls(gender=gender, **{k: np.asarray(v) for k, v in arrays.items()})

    @classmethod
    def load(cls, model_dir: str, gender: str = "neutral", allow_synthetic: bool = True) -> "SMPLModel":
        """Load SMPL_{GENDER}.npz from model_dir, converting the .pkl if needed.

        Falls back to the deterministic synthetic model when no asset exists
        (and allow_synthetic is True), so every pipeline stage stays runnable
        without the licensed download.
        """
        npz_path = osp.join(model_dir, f"SMPL_{gender.upper()}.npz")
        pkl_path = osp.join(model_dir, f"SMPL_{gender.upper()}.pkl")
        if not osp.isfile(npz_path) and osp.isfile(pkl_path):
            convert_pkl_to_npz(pkl_path, npz_path)
        if osp.isfile(npz_path):
            with np.load(npz_path) as data:
                return cls.from_arrays({k: data[k] for k in data.files}, gender=gender)
        if not allow_synthetic:
            raise FileNotFoundError(f"No SMPL asset for gender={gender} in {model_dir}")
        return cls.from_arrays(synthetic_smpl_arrays(), gender=gender)

    def vertex_segmentation(self) -> np.ndarray:
        """Dominant-joint index per vertex: argmax of the skinning weights
        (the reference's vertice_segmentation buffer, smpl_layer.py:57)."""
        return np.argmax(self.weights, axis=1)

    def extended_joint_regressor(self) -> np.ndarray:
        """(J+5, V) regressor with one-hot face-keypoint rows appended.

        Parity with lib/utils/smpl.py:16-28 (nose/L-eye/R-eye/L-ear/R-ear as
        one-hot vertex selectors stacked under the 24 SMPL joint rows).
        """
        rows = [self.J_regressor.astype(np.float32)]
        for vidx in FACE_KPS_VERTEX:
            onehot = np.zeros((1, self.num_verts), np.float32)
            onehot[0, vidx % self.num_verts] = 1.0
            rows.append(onehot)
        return np.concatenate(rows, axis=0)


class SMPLFamily:
    """All three gendered models, mirroring lib/utils/smpl.py's layer dict."""

    def __init__(self, model_dir: str, allow_synthetic: bool = True):
        self.models = {
            g: SMPLModel.load(model_dir, gender=g, allow_synthetic=allow_synthetic)
            for g in ("neutral", "male", "female")
        }
        neutral = self.models["neutral"]
        self.face = neutral.faces
        self.joint_regressor = neutral.extended_joint_regressor()
        self.vertex_num = neutral.num_verts
        self.joint_num = NUM_JOINTS
        self.joints_name = JOINTS_NAME
        self.joints_name_upper = list(JOINTS_NAME_UPPER)
        self.skeleton = SKELETON
        self.flip_pairs = FLIP_PAIRS
        self.part_segments_color = PART_SEGMENTS_COLOR
        self.root_joint_idx = ROOT_JOINT_IDX

    def __getitem__(self, gender: str) -> SMPLModel:
        return self.models[gender]
