"""The reference's post-detection hot loop on the host CPU, and the port's step beside it.

    python -m poserisk_release_tpu_torch.tools.bench_reference_hotloop [--frames 64] [--with-ours] [--cpu]

The counterpart of the JAX repo's tools/bench_reference_hotloop.py. The
reference publishes no throughput, so this measures its hot loop, as it
runs it, on this host's CPU in frames/s:

  1. SPIN forward, torch on the CPU, batch 8 (the reference's batch), in
     eval mode under no_grad, with the host pull of the rotmats and the
     copy of each batch's images: the port's HMR (models/spin.HMR, the
     reference's module layout) with weights seeded from `seed`;
  2. per frame, serially: 24 Rodrigues mat -> vec, then 24 Rodrigues vec
     -> mat, the XYZ Euler extraction and the reference's euler_to_rotMat
     round-trip check (numpy restatements of cv2.Rodrigues and the
     reference's coord_utils, below);
  3. get_joint_cam: one batch-1 SMPL forward per frame (ops/lbs.LBS on the
     CPU, the 6890-vertex mesh included), the root pose forced to (3.14, 0,
     0), x 1000 mm, root-centred;
  4. the per-frame REBA and RULA rule chains (tools/reference_rules).

Left out, all of which the reference also pays, so the number is an upper
bound on its rate: video decode, the per-frame jpg round trip, YOLOv3,
SORT, the crop, rendering, stats and plots.

--with-ours also measures the port's pose + score step
(throughput.make_pose_and_score_step: the same four stages in one step)
on the port's device, the card unless --cpu names the CPU, after one
warm-up call; the ratio of the two rates prints beside them.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

DBL_EPSILON = np.finfo(np.float64).eps


def rodrigues_vec_to_mat(aa) -> np.ndarray:
    """cv2.Rodrigues, axis-angle (3,) -> rotation matrix (3, 3), float64:
    R = cos(t) I + (1 - cos(t)) r r^T + sin(t) [r]x, identity below
    DBL_EPSILON."""
    r = np.asarray(aa, np.float64).reshape(3)
    theta = math.sqrt(float(r @ r))
    if theta < DBL_EPSILON:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    x, y, z = r / theta
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return c * np.eye(3) + (1.0 - c) * rrt + s * r_x


def rodrigues_mat_to_vec(R) -> np.ndarray:
    """cv2.Rodrigues, rotation matrix (3, 3) -> axis-angle (3,), float64:
    the matrix orthogonalised through its SVD, the angle from the trace and
    the axis from the skew part, with OpenCV's branch near 180 degrees."""
    U, _w, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = math.sqrt(float(r @ r) * 0.25)
    c = min(1.0, max(-1.0, (R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5))
    theta = math.acos(c)
    if s >= 1e-5:
        return r * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    r = np.array([math.sqrt(max((R[0, 0] + 1.0) * 0.5, 0.0)),
                  math.sqrt(max((R[1, 1] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0),
                  math.sqrt(max((R[2, 2] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)])
    if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (R[1, 2] > 0) != (r[1] * r[2] > 0):
        r[2] = -r[2]
    return r * (theta / math.sqrt(float(r @ r)))


def euler_from_rotmat_xyz(R) -> np.ndarray:
    """The reference's rotationMatrixToEulerAngles (x, y, z radians)."""
    sy = math.sqrt(R[0, 0] * R[0, 0] + R[1, 0] * R[1, 0])
    if sy >= 1e-6:
        return np.array([math.atan2(R[2, 1], R[2, 2]), math.atan2(-R[2, 0], sy),
                         math.atan2(R[1, 0], R[0, 0])])
    return np.array([math.atan2(-R[1, 2], R[1, 1]), math.atan2(-R[2, 0], sy), 0.0])


def rotmat_from_euler_zyx_composition(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """The reference's euler_to_rotMat: Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Rz @ Ry @ Rx


def frame_eulers(rotmat) -> tuple:
    """Stage 2 for one frame's (24, 3, 3) rotmats: (axis-angle (24, 3),
    Euler degrees (24, 3)), raising if the round trip fails."""
    pose = np.stack([rodrigues_mat_to_vec(p) for p in rotmat])
    eulers = []
    for aa in pose:
        R = rodrigues_vec_to_mat(aa)
        e = euler_from_rotmat_xyz(R)
        R2 = rotmat_from_euler_zyx_composition(e[2], e[1], e[0])
        if (R - R2).sum() > 0.1:
            raise AssertionError("euler round trip")
        eulers.append(e * 180.0 / np.pi)
    return pose, np.stack(eulers)


def measure_reference(frames: int, batch: int, seed: int) -> dict:
    """The hot loop over `frames` seeded crops on the host CPU:
    {"elapsed_s", "fps", "stages_s": {spin, conversions, joint_cam,
    scoring}}."""
    from poserisk_release_tpu_torch.body.smpl import SMPLModel
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params
    from poserisk_release_tpu_torch.ops.lbs import LBS
    from poserisk_release_tpu_torch.pipeline import load_add_info
    from poserisk_release_tpu_torch.tools import reference_rules as rules

    cfg = default_config()
    mean = load_mean_params("")
    model = HMR(n_iter=cfg.SPIN.ief_iters, mean_params=mean)
    model.load_state_dict(init_spin_params(torch.Generator().manual_seed(seed), mean))
    model.eval()
    lbs = LBS(SMPLModel.load(cfg.SPIN.smpl_model_dir), device="cpu")
    info = load_add_info(cfg, "")

    rng = np.random.default_rng(seed)
    crops = rng.random((frames, 3, 224, 224), np.float32)  # [0, 1], NCHW as the reference
    stages = {"spin": 0.0, "conversions": 0.0, "joint_cam": 0.0, "scoring": 0.0}
    t_total = time.perf_counter()
    images, result, debug_result = [], [], []
    with torch.no_grad():
        for start in range(0, frames, batch):
            chunk = torch.from_numpy(crops[start:start + batch])
            t0 = time.perf_counter()
            pred_rotmat = model(chunk.permute(0, 2, 3, 1))[0].cpu().numpy()
            images.append(chunk.cpu().numpy())
            stages["spin"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            for rotmat in pred_rotmat:
                pose, euler = frame_eulers(rotmat)
                debug_result.append(pose)
                result.append(euler)
            stages["conversions"] += time.perf_counter() - t0
    result = np.stack(result)
    images = np.concatenate(images)

    t0 = time.perf_counter()
    joint_cam = []
    with torch.no_grad():
        for pose in debug_result:
            p = pose.astype(np.float32)
            p[0] = (3.14, 0.0, 0.0)
            _verts, joints = lbs(p.reshape(1, -1))
            j = joints[0].numpy() * 1000.0
            joint_cam.append(j - j[0, None])
    joint_cam = np.stack(joint_cam)
    stages["joint_cam"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    reba = [rules.reba_frame(p, info["REBA"])[0] for p in result]
    rula = [rules.rula_frame(p, info["RULA"])[0] for p in result]
    stages["scoring"] += time.perf_counter() - t0
    elapsed = time.perf_counter() - t_total
    assert len(reba) == frames and len(rula) == frames
    assert joint_cam.shape == (frames, 24, 3) and images.shape[0] == frames
    return {"elapsed_s": elapsed, "fps": frames / elapsed, "stages_s": stages}


def measure_ours(frames: int, seed: int, device, passes: int = 3) -> dict:
    """The port's pose + score step (strict f32, the estimator's seeded
    weights) on `frames` seeded crops on `device`: one warm-up call, then
    the mean of `passes` calls each ended by a readback. {"elapsed_s",
    "fps", "warmup_s", "device"}."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_pose_and_score_step,
    )
    from poserisk_release_tpu_torch.tools.timing import device_name

    cfg = default_config()
    est = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device=device)
    infos = [torch.as_tensor(a, device=device) for a in default_packed_infos()]
    step = make_pose_and_score_step(est.parents)
    rng = np.random.default_rng(seed)
    crops = torch.as_tensor(rng.random((frames, 224, 224, 3), np.float32), device=device)

    def call():
        with torch.inference_mode():
            out = step(est.model, est.smpl_params, crops, *infos)
        return float(out[0].sum())  # one readback ends the call

    t0 = time.perf_counter()
    call()
    warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(passes):
        call()
    elapsed = (time.perf_counter() - t0) / passes
    return {"elapsed_s": elapsed, "fps": frames / elapsed, "warmup_s": warmup,
            "device": device_name(device)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="the reference's SPIN batch size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-ours", action="store_true",
                    help="also measure the port's pose + score step on its device")
    ap.add_argument("--cpu", action="store_true", help="run --with-ours on the CPU")
    return ap


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch.device import resolve_device

    args = parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None) if args.with_ours else None

    ref = measure_reference(args.frames, args.batch, args.seed)
    print(f"reference hot loop (torch CPU, batch {args.batch}, {args.frames} frames; "
          "decode/detect/crop EXCLUDED):")
    for name, sec in ref["stages_s"].items():
        print(f"  {name:12s} {sec:7.2f} s  ({sec / args.frames * 1000:7.1f} ms/frame)")
    print(f"  total        {ref['elapsed_s']:7.2f} s -> {ref['fps']:.2f} fps "
          "(an upper bound on the reference's end-to-end rate on this host)")
    out = {"metric": "reference_hotloop_fps_host_cpu", "value": round(ref["fps"], 3),
           "frames": args.frames,
           "stages_ms_per_frame": {k: round(v / args.frames * 1000, 2)
                                   for k, v in ref["stages_s"].items()}}
    if args.with_ours:
        ours = measure_ours(args.frames, args.seed, device)
        print(f"the port's pose + score step on {ours['device']} (warm-up "
              f"{ours['warmup_s']:.2f} s excluded): {ours['fps']:.2f} fps")
        print(f"port / reference: {ours['fps'] / ref['fps']:.1f}x")
        out.update(ours_fps=round(ours["fps"], 2), ours_device=ours["device"],
                   ours_vs_reference=round(ours["fps"] / ref["fps"], 2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
