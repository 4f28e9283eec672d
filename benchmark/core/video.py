"""The video runner: offline scoring of clips on the Predictor's device path.

Each clip is the mix's pool of frames with its stretch of the person track.
Per clip, as Predictor.__call__ and _process_track drive the program: the
detector on every `window`-frame window (YoloDetector.__call__: K2
letterbox, YOLOv3, decode, top-k pull, NMS), when the configuration has
one; then PoseEstimator.run_from_frames over the clip's tracked boxes in
production chunks (upload, up to 4 chunks in flight, fetch; K1 crop,
ResNet-50 + IEF, rotations, joints); then the REBA and RULA scorers. Every
call returns host arrays, so a clip is done when its scores are.

frames_per_s counts every frame of every clip started inside the window,
over the time until the last of them is done: all the work and all the
time. The traced run profiles `stretch_clips` whole clips from 30% of the
window on.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import check, faults, harness, program, trace, traffic, weights
from benchmark.reference import hmr as ref_hmr


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        overrides: Dict = None) -> harness.RunRecord:
    overrides = overrides or {}
    mix, config = dict(cell.mix, **overrides.get("mix", {})), cell.config
    init = config["assumed"]["init"]
    harness.note("start")
    plan = traffic.video_plan(mix, seed)
    harness.note("frames")
    H, W = plan.frame_hw
    clip, window = plan.clip, plan.window
    add_info = program.info(config)
    det_on = "detector" in config
    smpl_path = program.smpl_dir(seed)

    hmr_host = weights.to_host(weights.hmr_params(seed, device, init, plan.frame_hw))
    est = program.pose_estimator(config, weights.to_device(hmr_host, device), smpl_path,
                                 int(mix["chunk"]), device)
    det = yolo_host = None
    if det_on:
        yolo_host = weights.to_host(weights.yolo_params(
            seed, device, init, plan.frame_hw,
            overrides.get("img_size") or int(config["detector"]["img_size"])))
        det = program.detector(config, yolo_host, device, overrides.get("img_size"))
    reba, rula = program.scorers(device)
    harness.note("weights and program")
    pose, detect = est, det
    fault = overrides.get("fault")
    if fault:
        pose, reba = faults.Estimator(est, fault), faults.Scorer(reba, fault)
        detect = faults.Detector(det, fault) if det is not None else None
    spans: Dict[str, List] = {"detector": [], "pose": [], "score": []}
    outputs: List[Dict] = []
    clip_times: List[float] = []
    ids = np.arange(clip)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def run_clip(k: int, record: bool) -> None:
        t_clip = time.perf_counter()
        boxes = plan.boxes(k)
        dets = []
        if detect is not None:
            for w in range(0, clip, window):
                t = time.perf_counter()
                with trace.span("detector", traced):
                    dets += detect(plan.frames[w:w + window])
                if record:
                    spans["detector"].append((time.perf_counter() - t, window))
        t = time.perf_counter()
        with trace.span("pose", traced):
            euler, joint_cam, _aa = pose.run_from_frames(plan.frames, ids, boxes,
                                                         chunk=int(mix["chunk"]))
        if record:
            spans["pose"].append((time.perf_counter() - t, clip))
        t = time.perf_counter()
        with trace.span("score", traced):
            r_reba = reba(euler, joint_cam, add_info)
            r_rula = rula(euler, joint_cam, add_info)
        if record:
            spans["score"].append((time.perf_counter() - t, clip))
            outputs.append({"dets": dets, "euler": euler, "joints": joint_cam,
                            "reba": np.array([r["score"] for r in r_reba]),
                            "rula": np.array([r["score"] for r in r_rula])})
            clip_times.append(time.perf_counter() - t_clip)

    for _ in range(int(mix["warmup_clips"])):
        run_clip(0, record=False)
    sync()
    harness.note("warm-up")
    if traced:
        trace.prime()
    setup_s = harness.process_age_s()

    stretch = {"clips": 0, "boxes": []}
    st = trace.Stretch()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        if traced and st.prof is None and time.perf_counter() - t0 >= 0.3 * seconds:
            st.start()
        run_clip(k, record=True)
        if st.active:
            stretch["clips"] += 1
            stretch["boxes"].append(plan.boxes(k))
            if stretch["clips"] >= int(mix["stretch_clips"]):
                st.end()
        k += 1
    sync()
    elapsed = time.perf_counter() - t0
    st.stop()
    if clip_times:
        ct = np.array(clip_times)
        third = max(1, len(ct) // 3)
        print("[bench] clip seconds: min %.3f median %.3f max %.3f; first third %.3f, last "
              "third %.3f" % (ct.min(), np.median(ct), ct.max(), ct[:third].mean(),
                              ct[-third:].mean()), file=sys.stderr)
    summary = st.summary()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    frames = k * clip
    rec = harness.RunRecord(setup_s=setup_s, e2e={"frames_per_s": frames / elapsed},
                            attempted=frames, failed=0, memory_peak_bytes=peak, spans=spans,
                            trace=summary)
    rec.stretch = {"frames": stretch["clips"] * clip, "boxes": stretch["boxes"],
                   "chunk": int(mix["chunk"]), "window": window, "frame_hw": (H, W),
                   "detector": det_on}

    def judge(control: bool = False):
        """The compared numbers and their limits; control=True puts the
        reference in TF32 in the program's place."""
        nonlocal est, det, pose, detect
        est = det = pose = detect = None
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        det_nums = None
        if det_on:
            per_clip = clip // window
            pick = traffic.sample(k * per_clip, int(mix["check_det_frames"]) // window, seed)
            frames = np.concatenate([plan.frames[(p % per_clip) * window:
                                                 (p % per_clip + 1) * window] for p in pick])
            args = (float(config["detector"]["threshold"]),
                    float(config["detector"]["nms_threshold"]), device)
            img = overrides.get("img_size") or int(config["detector"]["img_size"])
            ref = check.reference_detections(weights.to_device(yolo_host, device), frames, *args,
                                             img_size=img)
            if control:
                port = [kept for _, kept in check.reference_detections(
                    weights.to_device(yolo_host, device), frames, *args, tf32=True,
                    img_size=img)]
            else:
                port = [d for p in pick for d in
                        outputs[p // per_clip]["dets"][(p % per_clip) * window:
                                                       (p % per_clip + 1) * window]]
            det_nums = check.detector_numbers(port, ref)
        pick = traffic.sample(k * clip, int(mix["check_pose_frames"]), seed + 1)
        c, i = pick // clip, pick % clip
        boxes = np.stack([plan.boxes(cc)[ii] for cc, ii in zip(c, i)])
        smpl = {key: torch.from_numpy(v).to(device)
                for key, v in weights.smpl_arrays(seed).items()
                if key in ("v_template", "J_regressor")}
        hp = weights.to_device(hmr_host, device)
        rot, ref_joints = check.reference_pose(hp, smpl, plan.frames[i], boxes, device)
        if control:
            rot_c, joints = check.reference_pose(hp, smpl, plan.frames[i], boxes, device,
                                                 tf32=True)
            euler = ref_hmr.rotmat_to_euler_deg(torch.from_numpy(rot_c)).numpy()
            mism = 0
        else:
            euler = np.stack([outputs[cc]["euler"][ii] for cc, ii in zip(c, i)])
            joints = np.stack([outputs[cc]["joints"][ii] for cc, ii in zip(c, i)])
            mism = sum(check.score_mismatch(o["euler"], o["reba"], o["rula"], add_info)
                       for o in outputs)
        pose_nums = check.pose_numbers(euler, joints, rot, ref_joints)
        return check.judge(config["limits"], det_nums, pose_nums, mism)

    rec.check = judge
    return rec
