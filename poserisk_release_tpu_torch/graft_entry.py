"""Entry points of the port: the single-device compile check and the mesh dry run.

The counterparts of the JAX repo's __graft_entry__.entry() and
__graft_entry__.dryrun_multichip(). JAX's dry run shards one process's
arrays over n (virtual) devices; here n spawned ranks join one
torch.distributed group (parallel/distributed.run_ranks), each on its own
device, and every rank holds the whole batch and runs its rows.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

# The sections' agreement with the single-process step on the whole batch.
F32_RTOL = 1e-5  # of max(1, |reference|): the f32 steps and the resample
BF16_ATOL = 4.0 / 255.0  # det_best of the bf16 int8 step (PERF.md section 2)
AXIS_TOL = {"tp": 5e-2, "sp": 5e-2, "pp": 1e-3, "ep": 1e-3}  # deg and mm, as JAX
PP_SHARE = 0.31  # the largest rank's SPIN bytes against the whole HMR's
DRYRUN_TIMEOUT_S = 900


def entry(device=None):
    """(fn, example_args) for the strict pose + score step on `device`
    (CUDA unless the CPU is named; without a card it raises).

    fn: crops (B, 224, 224, 3) float32 in [0, 1] on the device -> (reba
    (B,), rula (B,), euler (B, 24, 3), joint_cam (B, 24, 3)): SPIN
    (ResNet-50 + 3-step IEF, the estimator's seeded weights unless a
    checkpoint exists) + rotation conversions + SMPL joints + both scorers,
    throughput.make_pose_and_score_step with the default packed infos.
    example_args: (zeros (8, 224, 224, 3) float32 on the device,).
    """
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_pose_and_score_step,
    )

    device = resolve_device(device)
    cfg = default_config()
    estimator = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device=device)
    step = make_pose_and_score_step(estimator.parents)
    info_reba, info_rula = (torch.as_tensor(a, device=device) for a in default_packed_infos())

    def fn(crops: torch.Tensor):
        with torch.inference_mode():
            return step(estimator.model, estimator.smpl_params, crops, info_reba, info_rula)

    example_args = (torch.zeros((8, 224, 224, 3), dtype=torch.float32, device=device),)
    return fn, example_args


def dryrun_inputs(n_devices: int) -> dict:
    """The dry run's seeded inputs (np.random.RandomState(0)), JAX's shapes
    with data in place of its zeros: 2n crops of 64x64 in [0, 1), 2n uint8
    frames of 64x64 with boxes around [32, 32, 20, 20], and for the model
    axes 2n uint8 frames of 64x96 with boxes around [48, 32, 24, 24]."""
    rng = np.random.RandomState(0)
    b = 2 * n_devices
    return {
        "crops": rng.rand(b, 64, 64, 3).astype(np.float32),
        "frames": rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8),
        "boxes": (np.tile(np.float32([32.0, 32.0, 20.0, 20.0]), (b, 1))
                  + rng.uniform(-4.0, 4.0, (b, 4)).astype(np.float32)),
        "axis_frames": rng.randint(0, 256, (b, 64, 96, 3)).astype(np.uint8),
        "axis_boxes": (np.tile(np.float32([48.0, 32.0, 24.0, 24.0]), (b, 1))
                       + rng.rand(b, 4).astype(np.float32)),
    }


def _max_diff(got, want, wrap: bool = False) -> float:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if wrap:  # Euler angles: the short way round
        d = np.minimum(d, 360.0 - d)
    return float(d.max()) if d.size else 0.0


def _f32_ok(got, want) -> bool:
    return _max_diff(got, want) <= F32_RTOL * max(1.0, float(np.abs(want).max()))


def _host(out) -> list:
    return [t.detach().float().cpu().numpy() if t.is_floating_point() else
            t.detach().cpu().numpy() for t in out]


def _dryrun_rank(rank: int, root: str, cpu: bool) -> None:
    """One rank of dryrun_multichip: JAX's sections in its order, each on
    the data mesh over every rank, each counted (K1, K2, seconds); rank 0
    also runs the single-process step on the whole batch and holds each
    section against it, gathers every rank's counts and scores, prints JAX's
    OK line when every section holds and writes the record to
    root/record.pt."""
    import torch.distributed as dist

    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.models.detector import (
        YoloV3,
        calibrate_yolo_activations,
        fold_bn_params,
        init_yolo_params,
        quantize_yolo_params,
    )
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect
    from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop
    from poserisk_release_tpu_torch.parallel import mesh as pmesh
    from poserisk_release_tpu_torch.parallel import spmd
    from poserisk_release_tpu_torch.parallel.collectives import transport
    from poserisk_release_tpu_torch.parallel.distributed import rank_device
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, load_spin_variables
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_full_frame_step,
        make_pose_and_score_step,
        score_histogram_psum,
    )
    from poserisk_release_tpu_torch.tools.ab import launches

    n = dist.get_world_size()
    # CPU ranks take one thread each, as the mesh tests' ranks do: n ranks
    # beside other processes must not oversubscribe the host.
    torch.set_num_threads(1 if cpu else max(1, (os.cpu_count() or 1) // n))
    device = rank_device(cpu=cpu)
    cuda = device.type == "cuda"
    lead = rank == 0
    inputs = dryrun_inputs(n)
    cfg = default_config().replace(PARALLEL={"num_devices": 1})
    family = SMPLFamily(cfg.SPIN.smpl_model_dir)
    variables = load_spin_variables(cfg)
    est = PoseEstimator(cfg, family, variables=variables, device=device)
    model, smpl, parents = est.model, est.smpl_params, est.parents
    mesh = spmd.mesh_from_config(cfg.replace(PARALLEL={"num_devices": n}).PARALLEL)
    infos = tuple(torch.as_tensor(a, device=device) for a in default_packed_infos())
    crops = torch.as_tensor(inputs["crops"], device=device)
    frames = torch.as_tensor(inputs["frames"], device=device)
    boxes = torch.as_tensor(inputs["boxes"], device=device)
    sections: dict = {}

    def counted(name, fn):
        if cuda:
            torch.cuda.synchronize(device)
        k1, k2 = launches()
        t0 = time.perf_counter()
        rec = fn() or {}
        if cuda:
            torch.cuda.synchronize(device)
        rec["seconds"] = time.perf_counter() - t0
        k1_1, k2_1 = launches()
        rec["k1"], rec["k2"] = k1_1 - k1, k2_1 - k2
        sections[name] = rec

    def check(got, want, float_ok):
        """Scores exactly equal, each float output within its class."""
        got, want = _host(got), _host(want)
        same = all(np.array_equal(g, w) for g, w in zip(got, want) if not g.dtype.kind == "f")
        floats = [(g, w) for g, w in zip(got, want) if g.dtype.kind == "f"]
        return {"scores_equal": same, "float_max_abs_diff": [_max_diff(g, w) for g, w in floats],
                "ok": bool(same and all(float_ok(g, w) for g, w in floats)
                           and all(g.shape == w.shape for g, w in zip(got, want)))}

    # 1. dp over frames: the pose + score step, 2 crops a rank.
    def dp_pose():
        with torch.inference_mode():
            got = make_pose_and_score_step(parents, mesh=mesh)(model, smpl, crops, *infos)
            rec = {"reba": got[0].cpu().tolist(), "rula": got[1].cpu().tolist()}
            if lead:
                want = make_pose_and_score_step(parents)(model, smpl, crops, *infos)
                rec.update(check(got, want, _f32_ok))
        return rec

    counted("dp_pose", dp_pose)
    reba = torch.as_tensor(sections["dp_pose"]["reba"], device=device)

    # 2. The score histogram over the data group: this rank's scores only.
    def histogram():
        hist = score_histogram_psum(pmesh.shard_rows(reba, mesh),
                                    pmesh.axis_group(mesh, pmesh.DATA_AXIS))
        hist = hist.cpu().numpy()
        want = np.bincount(np.clip(reba.cpu().numpy() - 1, 0, 11), minlength=12)
        return {"hist": hist.astype(np.int64).tolist(), "bincount": want.tolist(),
                "ok": bool(hist.sum() == 2 * n and np.array_equal(hist, want))}

    counted("histogram", histogram)

    # 3.-5. The full-frame step at img_size 64 (letterbox + YOLOv3 + crop +
    # pose + scores), the frames and boxes over the data axis.
    cl = torch.channels_last
    folded = fold_bn_params(init_yolo_params(0))
    yolo = YoloV3.from_state_dict(folded).to(device, memory_format=cl)
    bf16_model = PoseEstimator(cfg, family, variables=variables, fast=True, device=device).model
    with torch.inference_mode():
        absmax = calibrate_yolo_activations(yolo, letterbox_device_rect(frames[:2], 64))
    q_yolo = YoloV3.from_state_dict(quantize_yolo_params(folded, absmax)).to(
        device, memory_format=cl)
    full_configs = {
        "full_step": (yolo, model, {}, _f32_ok),
        "int8_step": (q_yolo, bf16_model, {"compute_dtype": torch.bfloat16, "det_stride": 2},
                      lambda g, w: _max_diff(g, w) <= BF16_ATOL),
        "pose_stride_step": (yolo, model, {"det_stride": 2, "pose_stride": 2}, _f32_ok),
    }
    for name, (yolo_m, spin_m, kw, float_ok) in full_configs.items():
        def full(yolo_m=yolo_m, spin_m=spin_m, kw=kw, float_ok=float_ok, name=name):
            step = make_full_frame_step(parents, yolo_m, img_size=64, mesh=mesh, **kw)
            got = step(spin_m, smpl, frames, boxes, *infos)
            rec = {"reba": got[0].cpu().tolist(), "det_best_entries": int(got[2].shape[0])}
            if lead:
                want = make_full_frame_step(parents, yolo_m, img_size=64, **kw)(
                    spin_m, smpl, frames, boxes, *infos)
                rec.update(check(got, want, float_ok))
                rec["ok"] = rec["ok"] and got[0].shape[0] == 2 * n and (
                    got[2].shape[0] == (2 * n) // kw.get("det_stride", 1))
            return rec

        counted(name, full)

    # The row split's contract: 2 rows a rank are no multiple of det_stride 4.
    def stride_guard():
        step = make_full_frame_step(parents, yolo, img_size=64, det_stride=4, mesh=mesh)
        try:
            step(model, smpl, frames, boxes, *infos)
        except ValueError as exc:
            return {"ok": True, "message": str(exc)}
        return {"ok": False}

    counted("stride_guard", stride_guard)

    # 6. K2 alone under the same row split.
    def fused_resample():
        with torch.inference_mode():
            local = fused_letterbox_crop(pmesh.shard_rows(frames, mesh),
                                         pmesh.shard_rows(boxes, mesh), img_size=64, out_size=32)
            got = tuple(pmesh.gather_rows(t.contiguous(), mesh) for t in local)
            rec = {"letterbox_shape": list(got[0].shape), "crop_shape": list(got[1].shape)}
            if lead:
                want = fused_letterbox_crop(frames, boxes, img_size=64, out_size=32)
                rec.update(check(got, want, lambda g, w: np.array_equal(g, w)))
        return rec

    counted("fused_resample", fused_resample)
    del yolo, q_yolo, bf16_model

    # 7. The model axes through the config path, and one dp x tp training step.
    if n >= 4 and n % 4 == 0:
        _model_axes(rank, n, device, cfg, family, variables, inputs, counted)

    # Every rank's outputs are the whole batch's: they must equal rank 0's.
    gathered = [None] * n
    dist.all_gather_object(gathered, (str(device), sections))
    if not lead:
        return
    devices = [d for d, _ in gathered]
    gathered = [g for _, g in gathered]
    for name, rec in sections.items():
        rec["k1"] = [g[name]["k1"] for g in gathered]
        rec["k2"] = [g[name]["k2"] for g in gathered]
        rec["seconds"] = max(g[name]["seconds"] for g in gathered)
        if "reba" in rec:
            rec["ranks_equal"] = all(g[name]["reba"] == rec["reba"] for g in gathered)
            rec["ok"] = rec.get("ok", False) and rec["ranks_equal"]
    record = {"n_devices": n, "transport": transport(),
              "devices": devices, "sections": sections,
              "ok": all(rec.get("ok", False) for rec in sections.values())}
    if record["ok"]:
        s = sections
        axes = {k: s[k]["ok"] if k in s else None for k in ("tp", "sp", "pp", "ep")}
        print(f"dryrun_multichip OK: {n} devices, reba={s['dp_pose']['reba'][:4]}, "
              f"hist={s['histogram']['hist']}, full-step reba={s['full_step']['reba'][:4]}, "
              f"int8-step reba={s['int8_step']['reba'][:4]}, "
              f"pose-stride reba={s['pose_stride_step']['reba'][:4]}, "
              f"tp={axes['tp']}, sp={axes['sp']}, pipeline={axes['pp']}, "
              f"experts={axes['ep']}, dp-x-tp train loss={s.get('train', {}).get('loss')}",
              flush=True)
    torch.save(record, os.path.join(root, "record.pt"))


def _model_axes(rank, n, device, cfg, family, variables, inputs, counted) -> None:
    """JAX's tp / sp / pp / ep block through PoseEstimator from PARALLEL
    (frames_per_step 8, 2n frames of 64x96 and 64x64 crops), then one
    dp 2 x tp n/2 TrainState step. Rank 0 holds each against the
    single-device estimator."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from poserisk_release_tpu_torch.pipeline import PoseEstimator
    from poserisk_release_tpu_torch.train.step import TrainState

    lead = rank == 0
    base = cfg.replace(MODEL={"input_shape": (64, 64)},
                       PARALLEL={"frames_per_step": 8, "num_devices": 1})
    frames, boxes = inputs["axis_frames"], inputs["axis_boxes"]
    ids = np.arange(len(frames))
    ref = None
    if lead:
        ref_est = PoseEstimator(base, family, variables=variables, device=device)
        ref = ref_est.run_from_frames(frames, ids, boxes)
        total_bytes = ref_est.param_bytes
        del ref_est

    def run_axis(name, parallel, gender=None):
        est = PoseEstimator(base.replace(PARALLEL={"frames_per_step": 8, **parallel}), family,
                            variables=variables, device=device)
        result = est.run_from_frames(frames, ids, boxes)
        bytes_all = [None] * n
        dist.all_gather_object(bytes_all, est.param_bytes)
        rec = {"mesh": {k: int(est.mesh.size(i)) for i, k in enumerate(est.mesh.mesh_dim_names)},
               "param_bytes": bytes_all}
        if lead:
            d_e = _max_diff(result[0], ref[0], wrap=True)
            d_j = _max_diff(result[1], ref[1])
            rec.update(euler_max_abs_diff_deg=d_e, joint_max_abs_diff_mm=d_j,
                       ok=bool(d_e < AXIS_TOL[name] and d_j < AXIS_TOL[name]))
        return est, rec

    def tp():
        return run_axis("tp", {"model": n // 2, "num_devices": 2})[1]

    def sp():
        return run_axis("sp", {"spatial": n // 2, "num_devices": 2})[1]

    def pp():
        _est, rec = run_axis("pp", {"stage": 4, "num_devices": n // 4, "stage_microbatches": 2})
        if lead:
            share = max(rec["param_bytes"]) / total_bytes
            rec.update(total_bytes=total_bytes, largest_share=share,
                       ok=rec["ok"] and share < PP_SHARE)
        return rec

    def ep():
        est, rec = run_axis("ep", {"expert": 4, "num_devices": n // 4})
        est.set_gender("male")
        _e, jc_m, _ = est.run_from_frames(frames, ids, boxes)
        if lead:
            male = PoseEstimator(base, family, variables=variables, gender="male",
                                 device=device).run_from_frames(frames, ids, boxes)
            d_m = _max_diff(jc_m, male[1])
            rec.update(male_joint_max_abs_diff_mm=d_m, ok=rec["ok"] and d_m < AXIS_TOL["ep"])
        return rec

    def train():
        mesh_device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        tp_mesh = init_device_mesh(mesh_device, (2, n // 2), mesh_dim_names=("data", "model"))
        state = TrainState.create(cfg, family, variables=variables, mesh=tp_mesh, device=device)
        targets = np.zeros((2 * n, 24, 3), np.float32)
        _state, loss = state.step(inputs["crops"], targets)
        return {"loss": float(loss), "ok": bool(np.isfinite(loss))}

    for name, fn in (("tp", tp), ("sp", sp), ("pp", pp), ("ep", ep), ("train", train)):
        counted(name, fn)


def dryrun_multichip(n_devices: int, cpu: bool = False) -> dict:
    """The JAX repo's mesh dry run on n_devices ranks: dp over frames (the
    pose + score step, 2 crops of 64x64 a rank), the score histogram summed
    over the data group, the full-frame step (f32 at img_size 64 with the
    seed-0 YOLOv3 BN-folded; the int8 PTQ detector with bf16 towers at
    det_stride 2; det_stride 2 with pose_stride 2), K2 alone, and for n a
    multiple of 4 the tp / sp / pp / ep axes through the config path plus
    one dp 2 x tp n/2 training step. JAX's persistent compile cache is
    XLA's and has no counterpart.

    The ranks are spawned (parallel/distributed.run_ranks): NCCL with a card
    per rank where the machine has n cards, else gloo with the ranks sharing
    the cards (cuda:0 on one card); cpu=True runs gloo on the CPU (JAX's
    virtual host devices). Without a card it raises unless cpu=True. The
    inputs are seeded (dryrun_inputs); each section is held against the
    single-process step on the whole batch on the same device: scores
    exactly equal, f32 floats within F32_RTOL of max(1, |reference|), the
    bf16 step's det_best within BF16_ATOL, the resample exactly; the axes
    within AXIS_TOL. Every rank's scores must equal rank 0's.

    Rank 0 prints JAX's "dryrun_multichip OK: ..." line; returns rank 0's
    record: {n_devices, backend, transport, devices, seconds, ok, sections:
    {name: {ok, its values, seconds (the slowest rank's), k1 and k2 (each
    rank's K1 and K2 launches)}}}.
    Raises AssertionError, with the record, when a section fails."""
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.parallel.distributed import run_ranks

    if n_devices < 2:
        raise ValueError(f"a mesh dry run needs at least 2 ranks, got {n_devices}")
    if cpu:
        backend = "gloo"
    else:
        resolve_device(None)
        backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as root:
        run_ranks(_dryrun_rank, n_devices, backend, f"file://{root}/init", args=(root, cpu),
                  timeout=DRYRUN_TIMEOUT_S)
        record = torch.load(os.path.join(root, "record.pt"), weights_only=False)
    record.update(backend=backend, seconds=time.perf_counter() - t0)
    if not record["ok"]:
        raise AssertionError(
            "dryrun_multichip: failed sections "
            f"{[k for k, v in record['sections'].items() if not v.get('ok')]}: {record}")
    return record
