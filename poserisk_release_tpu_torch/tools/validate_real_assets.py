"""The real-asset validation playbook of the port: run it once real assets exist.

    python -m poserisk_release_tpu_torch.tools.validate_real_assets [--video demo.mp4] [--cpu]

The counterpart of the JAX repo's tools/validate_real_assets.py. Given real
assets at the configured paths (or the flags), it runs the checks that
decide the opt-in fast paths and prints the measured drifts with a
recommendation for each. A section whose asset is absent prints SKIP, so
the tool is safe to run anywhere:

  1. SMPL pkl dir   cfg.SPIN.smpl_model_dir -> the loader and LBS on each
                    gender
  2. SPIN ckpt      cfg.SPIN.checkpoint     -> how the checkpoint's keys
                    matched the port's HMR (the port is the reference's
                    torch layout: there is no conversion to compare), then
                    the bf16 and int8 (bias-corrected) drift against the
                    port's f32 on the real weights, loaded by the
                    Predictor's own path (pipeline.load_spin_variables,
                    models/convert) -- the data for --fast / --spin_int8
  3. YOLO weights   cfg.DETECTOR.weights    -> strict f32 against rect +
                    int8 detections at the 0.1 threshold and their box
                    agreement -- the data for --fast_detector
  4. demo video     --video PATH            -> the Predictor strict against
                    all-fast: stats and per-frame score rows
  5. demo video     --video PATH            -> score flips at pose_stride 2
                    and 4, everything else strict, against section 4's
                    strict run -- the data for --pose_stride

Sections 4 and 5 decode the video with opencv. Runs on the card unless
--cpu is given.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import tempfile

import numpy as np
import torch


def section(title: str):
    print(f"\n=== {title} " + "=" * max(0, 58 - len(title)), flush=True)


def skip(msg: str):
    print(f"  SKIP: {msg}", flush=True)


def _angle_drift(label: str, euler: np.ndarray, euler_f32: np.ndarray) -> dict:
    d = np.abs(np.asarray(euler, np.float64) - euler_f32)
    d = np.minimum(d, 360.0 - d)
    p95 = float(np.percentile(d, 95))
    rec = "OK to enable" if p95 < 0.5 else "measure score flips first"
    print(f"  {label}: median {np.median(d):.4f} p95 {p95:.4f} max {d.max():.4f} deg -> {rec}",
          flush=True)
    return {"median": float(np.median(d)), "p95": p95, "max": float(d.max())}


def smpl_section(cfg, device) -> dict | None:
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.ops.lbs import LBS

    section("1. SMPL human-model assets")
    pkls = (sorted(glob.glob(osp.join(cfg.SPIN.smpl_model_dir, "*.pkl")))
            if osp.isdir(cfg.SPIN.smpl_model_dir) else [])
    if not pkls:
        skip(f"no .pkl files under {cfg.SPIN.smpl_model_dir}")
        return None
    family = SMPLFamily(cfg.SPIN.smpl_model_dir, allow_synthetic=False)
    out = {}
    for gender in ("neutral", "male", "female"):
        pose = np.zeros((2, 72), np.float32)
        pose[:, 0] = 3.14
        verts, joints = LBS(family[gender], device=device)(pose)
        finite = bool(torch.isfinite(verts).all())
        print(f"  {gender}: verts {tuple(verts.shape)} joints {tuple(joints.shape)} "
              f"finite={finite}", flush=True)
        out[gender] = finite
    print("  -> real pkl loading OK; debug-mesh exports now reference-comparable", flush=True)
    return out


def spin_section(cfg, device, rng, n_crops: int, crop_size: int) -> dict | None:
    from poserisk_release_tpu_torch.models.convert import load_spin_checkpoint
    from poserisk_release_tpu_torch.models.resnet_int8 import prepare_resnet50
    from poserisk_release_tpu_torch.models.spin import (
        HMR,
        hmr_forward_quant,
        load_mean_params,
        quantize_spin_backbone,
    )
    from poserisk_release_tpu_torch.ops.rotations import rotmat_to_euler_deg
    from poserisk_release_tpu_torch.pipeline import load_spin_variables
    from poserisk_release_tpu_torch.tools.profile_stages import tf32_off

    section("2. SPIN checkpoint: key match + fast-path drift")
    if not osp.isfile(cfg.SPIN.checkpoint):
        skip(f"no checkpoint at {cfg.SPIN.checkpoint}")
        return None
    mean = load_mean_params(cfg.SPIN.smpl_mean_params)
    want = set(HMR(n_iter=cfg.SPIN.ief_iters, mean_params=mean).state_dict())
    raw = {k.replace("module.", ""): v for k, v in load_spin_checkpoint(cfg.SPIN.checkpoint).items()}
    matched = len(want & set(raw))
    print(f"  checkpoint keys: {matched} matched the port's HMR, "
          f"{len(want - set(raw))} missing, {len(set(raw) - want)} unexpected", flush=True)
    if matched == 0:
        raise RuntimeError("the checkpoint matched ZERO of the HMR's keys -- its naming scheme "
                           f"differs (sample: {sorted(raw)[:3]})")
    variables = load_spin_variables(cfg)  # the Predictor's path, its .flax.npz cache included
    crops = torch.as_tensor(rng.rand(n_crops, crop_size, crop_size, 3).astype(np.float32),
                            device=device)

    def hmr(dtype=None):
        model = HMR(n_iter=cfg.SPIN.ief_iters, mean_params=mean)
        model.load_state_dict(variables)
        if dtype is not None:
            model.cast_backbone(dtype)
        return model.eval().to(device)

    with torch.inference_mode(), tf32_off():
        f32 = hmr()
        e_f32 = rotmat_to_euler_deg(f32(crops)[0]).double().cpu().numpy()
        e_bf16 = rotmat_to_euler_deg(hmr(torch.bfloat16)(crops.to(torch.bfloat16))[0])
        quant = prepare_resnet50(quantize_spin_backbone(variables, crops[:4]), device)
        e_q = rotmat_to_euler_deg(hmr_forward_quant(quant, f32, crops, torch.float32)[0])
    return {"keys_matched": matched,
            "bf16": _angle_drift("--fast (bf16)", e_bf16.cpu().numpy(), e_f32),
            "int8": _angle_drift("--spin_int8 (bias-corrected)", e_q.cpu().numpy(), e_f32)}


def yolo_section(cfg, device, rng, args) -> dict | None:
    from poserisk_release_tpu_torch.models.detector import (
        YoloDetector,
        fold_bn_params,
        load_darknet_weights,
    )

    section("3. YOLO darknet weights: fast-detector drift")
    if not osp.isfile(cfg.DETECTOR.weights):
        skip(f"no weights at {cfg.DETECTOR.weights}")
        return None
    folded = fold_bn_params(load_darknet_weights(cfg.DETECTOR.weights))
    H, W = args.probe_hw
    frames = rng.randint(0, 255, (8, H, W, 3)).astype(np.uint8)
    if args.video and osp.isfile(args.video):
        from poserisk_release_tpu_torch.io.video import read_video

        frames = read_video(args.video).frames[:8]
    img_size = args.img_size or cfg.DETECTOR.img_size
    strict = YoloDetector(params=folded, img_size=img_size, max_device_dets=0,
                          device=device)(frames)
    fast = YoloDetector(params=dict(folded), img_size=img_size, rect=True, int8=True,
                        batch_size=8, device=device)
    fast.calibrate(frames)
    fast_out = fast(frames)
    n_s = sum(len(r) for r in strict)
    n_f = sum(len(r) for r in fast_out)
    print(f"  detections at thr 0.1: strict {n_s} vs rect+int8 {n_f} over {len(frames)} frames",
          flush=True)
    matched = 0
    for s, f in zip(strict, fast_out):
        for box in s:
            if len(f) and np.min(np.abs(f[:, :4] - box[:4]).max(axis=1)) < 5.0:
                matched += 1
    if n_s:
        print(f"  box agreement (<5 px): {matched}/{n_s} -> "
              f"{'OK to enable --fast_detector' if matched == n_s else 'inspect disagreements'}",
              flush=True)
    return {"strict": n_s, "fast": n_f, "matched": matched}


def _score_rows(root: str) -> dict:
    """{csv basename: rows} of a debug run's per-frame score logs."""
    return {osp.basename(c): open(c).read().splitlines()
            for c in glob.glob(osp.join(root, "debug", "*score_log.csv"))}


def _flips(rows_a: list, rows_b: list) -> tuple:
    """(differing rows, rows): a row missing from one side counts as a
    difference, so runs that tracked different frame counts show it."""
    n = max(len(rows_a), len(rows_b))
    return sum(1 for i in range(n) if (rows_a[i] if i < len(rows_a) else None)
               != (rows_b[i] if i < len(rows_b) else None)), n


def video_sections(cfg, device, video) -> dict:
    from poserisk_release_tpu_torch.pipeline import Predictor

    out = {}
    section("4. Demo video: strict vs all-fast score sequences")
    if not (video and osp.isfile(video)):
        skip("no --video given (pass the reference demo clip)")
        section("5. Demo video: pose-stride score flips (strict otherwise)")
        skip("needs --video (reuses section 4's strict run as the stride-1 baseline)")
        return out
    info = cfg.DATASET.default_information
    with tempfile.TemporaryDirectory() as td:
        s = Predictor(cfg=cfg, visualize=False, debug=True, device=device)(
            video, info, osp.join(td, "strict"))
        strict_rows = _score_rows(osp.join(td, "strict"))
        f = Predictor(cfg=cfg.replace(DETECTOR={"rect_letterbox": True, "int8": True}),
                      visualize=False, debug=True, fast=True, spin_int8=True, device=device)(
            video, info, osp.join(td, "fast"))
        for kind in ("REBA", "RULA"):
            if kind in s and kind in f:
                print(f"  {kind} stats strict:   {s[kind][0]} (action level {s[kind][1]})")
                print(f"  {kind} stats all-fast: {f[kind][0]} (action level {f[kind][1]})")
        fast_rows = _score_rows(osp.join(td, "fast"))
        for name, rows in sorted(strict_rows.items()):
            if name in fast_rows:
                flips, n = _flips(rows, fast_rows[name])
                out[f"fast/{name}"] = (flips, n)
                print(f"  {name}: {flips}/{n} differing per-frame rows strict vs all-fast",
                      flush=True)

        section("5. Demo video: pose-stride score flips (strict otherwise)")
        for stride in (2, 4):
            root = osp.join(td, f"s{stride}")
            Predictor(cfg=cfg.replace(SPIN={"pose_stride": stride}), visualize=False,
                      debug=True, device=device)(video, info, root)
            rows_by_name = _score_rows(root)
            for name, rows in sorted(strict_rows.items()):
                if name not in rows_by_name:
                    continue
                flips, n = _flips(rows, rows_by_name[name])
                out[f"pose_stride{stride}/{name}"] = (flips, n)
                verdict = ("OK to enable" if flips / max(n, 1) < 0.02
                           else "inspect flips before enabling")
                print(f"  pose_stride {stride} {name}: {flips}/{n} differing per-frame rows "
                      f"vs stride 1 -> {verdict}", flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--video", default=None, help="real demo video (optional)")
    ap.add_argument("--smpl_dir", default=None, help="override SMPL pkl dir")
    ap.add_argument("--ckpt", default=None, help="override SPIN checkpoint path")
    ap.add_argument("--weights", default=None, help="override YOLO weights path")
    ap.add_argument("--img_size", type=int, default=None,
                    help="override the detector canvas (small canvases run fast off the card)")
    ap.add_argument("--probe_hw", type=int, nargs=2, default=(450, 800),
                    help="synthetic probe frame size for the detector section")
    ap.add_argument("--spin_crops", type=int, default=8, help="crops for the SPIN drift")
    ap.add_argument("--crop_size", type=int, default=224,
                    help="SPIN crop size (small crops run fast off the card)")
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> dict:
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.device import resolve_device

    args = parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = default_config()
    if args.smpl_dir:
        cfg = cfg.replace(SPIN={"smpl_model_dir": args.smpl_dir})
    if args.ckpt:
        cfg = cfg.replace(SPIN={"checkpoint": args.ckpt})
    if args.weights:
        cfg = cfg.replace(DETECTOR={"weights": args.weights})
    rng = np.random.RandomState(0)
    out = {"smpl": smpl_section(cfg, device),
           "spin": spin_section(cfg, device, rng, args.spin_crops, args.crop_size),
           "yolo": yolo_section(cfg, device, rng, args),
           "video": video_sections(cfg, device, args.video)}
    print("\ndone.", flush=True)
    return out


if __name__ == "__main__":
    main()
