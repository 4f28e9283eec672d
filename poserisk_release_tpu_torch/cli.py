"""CLI entry point of the port, flag-compatible with the reference's main/run.py.

    python -m poserisk_release_tpu_torch.cli --type REBA,RULA --input video.mp4 \
        --info additional_information.json --output out [--gpu 0] \
        [--visualize] [--debug] [--debug_joints "Neck,L_Hip"] [--debug_frame N] [--cpu] \
        [--fast] [--spin_int8] [--fast_detector] [--calibration frames.npy] \
        [--streaming [--streaming_window N]] \
        [--num_devices N] [--tp N] [--pp N [--pp_microbatches M]] [--ep N] [--sp N]

Flags and defaults mirror the JAX package's cli.py (and the reference's
main/run.py:10-20). `--gpu N` selects CUDA device N; `--cpu` runs on the
CPU.

The mesh flags map onto cfg.PARALLEL as in the JAX CLI and run one process
per rank (parallel/), for the batch Predictor and --streaming alike: the
world is num_devices (0: every visible card, or one on the CPU, divided
among the model axes) times tp * pp * ep * sp ranks.
Under a launcher (torchrun, or RANK and WORLD_SIZE in the environment) each
rank joins the launcher's group; otherwise the CLI spawns the world itself
(torch.multiprocessing). Ranks use NCCL, one card each, or gloo on the CPU
with --cpu. Only rank 0 writes the result files.

    torchrun --nproc_per_node 4 -m poserisk_release_tpu_torch.cli --tp 2 --input v.mp4
    python -m poserisk_release_tpu_torch.cli --cpu --num_devices 2 --pp 2 --input v.mp4
    python -m poserisk_release_tpu_torch.cli --cpu --sp 2 --streaming --input v.mp4
"""

from __future__ import annotations

import argparse
import math
import os
import os.path as osp

from poserisk_release_tpu_torch.config import default_config, load_yaml_config
from poserisk_release_tpu_torch.parallel.distributed import (
    initialize_distributed,
    rank_device,
    run_ranks,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Estimate RULA and REBA score")
    parser.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--type", type=str, default="REBA,RULA", help="Score type")
    parser.add_argument("--input", type=str, default="example/input.mp4",
                        help="input video, or a directory of videos (each is "
                             "scored into <output>/<video-stem>/ by one "
                             "Predictor)")
    parser.add_argument("--info", type=str, default="example/additional_information.json",
                        help="input additional_information.json")
    parser.add_argument("--output", type=str, default="output", help="output directory")
    parser.add_argument("--visualize", type=bool, default=True,
                        help="do result visualization (reference type=bool "
                             "quirk: any non-empty string is True)")
    parser.add_argument("--no_visualize", action="store_true",
                        help="disable annotated-video rendering")
    parser.add_argument("--debug", action="store_true", help="for debuging")
    parser.add_argument("--debug_joints", type=str, default="",
                        help='for debuging, input joint names (i.e. "Neck,L_Hip")')
    parser.add_argument("--debug_frame", type=int, default=-1,
                        help="for debuging, export the SMPL mesh and 3D "
                             "skeleton of this frame (with --debug)")
    parser.add_argument("--cfg", type=str, default=None, help="YAML config override")
    parser.add_argument("--gender", type=str, default="neutral",
                        choices=("neutral", "male", "female"),
                        help="SMPL body model used for joint positions")
    parser.add_argument("--multi_person", action="store_true",
                        help="score every tracked person (one output dir each)")
    parser.add_argument("--person_genders", type=str, default="",
                        help="per-track SMPL genders for --multi_person, "
                             "e.g. '1:male,3:female'")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage wall-clock report after the run")
    parser.add_argument("--fast", action="store_true",
                        help="bfloat16 crops and SPIN backbone")
    parser.add_argument("--detection_stride", type=int, default=1,
                        help="detect only every Nth frame and interpolate "
                             "track boxes across the gaps")
    parser.add_argument("--adaptive_stride", action="store_true",
                        help="motion-adaptive upgrade of --detection_stride")
    parser.add_argument("--pose_stride", type=int, default=1,
                        help="run crop+SPIN only on every Nth tracked frame "
                             "and slerp the skipped frames' joint rotations")
    parser.add_argument("--jpeg_ingest", action="store_true",
                        help="reference-parity ingest through the %%09d.jpg "
                             "disk round trip")
    parser.add_argument("--validate_rotations", action="store_true",
                        help="host-side euler round-trip guard mirroring the "
                             "reference's coord_utils assert")
    parser.add_argument("--decode_workers", type=int, default=1,
                        help="video-decode threads (bit-identical frames)")
    parser.add_argument("--spin_int8", action="store_true",
                        help="int8 PTQ SPIN backbone (calibrated and bias-"
                             "corrected on the first crops)")
    parser.add_argument("--fast_detector", action="store_true",
                        help="rect canvas + int8 PTQ YOLOv3 detector")
    parser.add_argument("--calibration", type=str, default="",
                        help="explicit int8 calibration source (video file, "
                             "image directory or .npy/.npz of uint8 frames) "
                             "for the --fast_detector / --spin_int8 paths")
    parser.add_argument("--calibration_frames", type=int, default=64,
                        help="frames drawn evenly from the calibration source")
    parser.add_argument("--recalibrate_per_video", action="store_true",
                        help="re-derive int8 scales at the start of every "
                             "video (implicit calibration only)")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="ranks on the data axis (0 = every visible card, one on "
                             "the CPU, left over after the model axes)")
    parser.add_argument("--tp", type=int, default=1, metavar="N",
                        help="tensor parallelism: Megatron-shard the SPIN weights over "
                             "an N-wide 'model' axis (PARALLEL.model)")
    parser.add_argument("--pp", type=int, default=1, metavar="N",
                        help="pipeline parallelism: GPipe the SPIN forward over N "
                             "parameter-balanced stages (PARALLEL.stage)")
    parser.add_argument("--pp_microbatches", type=int, default=4,
                        help="microbatches per chunk under --pp (PARALLEL.stage_microbatches)")
    parser.add_argument("--ep", type=int, default=1, metavar="N",
                        help="expert parallelism: one gendered SMPL model per rank of an "
                             "N-wide 'expert' axis (PARALLEL.expert, >= 3)")
    parser.add_argument("--sp", type=int, default=1, metavar="N",
                        help="spatial partitioning: split the crop rows of every SPIN "
                             "activation over an N-wide 'spatial' axis, with halo "
                             "exchanges (PARALLEL.spatial)")
    parser.add_argument("--streaming", action="store_true",
                        help="bounded-memory long-video mode: two-pass "
                             "reference-consistent target selection, peak "
                             "host memory ~2 windows of frames; writes the "
                             "result txts/plots and (with --visualize, the "
                             "default) the annotated REBA/RULA videos, "
                             "rendered incrementally window by window")
    parser.add_argument("--streaming_window", type=int, default=256,
                        help="frames per streaming window")
    return parser


VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def parse_person_genders(spec: str) -> dict:
    """'1:male,3:female' -> {1: 'male', 3: 'female'} (Predictor validates
    the gender names)."""
    out = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        pid, sep, gender = item.partition(":")
        if not sep or not pid.strip().isdigit() or not gender.strip():
            raise ValueError(
                f"--person_genders entry {item!r} is not '<id>:<gender>'")
        out[int(pid)] = gender.strip()
    return out


def input_videos(path: str):
    """[(video_path, output_subdir | None)] for --input: a single file maps
    to the output dir itself; a directory maps each contained video to
    <output>/<stem>/ in sorted order, with colliding stems disambiguated so
    two runs never share a subdir."""
    import os
    from collections import Counter

    if not osp.isdir(path):
        return [(path, None)]
    vids = sorted(name for name in os.listdir(path) if name.lower().endswith(VIDEO_EXTS))
    if not vids:
        raise ValueError(f"no video files ({'/'.join(VIDEO_EXTS)}) in {path}")
    stems = Counter(osp.splitext(name)[0] for name in vids)
    used: set = set()
    pairs = []
    for name in vids:
        stem = osp.splitext(name)[0]
        cand = stem if stems[stem] == 1 else name.replace(".", "_")
        if cand in used:
            cand = name.replace(".", "_")
        base, n = cand, 2
        while cand in used:
            cand = f"{base}_{n}"
            n += 1
        used.add(cand)
        pairs.append((osp.join(path, name), cand))
    return pairs


def profile_report(timings: dict) -> str:
    """--profile stage table. Dotted keys (score.device, score.render) are
    sub-intervals of their parent stage: excluded from the total and
    rendered indented beneath it."""
    total = sum(sec for stage, sec in timings.items() if "." not in stage)

    def row(label: str, sec: float, indent: str = "") -> str:
        share = sec / total * 100 if total else 0.0
        return f"{indent + label:<16} {sec:8.3f}s {share:5.1f}%"

    lines = ["", "----- Stage timings -----"]
    for parent in sorted((k for k in timings if "." not in k), key=lambda k: -timings[k]):
        lines.append(row(parent, timings[parent]))
        for sub in sorted(k for k in timings if k.startswith(parent + ".")):
            lines.append(row(sub, timings[sub], indent="  "))
    lines.append(row("total", total))
    return "\n".join(lines)


def run_streaming(args, cfg, device: str) -> int:
    """--streaming: StreamingScorer with the Predictor's detector policy,
    info fallback and int8 calibration lifecycle, writing the
    reference-format result files (one person_<id>/ directory per
    surviving track under --multi_person)."""
    from poserisk_release_tpu_torch.outputs.stats import print_result_summary
    from poserisk_release_tpu_torch.pipeline import (
        apply_explicit_calibration,
        build_detector,
        load_add_info,
    )
    from poserisk_release_tpu_torch.streaming import StreamingScorer

    for flag in ("profile", "debug"):
        if getattr(args, flag):
            print(f"[streaming] --{flag} is ignored in streaming mode "
                  "(use the batch path for stage timings / debug dumps)")
    scorer = StreamingScorer(
        cfg=cfg,
        detector=build_detector(cfg, device),
        window=args.streaming_window,
        fast=args.fast,
        spin_int8=args.spin_int8,
        gender=args.gender,
        validate_rotations=args.validate_rotations,
        device=device,
    )
    # An explicit --calibration source derives the int8 scales before the
    # first window could pin them, as in the batch Predictor.
    apply_explicit_calibration(cfg, scorer.detector, scorer.estimator)
    add_info = load_add_info(cfg, args.info)
    for video, subdir in input_videos(args.input):
        out = osp.join(args.output, subdir) if subdir else args.output
        if args.multi_person:
            per_person = scorer.score_all(
                video, add_info, video_output=out if args.visualize else None,
                video_types=args.type)
            if not per_person:
                raise ValueError("no person tracks found in the clip")
            for pid, res in per_person.items():
                person_out = osp.join(out, f"person_{pid}")
                summary = scorer.write_outputs(res, person_out, score_type=args.type)
                print(f"\n\n===> DONE! (streaming, person {pid})")
                print("Result files saved in ", person_out)
                print_result_summary(summary)
            continue
        result = scorer(video, add_info, video_output=out if args.visualize else None,
                        video_types=args.type)
        summary = scorer.write_outputs(result, out, score_type=args.type)
        print("\n\n===> DONE! (streaming)")
        print("Result files saved in ", out)
        print_result_summary(summary)
    return 0


def config_from_args(args):
    """The run's Config: --cfg (or the defaults) with the flags applied."""
    cfg = load_yaml_config(args.cfg) if args.cfg else default_config()
    if args.fast_detector:
        cfg = cfg.replace(DETECTOR={"rect_letterbox": True, "int8": True})
    if args.jpeg_ingest:
        cfg = cfg.replace(DATASET={"jpeg_ingest": True})
    if args.detection_stride != 1 or args.adaptive_stride:
        cfg = cfg.replace(DETECTOR={
            "detection_stride": args.detection_stride,
            "adaptive_stride": args.adaptive_stride,
        })
    if args.pose_stride != 1:
        cfg = cfg.replace(SPIN={"pose_stride": args.pose_stride})
    if args.decode_workers != 1:
        cfg = cfg.replace(DATASET={"decode_workers": args.decode_workers})
    if args.calibration or args.recalibrate_per_video:
        cfg = cfg.replace(DETECTOR={
            "calibration": args.calibration,
            "calibration_frames": args.calibration_frames,
            "recalibrate_per_video": args.recalibrate_per_video,
        })
    par_axes = {k: v for k, v in (("model", args.tp), ("spatial", args.sp),
                                  ("stage", args.pp), ("expert", args.ep)) if v != 1}
    if args.pp != 1:
        par_axes["stage_microbatches"] = args.pp_microbatches
    if par_axes or args.num_devices:
        cfg = cfg.replace(PARALLEL={**par_axes, "num_devices": args.num_devices})
    return cfg


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _world(args, cfg) -> tuple:
    """(data-axis size, world size) of the run. Under a launcher the world
    is the launcher's; otherwise num_devices (0: every visible card, or
    one on the CPU, over the model axes) times the model axes."""
    from poserisk_release_tpu_torch.parallel.spmd import model_axes_from_config

    n_model = math.prod(model_axes_from_config(cfg.PARALLEL).values())
    if _launched():
        world = int(os.environ["WORLD_SIZE"])
        return (args.num_devices or max(1, world // n_model)), world
    if args.num_devices:
        return args.num_devices, args.num_devices * n_model
    import torch

    cards = 0 if args.cpu else torch.cuda.device_count()
    dp = max(1, cards // n_model)
    return dp, dp * n_model


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.no_visualize:
        args.visualize = False

    cfg = config_from_args(args)
    dp, world = _world(args, cfg)
    if world > 1:
        cfg = cfg.replace(PARALLEL={"num_devices": dp})
    backend = "gloo" if args.cpu else "nccl"
    if _launched():
        import torch.distributed as dist

        initialize_distributed("env://", backend=backend)
        try:
            return run(args, cfg, rank_device(cpu=args.cpu))
        finally:
            dist.destroy_process_group()
    if world > 1:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            run_ranks(_rank_main, world, backend, f"file://{osp.join(tmp, 'init')}",
                      args=(args, cfg))
        return 0
    return run(args, cfg, "cpu" if args.cpu else f"cuda:{args.gpu}")


def _rank_main(rank: int, args, cfg) -> None:
    run(args, cfg, rank_device(cpu=args.cpu))


def run(args, cfg, device) -> int:
    """One process's run (the whole run, or one rank's) on its device."""
    from poserisk_release_tpu_torch.pipeline import Predictor

    print("Work on device: ", device)
    if args.streaming:
        return run_streaming(args, cfg, device)
    predictor = Predictor(
        cfg=cfg,
        score_type=args.type,
        debug=args.debug,
        debug_joints=args.debug_joints,
        debug_frame=args.debug_frame,
        visualize=args.visualize,
        gender=args.gender,
        multi_person=args.multi_person,
        person_genders=parse_person_genders(args.person_genders),
        fast=args.fast,
        spin_int8=args.spin_int8,
        validate_rotations=args.validate_rotations,
        device=device,
    )
    for video, subdir in input_videos(args.input):
        out = osp.join(args.output, subdir) if subdir else args.output
        if subdir:
            print(f"\n===> {video} -> {out}")
        predictor(video, args.info, out)
        if args.profile:
            print(profile_report(predictor.timings))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
