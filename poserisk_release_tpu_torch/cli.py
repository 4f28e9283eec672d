"""CLI entry point of the port, flag-compatible with the reference's main/run.py.

    python -m poserisk_release_tpu_torch.cli --type REBA,RULA --input video.mp4 \
        --info additional_information.json --output out [--gpu 0] \
        [--visualize] [--debug] [--debug_joints "Neck,L_Hip"] [--cpu]

Flags and defaults mirror the JAX package's cli.py (and the reference's
main/run.py:10-20). `--gpu N` selects CUDA device N; `--cpu` runs on the
CPU. Flags of later slices of the port are parsed and rejected with an
error naming their ROADMAP item, so no run silently ignores them.
"""

from __future__ import annotations

import argparse
import os.path as osp

from poserisk_release_tpu_torch.config import default_config, load_yaml_config

# flag -> (default, ROADMAP item): accepted by the parser for compatibility
# with the JAX package's CLI, refused when set.
LATER_SLICE_FLAGS = {
    "spin_int8": (False, "Queue 1 item 14 (int8 PTQ)"),
    "fast_detector": (False, "Queue 1 items 10 and 14 (YOLOv3 detector, int8)"),
    "calibration": ("", "Queue 1 item 14 (int8 PTQ)"),
    "recalibrate_per_video": (False, "Queue 1 item 14 (int8 PTQ)"),
    "num_devices": (0, "Queue 1 item 15 (torch.distributed mesh)"),
    "tp": (1, "Queue 1 item 15 (torch.distributed mesh)"),
    "sp": (1, "Queue 1 item 15 (torch.distributed mesh)"),
    "pp": (1, "Queue 1 item 15 (torch.distributed mesh)"),
    "ep": (1, "Queue 1 item 15 (torch.distributed mesh)"),
    "streaming": (False, "Queue 1 item 12 (streaming scorer)"),
    "debug_frame": (-1, "Queue 2 K4 (full vertex LBS, debug mesh export)"),
}


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
    # Later slices of the port: parsed so the JAX package's command lines
    # give a clear error instead of an unknown-flag failure.
    parser.add_argument("--debug_frame", type=int, default=-1, help=argparse.SUPPRESS)
    parser.add_argument("--spin_int8", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--fast_detector", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--calibration", type=str, default="", help=argparse.SUPPRESS)
    parser.add_argument("--calibration_frames", type=int, default=64, help=argparse.SUPPRESS)
    parser.add_argument("--recalibrate_per_video", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--num_devices", type=int, default=0, help=argparse.SUPPRESS)
    for flag in ("tp", "sp", "pp", "ep"):
        parser.add_argument(f"--{flag}", type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument("--pp_microbatches", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--streaming", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--streaming_window", type=int, default=256, help=argparse.SUPPRESS)
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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (default, item) in LATER_SLICE_FLAGS.items():
        if getattr(args, flag) != default:
            parser.error(f"--{flag} is not in the PyTorch port yet (ROADMAP {item})")
    if args.no_visualize:
        args.visualize = False

    from poserisk_release_tpu_torch.pipeline import Predictor

    cfg = load_yaml_config(args.cfg) if args.cfg else default_config()
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

    device = "cpu" if args.cpu else f"cuda:{args.gpu}"
    print("Work on device: ", device)
    predictor = Predictor(
        cfg=cfg,
        score_type=args.type,
        debug=args.debug,
        debug_joints=args.debug_joints,
        visualize=args.visualize,
        gender=args.gender,
        multi_person=args.multi_person,
        person_genders=parse_person_genders(args.person_genders),
        fast=args.fast,
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
