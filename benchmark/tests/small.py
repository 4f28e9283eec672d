"""Tiny sizes for rehearsing the cells on the CPU (the command line always
runs the cell's own sizes on the card)."""

VIDEO = {"mix": {"frame_hw": [90, 160], "pool_frames": 16, "clip_frames": 16, "window": 8,
                 "chunk": 8, "warmup_clips": 1, "stretch_clips": 1, "check_det_frames": 16,
                 "check_pose_frames": 16},
         "img_size": 128}
SERVE = {"mix": {"frame_hw": [90, 160], "cameras": 2, "fps": 10, "pool_frames": 4,
                 "buckets": [1, 4], "stretch_s": 0.5, "check_requests": 8,
                 "warmup_s": 0.5}}


def overrides(cell, **extra):
    base = VIDEO if cell.mix["runner"] == "video" else SERVE
    return dict(base, **extra)
