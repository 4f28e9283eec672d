"""Offline dataset builder: videos -> per-person cropped jpg/mp4 corpora.

Port of the JAX package's tools/data_preprocessing.py (reference
main/data_preprocessing.py:18-132): walk a `videos/` tree, track every
person, keep tracks of at least MIN_SEC seconds, slice them into
fixed-length chunks, crop each chunk to 224x224 on the device, and write
per-person jpg folders (under `images/`) and mp4 clips (under
`processed_videos/`) -- the same output naming scheme. Pass
jpeg_ingest=True for the reference's disk-JPEG pixel statistics.

The work is split in two:
  * person_chunks: in-memory frames and tracks -> per chunk the uint8 BGR
    images of the f32 crops (ops/crop.crop_batch, kernel K1 on a CUDA
    device, in CROP_BATCH-frame batches; truncated to uint8 on the
    device). It needs no cv2;
  * process_video / main: the cv2 side (decode, imwrite, VideoWriter).

The JAX package's documented deviations from the literal tool hold here
too: every source directory is processed (the reference skips the first
four), and one uint8 array (truncated) goes to both the jpgs and the mp4.

Usage:
    python -m poserisk_release_tpu_torch.tools.data_preprocessing --src data/NRF/videos/train [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
from typing import Dict, Iterator, List

import numpy as np
import torch

from poserisk_release_tpu_torch.device import resolve_device

MIN_SEC = 8
BBOX_SCALE = 1.2
CROP_BATCH = 256


def person_chunks(frames_rgb: np.ndarray, fps: float, tracking_results: Dict,
                  crop_size: int = 224, device=None) -> Iterator[Dict[str, np.ndarray]]:
    """Chunk every track of at least MIN_SEC seconds into MIN_SEC * fps
    frames and crop each chunk, CROP_BATCH frames at a time, on `device`
    (CUDA unless the caller names the CPU). Yields per chunk, in the JAX
    tool's order, {"frames": frame ids, "bbox": (N, 4) boxes, "images_bgr":
    (N, S, S, 3) uint8, the f32 RGB [0, 1] crops * 255 truncated}."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch

    device = resolve_device(device)
    num_frames = int(MIN_SEC * fps)
    for person in tracking_results.values():
        if person["frames"].shape[0] < num_frames:
            continue
        for b in range(person["frames"].shape[0] // num_frames):
            sl = slice(num_frames * b, num_frames * (b + 1))
            ids, boxes = person["frames"][sl], person["bbox"][sl].astype(np.float32)
            images = []
            for start in range(0, len(ids), CROP_BATCH):
                batch = slice(start, start + CROP_BATCH)
                crops = crop_batch(torch.as_tensor(frames_rgb[ids[batch]], device=device),
                                   torch.as_tensor(boxes[batch], device=device),
                                   scale=BBOX_SCALE, out_size=crop_size)
                images.append((crops.flip(-1) * 255).to(torch.uint8).cpu().numpy())
            yield {"frames": ids, "bbox": boxes, "images_bgr": np.concatenate(images)}


def process_video(
    file_name: str, img_dir: str, processed_dir: str, tracker,
    crop_size: int = 224, jpeg_ingest: bool = False, device=None,
) -> List[str]:
    """Track + chunk + crop one video. Returns the written mp4 paths."""
    import cv2

    from poserisk_release_tpu_torch.io.video import VideoClip, jpeg_roundtrip

    save_dir = osp.splitext(osp.basename(file_name))[0]

    cap = cv2.VideoCapture(file_name)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        return []
    clip = VideoClip(frames=np.stack(frames), fps=float(fps))
    if jpeg_ingest:
        # Reference pixel statistics: its tracker AND crops read the frames
        # back from a '%09d.jpg' tmp tree (data_preprocessing.py:59-66).
        clip = jpeg_roundtrip(clip)

    written = []
    chunks = person_chunks(clip.frames, clip.fps, tracker(clip.frames), crop_size, device)
    for person_id, chunk in enumerate(chunks):
        images_bgr = chunk["images_bgr"]
        save_img_path = osp.join(img_dir, save_dir, str(person_id))
        save_video_path = osp.join(processed_dir, f"{save_dir}_{person_id}.mp4")
        os.makedirs(save_img_path, exist_ok=True)
        os.makedirs(processed_dir, exist_ok=True)

        writer = cv2.VideoWriter(
            save_video_path, 0x7634706D, clip.fps, (crop_size, crop_size)
        )
        for frame_id in range(images_bgr.shape[0]):
            cv2.imwrite(
                osp.join(save_img_path, "{0:06d}.jpg".format(frame_id)),
                images_bgr[frame_id],
            )
            writer.write(images_bgr[frame_id])
        writer.release()
        written.append(save_video_path)
    return written


def main(src_dir: str, tracker=None, jpeg_ingest: bool = False, device=None) -> List[str]:
    """Process every video under each directory of src_dir; returns the
    written mp4 paths. tracker=None tracks with the Predictor's detector
    policy (pipeline.build_detector: YOLOv3 from DETECTOR.weights, else
    the full-frame stub) on `device`."""
    device = resolve_device(device)
    if tracker is None:
        from poserisk_release_tpu_torch.config import default_config
        from poserisk_release_tpu_torch.pipeline import build_detector
        from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker

        tracker = MultiPersonTracker(build_detector(default_config(), device))

    written: List[str] = []
    for src_name in sorted(glob.glob(osp.join(src_dir, "*"))):
        if not osp.isdir(src_name):
            continue
        img_dir = src_name.replace("videos", "images")
        processed_dir = src_name.replace("videos", "processed_videos")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(processed_dir, exist_ok=True)

        file_names = sorted(
            glob.glob(osp.join(src_name, "*")) + glob.glob(osp.join(src_name, "**", "*"))
        )
        for file_name in file_names:
            if not osp.isfile(file_name):
                continue
            written += process_video(file_name, img_dir, processed_dir, tracker,
                                     jpeg_ingest=jpeg_ingest, device=device)
    return written


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Build per-person crop datasets")
    parser.add_argument("--src", type=str, required=True, help="videos/ source dir")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--jpeg_ingest", action="store_true",
                        help="round-trip frames through JPEG before tracking/"
                             "cropping (the reference's tmp-jpg pixel statistics)")
    args = parser.parse_args()
    main(args.src, jpeg_ingest=args.jpeg_ingest, device="cpu" if args.cpu else None)
