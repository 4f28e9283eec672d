"""Host-side image convenience utilities (reference _img_utils.py leaf surface).

Port of the JAX package's io/images.py. Array layout is HWC / NHWC float
[0, 1] (the layout the port's HMR takes); the reference returns torch CHW
tensors from its `convert_cvimg_to_tensor` with the same values.

The bbox crops (get_single_image_crop, get_image_crops) go through the
port's ops/crop.crop_batch: kernel K1 on a CUDA device, its plain version on
the CPU. They run on the card unless the caller passes device="cpu"
(device.resolve_device), and return host arrays.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from poserisk_release_tpu_torch.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_image(filename: str) -> np.ndarray:
    """cv2.imread + cv2.cvtColor(..., RGB2BGR), parity with the reference's
    get_image (reference lib/utils/_img_utils.py:25-27). The named
    conversion is a channel swap, so this returns RGB pixels from the BGR
    file read -- the (intentional-looking) quirk is preserved."""
    import cv2

    image = cv2.imread(filename)
    if image is None:
        raise FileNotFoundError(filename)
    return cv2.cvtColor(image, cv2.COLOR_RGB2BGR)


def convert_cvimg_to_tensor(image: np.ndarray) -> np.ndarray:
    """ToTensor-only conversion ([0,1] floats, NO ImageNet mean/std), parity
    with the reference (lib/utils/_img_utils.py:259-266). Returns HWC
    float32 (the reference returns the same values as CHW torch)."""
    return np.asarray(image, np.float32) / 255.0


def read_image(filename: str, size: int = 224) -> np.ndarray:
    """imread -> RGB -> resize(size, size) -> [0,1] floats, parity with the
    reference's read_image (lib/utils/_img_utils.py:253-257)."""
    import cv2

    image = cv2.imread(filename)
    if image is None:
        raise FileNotFoundError(filename)
    image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    return convert_cvimg_to_tensor(cv2.resize(image, (size, size)))


def _as_rgb_array(image) -> np.ndarray:
    import os.path as osp

    if isinstance(image, str):
        import cv2

        if not osp.isfile(image):
            raise FileNotFoundError(image)
        return cv2.cvtColor(cv2.imread(image), cv2.COLOR_BGR2RGB)
    return np.asarray(image)


def _crop(frames: np.ndarray, boxes: np.ndarray, scale: float, out_size: int,
          device) -> np.ndarray:
    """K1 (or its plain version on the CPU) over uint8 frames and their
    [cx, cy, w, h] boxes; (N, out, out, 3) f32 [0, 1] on the host."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch

    device = resolve_device(device)
    crops = crop_batch(torch.as_tensor(np.ascontiguousarray(frames), device=device),
                       torch.as_tensor(boxes, dtype=torch.float32, device=device),
                       scale=float(scale), out_size=out_size)
    return crops.cpu().numpy()


def get_single_image_crop(image, bbox: Sequence[float], scale: float = 1.3,
                          crop_size: int = 224, device=None) -> np.ndarray:
    """Single [cx, cy, w, h] crop -> (crop_size, crop_size, 3) [0,1] floats,
    parity with the reference (lib/utils/_img_utils.py:183-217; its
    occluder branch crashes upstream and is not reproduced)."""
    img = _as_rgb_array(image)
    return _crop(img[None], np.asarray(bbox, np.float32)[None, :4], scale, crop_size,
                 device)[0]


def get_single_image_crop_demo(image, bbox: Sequence[float], kp_2d=None,
                               scale: float = 1.2, crop_size: int = 224, device=None):
    """(crop [0,1], RAW crop uint8 0..255, transformed kp_2d) -- the
    demo-path wrapper (lib/utils/_img_utils.py:219-252): keypoints, if
    given, are mapped through the same warp. The reference copies the warped
    image BEFORE convert_cvimg_to_tensor, so its second return value is
    un-normalised 0..255 pixels (what visualisers re-encode); only the first
    is the [0,1] network tensor."""
    from poserisk_release_tpu_torch.io.keypoints import affine_transform_points

    crop = get_single_image_crop(image, bbox, scale=scale, crop_size=crop_size, device=device)
    raw = np.clip(np.rint(crop * 255.0), 0, 255).astype(np.uint8)
    out_kp = None
    if kp_2d is not None:
        kp = np.asarray(kp_2d, np.float64).copy()
        kp[:, :2] = affine_transform_points(
            kp[:, :2], bbox[0], bbox[1], bbox[2], bbox[3],
            crop_size, crop_size, scale,
        )
        out_kp = kp
    return crop, raw, out_kp


def get_image_crops(image_file: str, bboxes, device=None) -> np.ndarray:
    """Batch crops from [?1, ?2, ?3, ?4] boxes -> (N, 224, 224, 3) [0,1],
    parity with the reference's get_image_crops (lib/utils/_img_utils.py:
    155-178) INCLUDING its axis quirk: the box is indexed as if rows come
    first (c_y from bb[0]+bb[2], c_x from bb[1]+bb[3]), the side is squared
    via np.where(w/h > 1, w, h), and scale is fixed at 1.3."""
    img = _as_rgb_array(image_file)
    centers: List[np.ndarray] = []
    for bb in np.asarray(bboxes, np.float64):
        c_y, c_x = (bb[0] + bb[2]) // 2, (bb[1] + bb[3]) // 2
        h, w = bb[2] - bb[0], bb[3] - bb[1]
        w = h = np.where(w / h > 1, w, h)
        centers.append(np.array([c_x, c_y, w, h], np.float32))
    if not centers:
        return np.zeros((0, 224, 224, 3), np.float32)
    # Chunk the box axis: the crop takes one frame per box, and one
    # broadcast of a large still to N copies can fill device memory (50
    # boxes x a 4K frame is GBs); 8 copies at a time bound it.
    boxes = np.stack(centers)
    out = []
    for start in range(0, len(boxes), 8):
        chunk = boxes[start : start + 8]
        out.append(_crop(np.broadcast_to(img, (len(chunk),) + img.shape), chunk, 1.3, 224,
                         device))
    return np.concatenate(out, axis=0)


def imagenet_denormalize(image_chw: np.ndarray) -> np.ndarray:
    """ImageNet-normalized CHW float -> HWC uint8, parity with the
    reference's torch2numpy (lib/utils/_img_utils.py:268-279) INCLUDING its
    blue-channel typo: the inverse transform divides by 0.255 where the
    ImageNet std is 0.225, so blue comes back ~13% dim. Quirk kept -- this
    function exists to reproduce the reference's visualisations."""
    image = np.asarray(image_chw, np.float32)
    inv_std = np.array([0.229, 0.224, 0.255], np.float32)  # [sic] 0.255
    image = image * inv_std[:, None, None] + IMAGENET_MEAN[:, None, None]
    image = np.clip(image, 0.0, 1.0) * 255.0
    return np.transpose(image, (1, 2, 0)).astype(np.uint8)


def video_denormalize(video: np.ndarray) -> np.ndarray:
    """Parity with torch_vid2numpy (lib/utils/_img_utils.py:281-293)
    including its algebra: it applies (v - m') / s' with m' = -mean/std and
    s' = 1/std (i.e. v * std + mean element-wise), then clips to [0,1] and
    scales to uint8. video: (N, T, C, H, W) floats."""
    video = np.asarray(video, np.float64)
    # (v - (-mean/std)) / (1/std) == v * std + mean, channel axis = -3; the
    # blue channel's inverse scale uses 0.255 (not 0.225) -- the reference's
    # typo, kept: it makes this the exact same transform.
    inv_mean = np.array([-0.485 / 0.229, -0.456 / 0.224, -0.406 / 0.255])
    inv_std = np.array([1 / 0.229, 1 / 0.224, 1 / 0.255])
    shaped = (None, None, Ellipsis, None, None)  # -> (1, 1, 3, 1, 1)
    video = (video - inv_mean[shaped]) / inv_std[shaped]
    return (video.clip(0.0, 1.0) * 255).astype(np.uint8)
