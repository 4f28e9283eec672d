"""Batched bbox crop: the plain PyTorch version of kernel K1 and its dispatch.

The reference crops one frame at a time on DataLoader workers with
cv2.warpAffine (reference lib/utils/_img_utils.py:53-101, 219-252): bbox
[cx, cy, w, h] scaled by cfg.DATASET.bbox_scale, warped to 224x224 with
bilinear sampling and zero border, then ToTensor (range [0,1], NO ImageNet
mean/std). For rot=0 that warp is a separable two-tap bilinear resample:

    src = c + (dst - out/2) * (size * scale / out)      (no half-pixel shift)

taps outside [0, size) carry zero weight. The JAX package computes it as two
matmuls per image (a TPU has no hardware gather); here it is a direct 2x2
gather, which is what the CUDA kernel (ops/resample.crop_batch_cuda) does
too. crop_batch_plain repeats the kernel's arithmetic operation by
operation, each rounded once in f32, so the two agree bit for bit. The JAX
version's sample positions differ by up to 2 ulp, because XLA's f32
division on the CPU is not correctly rounded; that moves a sample by at
most 1.22e-4 px at |x| < 1024. On smooth images the two agree within 1e-5,
on pixel noise within 1.25e-4 of full scale.

Output is NHWC in [0, 1], the layout the port's HMR takes.
"""

from __future__ import annotations

import torch


def crop_coords(bboxes: torch.Tensor, scale: float, out_size: int):
    """Per-frame sample positions (ys (B, out), xs (B, out)) from f32 bboxes
    (B, 4) [cx, cy, w, h] -- _crop_coords of the TPU kernel."""
    offsets = (torch.arange(out_size, dtype=torch.float32, device=bboxes.device)
               - out_size * 0.5)[None, :]
    extent = bboxes[:, 2:4] * scale
    # A tensor divisor keeps this a true f32 division on every device: a
    # Python-scalar divisor turns into a reciprocal multiply on CUDA.
    step = extent / torch.full_like(extent, out_size)
    xs = offsets * step[:, 0:1] + bboxes[:, 0:1]
    ys = offsets * step[:, 1:2] + bboxes[:, 1:2]
    return ys, xs


def axis_taps(coords: torch.Tensor, size: int):
    """Two bilinear taps per coordinate: (i0, i1) clamped into the frame for
    the read, and weights (w0, w1) that are 0 for taps outside [0, size)."""
    x0 = torch.floor(coords)
    frac = coords - x0
    i0 = x0.to(torch.int64)
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 <= size - 1), 1.0 - frac, torch.zeros_like(frac))
    w1 = torch.where((i1 >= 0) & (i1 <= size - 1), frac, torch.zeros_like(frac))
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w0, w1


def crop_batch_plain(
    images: torch.Tensor,  # (B, H, W, 3) uint8
    bboxes: torch.Tensor,  # (B, 4) [cx, cy, w, h]
    scale: float = 1.2,
    out_size: int = 224,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of K1 on any device: (B, out, out, 3) in [0, 1]."""
    B, H, W = images.shape[0], images.shape[1], images.shape[2]
    bboxes = bboxes.to(device=images.device, dtype=torch.float32)
    ys, xs = crop_coords(bboxes, scale, out_size)
    y0, y1, wy0, wy1 = axis_taps(ys, H)
    x0, x1, wx0, wx1 = axis_taps(xs, W)
    b = torch.arange(B, device=images.device)[:, None, None]

    def px(yi, xi):
        return images[b, yi[:, :, None], xi[:, None, :]].to(torch.float32)

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    r0 = wx0 * px(y0, x0) + wx1 * px(y0, x1)
    r1 = wx0 * px(y1, x0) + wx1 * px(y1, x1)
    out = (wy0 * r0 + wy1 * r1) * (1.0 / 255.0)
    return out.to(out_dtype)


def crop_batch(
    images: torch.Tensor,
    bboxes: torch.Tensor,
    scale: float = 1.2,
    out_size: int = 224,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """THE crop of the pose path. Frames on a CUDA device go through the
    hand-written kernel (ops/resample.crop_batch_cuda), frames on the CPU
    through the plain version; any other device raises. There is no fallback
    from the kernel to the plain version."""
    if images.device.type == "cuda":
        from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda

        return crop_batch_cuda(
            images, bboxes.to(device=images.device, dtype=torch.float32).contiguous(),
            scale=scale, out_size=out_size, out_dtype=out_dtype)
    if images.device.type == "cpu":
        return crop_batch_plain(images, bboxes, scale, out_size, out_dtype)
    raise ValueError(f"crop_batch has no path for device {images.device}")
