"""The resamples of raw frames: the bbox crop (kernel K1's plain version and
its dispatch), the training augmentation crop (rotation, flip, colour; plain
PyTorch, as the JAX package's is plain XLA), the windowed crop (kernel K3's)
and the detector letterbox (kernel K2's letterbox half).

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

Output is NHWC in [0, 1], the layout the port's HMR takes. The letterbox
half of this module is described where it starts, below crop_batch.
"""

from __future__ import annotations

import numpy as np
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
    window: int = 0,
) -> torch.Tensor:
    """The plain version of K1 on any device: (B, out, out, 3) in [0, 1].
    window > 0 is the plain version of K3 (crop_batch_windowed_plain)."""
    B, H, W = images.shape[0], images.shape[1], images.shape[2]
    bboxes = bboxes.to(device=images.device, dtype=torch.float32)
    ys, xs = crop_coords(bboxes, scale, out_size)
    y0, y1, wy0, wy1 = axis_taps(ys, H)
    x0, x1, wx0, wx1 = axis_taps(xs, W)
    if window:
        lo = window_blocks(bboxes, scale, window, W)[:, None].to(torch.int64) * WINDOW_CHUNK
        zero = torch.zeros_like(wx0)
        wx0 = torch.where((x0 >= lo) & (x0 < lo + window), wx0, zero)
        wx1 = torch.where((x1 >= lo) & (x1 < lo + window), wx1, zero)
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


def sample_augmentation(rng: np.random.RandomState, aug_cfg=None, scale_factor: float = 0.3,
                        color_factor: float = 0.2):
    """Training-crop augmentation parameters, the reference's do_augmentation
    (lib/utils/_img_utils.py:30-38): scale ~ U(1.2, 1.2 + scale_factor),
    color_scale ~ U(1 - cf, 1 + cf) per channel. The reference disables its
    rotation and flip (rot = 0, do_flip = False); config.AugConfig turns
    them back on: rot ~ clip(N(0, 1), -2, 2) * rotate_factor, and flip ~
    Bernoulli(0.5) when aug_cfg.flip. The draws come from `rng` in the JAX
    package's order. Returns (scale, rot_deg, do_flip, color_scale (3,))."""
    scale = rng.uniform(1.2, 1.2 + scale_factor)
    rot = 0.0
    do_flip = False
    if aug_cfg is not None and aug_cfg.rotate_factor:
        rot = float(np.clip(rng.randn(), -2.0, 2.0) * aug_cfg.rotate_factor)
    if aug_cfg is not None and aug_cfg.flip:
        do_flip = bool(rng.rand() <= 0.5)
    color_scale = np.array(
        [rng.uniform(1.0 - color_factor, 1.0 + color_factor) for _ in range(3)], np.float32)
    return scale, rot, do_flip, color_scale


def crop_batch_affine(
    images: torch.Tensor,  # (N, H, W, C) uint8 or float
    bboxes,                # (N, 4) [cx, cy, w, h]
    scales,                # (N,)
    rots_deg,              # (N,)
    flips,                 # (N,) bool
    color_scales,          # (N, C)
    out_size: int = 224,
) -> torch.Tensor:
    """Augmentation crop with rotation, horizontal flip and a per-channel
    colour scale: (N, out, out, C) f32 in [0, 1], on the images' device.
    The reference's warp (gen_trans_from_patch_cv + generate_patch_image_cv,
    lib/utils/_img_utils.py:53-101) inverts to

        src = c + R(rot) @ ((dst - out/2) * bbox * scale / out),

    with the flip applied as an image mirror and c_x -> W - 1 - c_x before
    the warp. Each of the four bilinear taps outside the frame weighs zero
    (F.grid_sample's edge rule differs), then the colour scale, then a clip
    to [0, 1]: the JAX package's gather, rounded as XLA compiles it. The
    rot = 0 inference crop is crop_batch."""
    # XLA divides by a constant as a multiply by its f32 reciprocal, and
    # fuses each first multiply-add of the sample positions into one FMA (a
    # single rounding); the port computes both the same way.
    device, f64 = images.device, torch.float64
    imgs = images.to(torch.float32)
    if images.dtype == torch.uint8:
        imgs = imgs * (1.0 / 255.0)
    N, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=device)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=device)
    rots_deg = torch.as_tensor(rots_deg, dtype=torch.float32, device=device)
    flips = torch.as_tensor(flips, dtype=torch.bool, device=device)
    color_scales = torch.as_tensor(color_scales, dtype=torch.float32, device=device)

    cx = torch.where(flips, W - bboxes[:, 0] - 1.0, bboxes[:, 0])
    cy = bboxes[:, 1]
    step_x = bboxes[:, 2] * scales * (1.0 / out_size)
    step_y = bboxes[:, 3] * scales * (1.0 / out_size)
    offs = torch.arange(out_size, dtype=torch.float32, device=device) - out_size * 0.5
    dx = offs[None, None, :] * step_x[:, None, None]  # (N, 1, out)
    dy = offs[None, :, None] * step_y[:, None, None]  # (N, out, 1)
    # cos and sin in float64, rounded once: the same f32 values on every
    # device (CUDA's f32 cosf and the CPU's differ by an ulp in ~5% of
    # angles), and closer to XLA's than the CPU's f32 functions.
    rot = (rots_deg * (np.pi / 180.0)).to(f64)
    cs = torch.cos(rot).to(torch.float32)[:, None, None]
    sn = torch.sin(rot).to(torch.float32)[:, None, None]
    # The FMA: float64 holds dx * cs exactly, so the sum rounded once to f32
    # is the FMA's value (but for double-rounding ties).
    src_x = (cx[:, None, None].to(f64) + dx.to(f64) * cs.to(f64)).to(torch.float32) - dy * sn
    src_y = (cy[:, None, None].to(f64) + dx.to(f64) * sn.to(f64)).to(torch.float32) + dy * cs
    # Undo the mirror: flipped-image pixel s is original pixel W - 1 - s.
    src_x = torch.where(flips[:, None, None], W - 1.0 - src_x, src_x)

    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = src_x - x0, src_y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    b = torch.arange(N, device=device)[:, None, None]

    def tap(yi, xi):
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(torch.float32)
        return imgs[b, yi.clamp(0, H - 1), xi.clamp(0, W - 1)] * valid[..., None]

    out = (tap(y0i, x0i) * ((1 - fy) * (1 - fx))[..., None]
           + tap(y0i, x0i + 1) * ((1 - fy) * fx)[..., None]
           + tap(y0i + 1, x0i) * (fy * (1 - fx))[..., None]
           + tap(y0i + 1, x0i + 1) * (fy * fx)[..., None])
    return torch.clamp(out * color_scales[:, None, None, :], 0.0, 1.0)


def crop_center_offset_reference_parity(out_size: int) -> float:
    """The reference maps dst pixel x to the source offset (x - out/2) *
    step: cv2.getAffineTransform on its three (centre, centre + down, centre
    + right) point pairs gives src = c + (x - out/2) * (size * scale) / out
    with NO half-pixel shift. Resample parity with the reference hinges on
    it."""
    return out_size * 0.5


# ---------------------------------------------------------------------------
# The windowed crop (kernel K3's plain version and its dispatch): K1's crop
# reading only `window` columns from xblk * 128, xblk = clip(floor((xs_min -
# 1) / 128), 0, n_blk - n_win) with xs_min the box's left edge, n_blk =
# ceil(W / 128) and n_win = window / 128, as crop_batch_pallas_windowed
# (poserisk_release_tpu/ops/resample_pallas.py:336) has it. A column tap
# outside the window is dropped; crop_window_fits is the host-side guard
# under which none is.
# ---------------------------------------------------------------------------
WINDOW_CHUNK = 128


def crop_window_fits(bboxes, scale: float = 1.2, window: int = 384,
                     chunk_w: int = WINDOW_CHUNK) -> bool:
    """True when every box's scaled width, plus the two-tap overhang and a
    FULL chunk of alignment slack (the window starts at a chunk boundary
    below a real-valued left edge, up to just under chunk_w before it), fits
    in the window: then the windowed crop drops no tap."""
    bboxes = np.asarray(bboxes)
    if bboxes.size == 0:
        return True
    return bool(np.max(bboxes[:, 2]) * scale + 2.0 + chunk_w <= window)


def window_blocks(bboxes: torch.Tensor, scale: float, window: int, W: int) -> torch.Tensor:
    """(B,) int32 first 128-column chunk of each frame's read window."""
    n_total, n_win = -(-W // WINDOW_CHUNK), window // WINDOW_CHUNK
    xs_min = bboxes[:, 0] - bboxes[:, 2] * (scale * 0.5)
    blk = torch.floor((xs_min - 1.0) / WINDOW_CHUNK).to(torch.int32)
    return torch.clamp(blk, 0, n_total - n_win)


def _check_window(window: int) -> None:
    if window <= 0 or window % WINDOW_CHUNK:
        raise ValueError(f"window must be a positive multiple of {WINDOW_CHUNK}, got {window}")


def crop_batch_windowed_plain(images, bboxes, scale=1.2, out_size=224, window=384,
                              out_dtype=torch.bfloat16):
    """The plain version of K3 on any device (a whole-width window is K1's)."""
    _check_window(window)
    if window // WINDOW_CHUNK >= -(-images.shape[2] // WINDOW_CHUNK):
        return crop_batch_plain(images, bboxes, scale, out_size, out_dtype)
    return crop_batch_plain(images, bboxes, scale, out_size, out_dtype, window=window)


def crop_batch_windowed(images: torch.Tensor, bboxes: torch.Tensor, scale: float = 1.2,
                        out_size: int = 224, window: int = 384,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The windowed crop: K3 on a CUDA device (K1 when the window covers
    the whole width, as the JAX package routes it), its plain version on the
    CPU; any other device raises. Exact (equal to crop_batch) only where
    crop_window_fits holds; the caller checks that on the host."""
    _check_window(window)
    if window // WINDOW_CHUNK >= -(-images.shape[2] // WINDOW_CHUNK):
        return crop_batch(images, bboxes, scale, out_size, out_dtype)
    if images.device.type == "cuda":
        from poserisk_release_tpu_torch.ops.resample import crop_batch_windowed_cuda

        return crop_batch_windowed_cuda(
            images, bboxes.to(device=images.device, dtype=torch.float32).contiguous(),
            scale=scale, out_size=out_size, window=window, out_dtype=out_dtype)
    if images.device.type == "cpu":
        return crop_batch_windowed_plain(images, bboxes, scale, out_size, window, out_dtype)
    raise ValueError(f"crop_batch_windowed has no path for device {images.device}")


# ---------------------------------------------------------------------------
# Detector letterbox (the plain version of kernel K2's letterbox half).
#
# The upstream detector letterboxes with cv2.resize (INTER_LINEAR, half-pixel
# centres, edge clamp) onto a gray (128) canvas. Along one axis, output index
# o inside the content band [pad, pad + new) samples
#     src = clip((o - pad + 0.5) * size / new - 0.5, 0, size - 1)
# with two taps (i0 = floor(src), i1 = min(i0 + 1, size - 1)); outside the
# band both weights are 0. The geometry is static per frame size, so the
# taps are host tables (float64 positions, f32 weights: the JAX package's
# _letterbox_axis_matrix row by row). The gray border is
# 128/255 * (1 - coverage), coverage = (wy0 + wy1) * (wx0 + wx1) in f32 from
# the same weights, which is exactly 0 outside the band and within an f32
# rounding of 1 inside it.
# ---------------------------------------------------------------------------
GRAY = 128.0 / 255.0


def letterbox_geometry(H: int, W: int, img_size: int):
    """(new_w, new_h, pad_x, pad_y) of the square letterbox: integer-rounded
    content size and integer pads, as the host cv2 letterbox has them, so
    the detector's box unmap is exact."""
    ratio = img_size / max(H, W)
    new_w, new_h = int(round(W * ratio)), int(round(H * ratio))
    return new_w, new_h, (img_size - new_w) // 2, (img_size - new_h) // 2


def rect_canvas_geometry(H: int, W: int, img_size: int, multiple: int = 32):
    """Rectangular detector canvas: the square letterbox's content scale,
    padded on each axis only up to a multiple of the detector's total stride.
    The leading pad is the square pad modulo the stride, so content keeps
    its place on the stride-8/16/32 grids. 800x450 frames get a 416x288
    canvas. Returns (canvas_h, canvas_w, new_w, new_h, pad_x, pad_y)."""
    ratio = img_size / max(H, W)
    new_w, new_h = int(round(W * ratio)), int(round(H * ratio))
    pad_x = ((img_size - new_w) // 2) % multiple
    pad_y = ((img_size - new_h) // 2) % multiple
    canvas_w = -(-(new_w + pad_x) // multiple) * multiple
    canvas_h = -(-(new_h + pad_y) // multiple) * multiple
    return canvas_h, canvas_w, new_w, new_h, pad_x, pad_y


def canvas_geometry(H: int, W: int, img_size: int, rect: bool):
    """(canvas_h, canvas_w, new_w, new_h, pad_x, pad_y) of the square
    (rect=False) or rectangular letterbox."""
    if rect:
        return rect_canvas_geometry(H, W, img_size)
    new_w, new_h, pad_x, pad_y = letterbox_geometry(H, W, img_size)
    return img_size, img_size, new_w, new_h, pad_x, pad_y


def letterbox_axis_taps(out: int, pad: int, new_len: int, size: int):
    """Per-output-index taps of one letterbox axis, as numpy arrays
    (i0 int32, i1 int32, w0 f32, w1 f32) of length `out`: cv2's half-pixel
    rule inside the content band, zero weights (and index 0) outside it."""
    i0 = np.zeros(out, np.int32)
    i1 = np.zeros(out, np.int32)
    w0 = np.zeros(out, np.float32)
    w1 = np.zeros(out, np.float32)
    o = np.arange(pad, pad + new_len)
    src = np.clip((o - pad + 0.5) * (size / new_len) - 0.5, 0.0, size - 1.0)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    i0[o] = lo
    i1[o] = np.minimum(lo + 1, size - 1)
    w0[o] = 1.0 - frac
    w1[o] = frac
    return i0, i1, w0, w1


def letterbox_taps(H: int, W: int, img_size: int, rect: bool):
    """((i0, i1, w0, w1) rows, same for columns, canvas_h, canvas_w) of the
    square or rect letterbox of an H x W frame."""
    canvas_h, canvas_w, new_w, new_h, pad_x, pad_y = canvas_geometry(H, W, img_size, rect)
    return (letterbox_axis_taps(canvas_h, pad_y, new_h, H),
            letterbox_axis_taps(canvas_w, pad_x, new_w, W), canvas_h, canvas_w)


def letterbox_plain(
    frames_u8: torch.Tensor,  # (B, H, W, 3) uint8
    img_size: int = 416,
    rect: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of K2's letterbox on any device: (B, canvas_h,
    canvas_w, 3) in [0, 1] with the 128/255 border. Each product and sum is
    its own op, in the kernel's order, so the f32 outputs agree bit for bit."""
    H, W = int(frames_u8.shape[1]), int(frames_u8.shape[2])
    rows, cols, _, _ = letterbox_taps(H, W, img_size, rect)
    dev = frames_u8.device
    y0, y1, wy0, wy1 = (torch.as_tensor(a, device=dev) for a in rows)
    x0, x1, wx0, wx1 = (torch.as_tensor(a, device=dev) for a in cols)

    def px(yi, xi):
        return frames_u8[:, yi.long()[:, None], xi.long()[None, :]].to(torch.float32)

    wy0c, wy1c = wy0[None, :, None, None], wy1[None, :, None, None]
    wx0c, wx1c = wx0[None, None, :, None], wx1[None, None, :, None]
    r0 = wx0c * px(y0, x0) + wx1c * px(y0, x1)
    r1 = wx0c * px(y1, x0) + wx1c * px(y1, x1)
    coverage = (wy0 + wy1)[:, None] * (wx0 + wx1)[None, :]
    border = GRAY * (1.0 - coverage)
    out = (wy0c * r0 + wy1c * r1) * (1.0 / 255.0) + border[None, :, :, None]
    return out.to(out_dtype)


def _letterbox(frames_u8: torch.Tensor, img_size: int, rect: bool,
               out_dtype: torch.dtype) -> torch.Tensor:
    if frames_u8.device.type == "cuda":
        from poserisk_release_tpu_torch.ops.resample import fused_letterbox_crop_cuda

        letter, _ = fused_letterbox_crop_cuda(
            frames_u8, None, img_size=img_size, out_dtype=out_dtype, rect=rect)
        return letter
    if frames_u8.device.type == "cpu":
        return letterbox_plain(frames_u8, img_size, rect, out_dtype)
    raise ValueError(f"the letterbox has no path for device {frames_u8.device}")


def letterbox_device(frames_u8: torch.Tensor, img_size: int = 416,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Square (img_size x img_size) letterbox of uint8 frames: K2's
    letterbox-only mode on a CUDA device, the plain version on the CPU."""
    return _letterbox(frames_u8, img_size, False, out_dtype)


def letterbox_device_rect(frames_u8: torch.Tensor, img_size: int = 416,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rectangular-canvas letterbox (rect_canvas_geometry) of uint8 frames:
    K2's letterbox-only mode on a CUDA device, the plain version on the CPU."""
    return _letterbox(frames_u8, img_size, True, out_dtype)
