"""Kernels K1 and K2 on Hopper: the resamples of raw frames as CUDA gathers.

K1, crop_batch_cuda, replaces crop_batch_pallas
(poserisk_release_tpu/ops/resample_pallas.py:426): the batched bbox crop of
the pose path (csrc/crop.cu; plain version ops/crop.crop_batch_plain).

K3, crop_batch_windowed_cuda, replaces crop_batch_pallas_windowed
(resample_pallas.py:336): K1's crop reading only a window of columns per
frame (csrc/crop.cu; plain version ops/crop.crop_batch_windowed_plain).

K1m, crop_batch_multi_cuda, replaces crop_batch_pallas_multi (the JAX
package's tools/exp_window_crop.py:70): K1 with several frames per block,
launched only by tools/exp_window_crop (plain version crop_batch_plain).

K2, fused_letterbox_crop_cuda, replaces fused_letterbox_crop
(resample_pallas.py:133): one launch writes the detector's letterbox canvas
and the bbox crop from each frame, under the detection, pose and frame
strides of the full-frame step (csrc/letterbox_crop.cu; plain version
fused_letterbox_crop_plain below). Its letterbox-only mode (no boxes) is the
letterbox of ops/crop.letterbox_device / letterbox_device_rect on the card.

The TPU kernels resample through tap matrices on the matrix unit; the
sources' headers state the gather design and the bound. Each builds with
nvcc at first use (_build.py) and is bound through ctypes. Each wrapper's
`.launches` counts its kernel launches in this process, so a run can show
that its resamples went through the kernels; K1's also counts the launches
it records into a CUDA graph apart, in `.captured`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("crop")
    if lib.crop_batch_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crop_batch_launch.argtypes = [p, p, p, i, i, i, i, f, i, p]
        lib.crop_batch_launch.restype = ctypes.c_int
        lib.crop_window_launch.argtypes = [p, p, p, i, i, i, i, f, i, i, p]
        lib.crop_window_launch.restype = ctypes.c_int
        lib.crop_multi_launch.argtypes = [p, p, p, i, i, i, i, f, i, i, p]
        lib.crop_multi_launch.restype = ctypes.c_int
        lib.crop_error_string.argtypes = [ctypes.c_int]
        lib.crop_error_string.restype = ctypes.c_char_p
    return lib


def _check_crop_inputs(name: str, frames_u8: torch.Tensor, bboxes: torch.Tensor,
                       out_dtype: torch.dtype):
    """The checks K1 and K3 share; returns (B, H, W)."""
    if frames_u8.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA frames, got {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[3] != 3:
        raise ValueError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames_u8.shape)} {frames_u8.dtype}")
    B, H, W = (int(s) for s in frames_u8.shape[:3])
    if (bboxes.device != frames_u8.device or bboxes.dtype != torch.float32
            or tuple(bboxes.shape) != (B, 4)):
        raise ValueError(
            f"bboxes must be ({B}, 4) float32 on {frames_u8.device}, got "
            f"{tuple(bboxes.shape)} {bboxes.dtype} on {bboxes.device}")
    if not (frames_u8.is_contiguous() and bboxes.is_contiguous()):
        raise ValueError(f"{name} needs contiguous frames and bboxes")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    return B, H, W


def crop_batch_cuda(
    frames_u8: torch.Tensor,  # (B, H, W, 3) uint8, contiguous, on a CUDA device
    bboxes: torch.Tensor,  # (B, 4) float32 [cx, cy, w, h], same device
    scale: float = 1.2,
    out_size: int = 224,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, out_size, out_size, 3) crops in [0, 1] as f32 (strict) or bf16
    (fast), launched on the current stream. Raises on any input the kernel
    does not take and on a refused launch."""
    B, H, W = _check_crop_inputs("crop_batch_cuda", frames_u8, bboxes, out_dtype)
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype,
                      device=frames_u8.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = lib.crop_batch_launch(
            frames_u8.data_ptr(), bboxes.data_ptr(), out.data_ptr(),
            B, H, W, int(out_size), float(scale), int(out_dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"crop kernel launch failed: {lib.crop_error_string(code).decode()}")
    if capturing:
        # Recorded into a CUDA graph, not launched: the graph's owner adds
        # the recorded launches to `.launches` on every replay
        # (serving._BucketGraph).
        crop_batch_cuda.captured += 1
    else:
        crop_batch_cuda.launches += 1
    return out


crop_batch_cuda.launches = crop_batch_cuda.captured = 0


# ---------------------------------------------------------------------------
# K1m: K1 with several frames per block (csrc/crop.cu, crop_multi_launch).
# ---------------------------------------------------------------------------
def crop_batch_multi_cuda(
    frames_u8: torch.Tensor,
    bboxes: torch.Tensor,
    frames_per_block: int = 2,
    scale: float = 1.2,
    out_size: int = 224,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K1m, replacing crop_batch_pallas_multi (tools/exp_window_crop.py:70,
    the JAX tool's frames-per-program probe): K1's crop with each thread
    cropping one pixel position of `frames_per_block` consecutive frames (B a
    multiple of it). Its plain version is ops/crop.crop_batch_plain; only
    tools/exp_window_crop calls it. Raises on any input the kernel does not
    take and on a refused launch."""
    B, H, W = _check_crop_inputs("crop_batch_multi_cuda", frames_u8, bboxes, out_dtype)
    if frames_per_block < 1 or B % frames_per_block:
        raise ValueError(f"frames_per_block {frames_per_block} does not divide {B} frames")
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype, device=frames_u8.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.crop_multi_launch(
            frames_u8.data_ptr(), bboxes.data_ptr(), out.data_ptr(),
            B, H, W, int(out_size), float(scale), int(frames_per_block),
            int(out_dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"multi-frame crop kernel launch failed: {lib.crop_error_string(code).decode()}")
    crop_batch_multi_cuda.launches += 1
    return out


crop_batch_multi_cuda.launches = 0


# ---------------------------------------------------------------------------
# Kernel K3: the windowed crop (csrc/crop.cu, crop_window_launch).
# ---------------------------------------------------------------------------
def crop_batch_windowed_cuda(
    frames_u8: torch.Tensor,
    bboxes: torch.Tensor,
    scale: float = 1.2,
    out_size: int = 224,
    window: int = 384,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K3: K1's crop reading only `window` columns per frame, from the
    chunk ops/crop.window_blocks gives (the kernel computes it from the
    box); a column tap outside the window is dropped. The window must be
    narrower than the frame's chunks (ops/crop.crop_batch_windowed routes whole-width windows
    to K1). Raises on any input the kernel does not take and on a refused
    launch."""
    from poserisk_release_tpu_torch.ops.crop import WINDOW_CHUNK

    B, H, W = _check_crop_inputs("crop_batch_windowed_cuda", frames_u8, bboxes, out_dtype)
    if window <= 0 or window % WINDOW_CHUNK or window // WINDOW_CHUNK >= -(-W // WINDOW_CHUNK):
        raise ValueError(f"window {window} must be a multiple of {WINDOW_CHUNK} narrower "
                         f"than the {W}-column frame's chunks")
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype, device=frames_u8.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.crop_window_launch(
            frames_u8.data_ptr(), bboxes.data_ptr(), out.data_ptr(),
            B, H, W, int(out_size), float(scale), int(window),
            int(out_dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"windowed crop kernel launch failed: {lib.crop_error_string(code).decode()}")
    crop_batch_windowed_cuda.launches += 1
    return out


crop_batch_windowed_cuda.launches = 0


# ---------------------------------------------------------------------------
# Kernel K2: the fused detector letterbox + bbox crop (csrc/letterbox_crop.cu).
# ---------------------------------------------------------------------------
def _lib_k2():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("letterbox_crop")
    if lib.letterbox_crop_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.letterbox_crop_launch.argtypes = [
            p, ll, i, i,  # frames, frame_step, H, W
            p, i, i, i,  # table, n_bands, band_rows, slot_bytes
            p, p, i, i, p,  # rows, cols, CH, CW, letter
            p, ll, p, i, ctypes.c_float,  # bboxes, bbox_step, crops, S, scale
            i, p,  # out_bf16, stream
        ]
        lib.letterbox_crop_launch.restype = ctypes.c_int
        lib.letterbox_crop_error_string.argtypes = [ctypes.c_int]
        lib.letterbox_crop_error_string.restype = ctypes.c_char_p
    return lib


K2_MAX_BAND = 8  # kMaxBand of letterbox_crop.cu: output rows of a band at most
K2_SMEM_BUDGET = 40 * 1024  # a block's staged rows, bytes
K2_SMEM_LIMIT = 232448 - 1024  # kMaxSmem: a block's dynamic shared memory on Hopper
K2_STAGING = 256 * 12 * 4  # each warp's 32 runs of 12 f32 values (bf16: half)
K2_BANDS_PER_SM = 16  # four waves of the four blocks an SM holds


def k2_band_geometry(W: int):
    """(R, slot_bytes, staged bytes) of K2 for W-pixel frames: a staged row
    takes slot_bytes (W*3 plus the 24 bytes the kernel may read past it,
    rounded up to 16), a block stages at most 2R rows, and R <= 8 keeps
    them within K2_SMEM_BUDGET where one row pair fits it at all (R = 8 at
    W = 800: with the store staging area, four blocks an SM)."""
    slot = -(-(3 * W + 32) // 16) * 16
    R = max(1, min(K2_MAX_BAND, K2_SMEM_BUDGET // (2 * slot)))
    return R, slot, 2 * R * slot


def k2_band_rows(W: int, CH: int, S: int, n_det: int, n_crop: int, n_sm: int) -> int:
    """R for one launch: k2_band_geometry's, or 4 where that many rows a
    band would leave fewer than K2_BANDS_PER_SM bands an SM for n_det
    canvases of CH rows and n_crop crops of S rows (the fast step's 8
    frames), so that the blocks still fill the card."""
    R = k2_band_geometry(W)[0]
    bands = n_det * -(-CH // R) + n_crop * -(-S // R)
    return 4 if R > 4 and bands < K2_BANDS_PER_SM * n_sm else R


@functools.lru_cache(maxsize=8)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k2_band_plan(i0, i1, w0, w1):
    """(lo, n) of the source rows a band of output rows with these row taps
    stages: rows [lo, lo + n) when its nonzero-weight rows read at most two
    rows per output row between them, n = -1 for two slots per output row
    (i0 and i1 of each), (0, 0) when every row has both weights 0. The
    kernel applies the same rule to crop bands."""
    used = (np.asarray(w0) != 0) | (np.asarray(w1) != 0)
    if not used.any():
        return 0, 0
    lo, hi = int(np.asarray(i0)[used].min()), int(np.asarray(i1)[used].max())
    return (lo, hi - lo + 1) if hi - lo + 1 <= 2 * len(used) else (0, -1)


def k2_block_table(H, W, img_size, rect, n_sub, det_stride, crop_stride, S, R) -> np.ndarray:
    """K2's block table, (n_bands, 8) int32, one row per band and block:
    sub-frame, kind (0 letterbox, 1 crop), first output row, rows, output index, and
    for letterbox bands the staged rows (lo, n) of k2_band_plan. Sub-frame b
    has letterbox bands of R canvas rows when b % det_stride == 0 and crop
    bands of R crop rows when crop_stride and b % crop_stride == 0,
    frame-major: a frame's letterbox bands, then its crop bands."""
    from poserisk_release_tpu_torch.ops.crop import letterbox_taps

    rows, _, CH, _ = letterbox_taps(H, W, img_size, rect)
    lb = []
    for r0 in range(0, CH, R):
        taps = [t[r0:r0 + R] for t in rows]
        lb.append([r0, len(taps[0]), *k2_band_plan(*taps)])
    cb = [[r0, min(R, S - r0), 0, 0] for r0 in range(0, S, R)]
    entries = []
    for b in range(n_sub):
        if b % det_stride == 0:
            entries += [[b, 0, r0, n, b // det_stride, lo, k, 0] for r0, n, lo, k in lb]
        if crop_stride and b % crop_stride == 0:
            entries += [[b, 1, r0, n, b // crop_stride, 0, 0, 0] for r0, n, _, _ in cb]
    return np.asarray(entries, np.int32).reshape(-1, 8)


@functools.lru_cache(maxsize=16)
def _tap_tables(H, W, img_size, rect, device):
    """Device copies of the letterbox's row and column taps, as (n, 4)
    int32 rows [i0, i1, bits(w0), bits(w1)], per geometry (read only)."""
    from poserisk_release_tpu_torch.ops.crop import letterbox_taps

    rows, cols, CH, CW = letterbox_taps(H, W, img_size, rect)

    def pack(taps):
        i0, i1, w0, w1 = taps
        return torch.as_tensor(np.stack(
            [i0, i1, w0.view(np.int32), w1.view(np.int32)], axis=1), device=device)

    return pack(rows), pack(cols), CH, CW


@functools.lru_cache(maxsize=64)
def _block_table(H, W, img_size, rect, n_sub, det_stride, crop_stride, S, R, device):
    """A device copy of k2_block_table, per geometry and strides (read only)."""
    table = k2_block_table(H, W, img_size, rect, n_sub, det_stride, crop_stride, S, R)
    return torch.as_tensor(table, device=device), table.shape[0]


def fused_letterbox_crop_cuda(
    frames_u8: torch.Tensor,  # (B, H, W, 3) uint8 on a CUDA device
    bboxes: torch.Tensor | None,  # (B, 4) float32 [cx, cy, w, h], or None
    img_size: int = 416,
    out_size: int = 224,
    scale: float = 1.2,
    out_dtype: torch.dtype = torch.float32,
    det_stride: int = 1,
    crop_stride: int = 1,
    frame_stride: int = 1,
    rect: bool = True,
):
    """(letterbox (ceil(B'/det_stride), canvas_h, canvas_w, 3), crops
    (ceil(B'/crop_stride), out_size, out_size, 3)), B' = ceil(B /
    frame_stride): letterbox_plain(frames[::frame_stride*det_stride]) and
    crop_batch_plain(frames[::frame_stride*crop_stride]) from one launch.
    bboxes=None is the letterbox-only mode and returns (letterbox, None).
    `frames_u8` may be a batch slice (frames[::k]) of a contiguous tensor.
    Raises on any input the kernel does not take and on a refused launch."""
    if frames_u8.device.type != "cuda":
        raise ValueError(
            f"fused_letterbox_crop_cuda needs CUDA frames, got {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[3] != 3:
        raise ValueError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames_u8.shape)} {frames_u8.dtype}")
    B, H, W = (int(s) for s in frames_u8.shape[:3])
    if frames_u8.stride()[1:] != (W * 3, 3, 1):
        raise ValueError("each frame must be contiguous (only the batch axis may be strided)")
    if min(det_stride, frame_stride) < 1 or crop_stride < 1:
        raise ValueError(f"strides must be >= 1, got det {det_stride}, crop "
                         f"{crop_stride}, frame {frame_stride}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    _, slot, staged = k2_band_geometry(W)
    if staged + K2_STAGING > K2_SMEM_LIMIT:
        raise ValueError(f"a {W}-pixel row is too wide for the kernel's shared memory")
    crop = bboxes is not None
    if crop and (bboxes.device != frames_u8.device or bboxes.dtype != torch.float32
                 or tuple(bboxes.shape) != (B, 4) or not bboxes.is_contiguous()):
        raise ValueError(
            f"bboxes must be contiguous ({B}, 4) float32 on {frames_u8.device}, got "
            f"{tuple(bboxes.shape)} {bboxes.dtype} on {bboxes.device}")

    dev = frames_u8.device
    rows, cols, CH, CW = _tap_tables(H, W, int(img_size), bool(rect), dev)
    n_sub = -(-B // frame_stride)
    n_det = -(-n_sub // det_stride)
    n_crop = -(-n_sub // crop_stride)
    S = int(out_size)
    letter = torch.empty((n_det, CH, CW, 3), dtype=out_dtype, device=dev)
    crops = (torch.empty((n_crop, S, S, 3), dtype=out_dtype, device=dev) if crop else None)
    if B == 0:
        return letter, crops
    R = k2_band_rows(W, CH, S, n_det, n_crop if crop else 0, _sm_count(dev))
    table, n_bands = _block_table(H, W, int(img_size), bool(rect), n_sub, det_stride,
                                   crop_stride if crop else 0, S, R, dev)
    lib = _lib_k2()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.letterbox_crop_launch(
            frames_u8.data_ptr(), frames_u8.stride(0) * frame_stride, H, W,
            table.data_ptr(), n_bands, R, slot, rows.data_ptr(), cols.data_ptr(), CH, CW,
            letter.data_ptr(), bboxes.data_ptr() if crop else None, 4 * frame_stride,
            crops.data_ptr() if crop else None, S, float(scale),
            int(out_dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"letterbox+crop kernel launch failed: "
            f"{lib.letterbox_crop_error_string(code).decode()}")
    fused_letterbox_crop_cuda.launches += 1
    return letter, crops


fused_letterbox_crop_cuda.launches = 0


def fused_letterbox_crop_plain(frames_u8, bboxes, img_size=416, out_size=224, scale=1.2,
                               out_dtype=torch.float32, det_stride=1, crop_stride=1,
                               frame_stride=1, rect=True):
    """The plain version of K2: letterbox_plain(frames[::g*d]) and
    crop_batch_plain(frames[::g*p]), g = frame_stride."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch_plain, letterbox_plain

    g = frame_stride
    letter = letterbox_plain(frames_u8[::g * det_stride], img_size, rect, out_dtype)
    crops = None
    if bboxes is not None:
        step = g * crop_stride
        crops = crop_batch_plain(frames_u8[::step], bboxes[::step], scale, out_size, out_dtype)
    return letter, crops


def fused_letterbox_crop(frames_u8, bboxes, img_size=416, out_size=224, scale=1.2,
                         out_dtype=torch.float32, det_stride=1, crop_stride=1,
                         frame_stride=1, rect=True):
    """K2 on a CUDA device, its plain version on the CPU; any other device
    raises. There is no fallback from the kernel to the plain version."""
    args = (img_size, out_size, scale, out_dtype, det_stride, crop_stride,
            frame_stride, rect)
    if frames_u8.device.type == "cuda":
        if bboxes is not None:
            bboxes = bboxes.to(device=frames_u8.device, dtype=torch.float32).contiguous()
        return fused_letterbox_crop_cuda(frames_u8, bboxes, *args)
    if frames_u8.device.type == "cpu":
        if bboxes is not None:
            bboxes = bboxes.to(dtype=torch.float32)
        return fused_letterbox_crop_plain(frames_u8, bboxes, *args)
    raise ValueError(f"fused_letterbox_crop has no path for device {frames_u8.device}")
