"""Kernel K1 on Hopper: the batched bbox crop as a hand-written CUDA gather.

Replaces crop_batch_pallas (poserisk_release_tpu/ops/resample_pallas.py:426),
the TPU kernel that crops through per-frame tap matrices on the matrix unit.
The CUDA source is csrc/crop.cu (its header states the design and the
bound); it builds with nvcc at first use (_build.py) and is bound through
ctypes. The plain version it is held against is ops/crop.crop_batch_plain.

crop_batch_cuda.launches counts the kernel launches of this process, so a
run can show that its crops went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("crop")
    if lib.crop_batch_launch.argtypes is None:
        lib.crop_batch_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.crop_batch_launch.restype = ctypes.c_int
        lib.crop_error_string.argtypes = [ctypes.c_int]
        lib.crop_error_string.restype = ctypes.c_char_p
    return lib


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
    if frames_u8.device.type != "cuda":
        raise ValueError(f"crop_batch_cuda needs CUDA frames, got {frames_u8.device}")
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
        raise ValueError("crop_batch_cuda needs contiguous frames and bboxes")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")

    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype,
                      device=frames_u8.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.crop_batch_launch(
            frames_u8.data_ptr(), bboxes.data_ptr(), out.data_ptr(),
            B, H, W, int(out_size), float(scale),
            int(out_dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"crop kernel launch failed: {lib.crop_error_string(code).decode()}")
    crop_batch_cuda.launches += 1
    return out


crop_batch_cuda.launches = 0
