"""The strict-f32 HMR's conv epilogue on Hopper: a conv's folded bias, the
bottleneck's residual add and the ReLU in one in-place pass over the conv's
NCHW output (csrc/conv_epilogue.cu; its header states the bound and the
design).

It replaces no TPU kernel: XLA fused the JAX package's BatchNorm, ReLU and
residual add into its convolutions. On the card the strict-f32 HMR runs
a BN-folded backbone (pipeline.PoseEstimator, models/resnet_int8.
resnet50_forward), which follows each bias-free conv with this one pass, in
place of the BatchNorm, ReLU and add kernels. conv_epilogue_plain is its
plain version: the same f32 operations in the same order, which the CPU
runs.

conv_epilogue_cuda.launches counts the kernel's launches in this process;
a launch recorded into a CUDA graph counts in `.captured` instead, and the
graph's owner adds the recorded launches to `.launches` on every replay
(serving._BucketGraph).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """In place on y (N, C, H, W): y + bias[c], then + residual, then ReLU
    when asked, each an f32 op of its own; returns y."""
    y.add_(bias.view(1, -1, 1, 1))
    if residual is not None:
        y.add_(residual)
    return y.relu_() if relu else y


def _lib():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("conv_epilogue")
    if lib.conv_epilogue_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_epilogue_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.conv_epilogue_launch.restype = ctypes.c_int
        lib.conv_epilogue_error_string.argtypes = [ctypes.c_int]
        lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False) -> torch.Tensor:
    """The kernel, in place on y, launched on the current stream: y a
    contiguous (N, C, H, W) f32 CUDA tensor, bias (C,) f32 and residual
    None or y's shape, contiguous, on y's device. Raises on any other input
    and on a refused launch; returns y."""
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue_cuda needs a CUDA tensor, got {y.device}")
    if y.dtype != torch.float32 or y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous NCHW float32 tensor, got "
                         f"{tuple(y.shape)} {y.dtype} strides {y.stride()}")
    N, C, H, W = (int(s) for s in y.shape)
    if (bias.device != y.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (C,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous ({C},) float32 on {y.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if residual is not None and (residual.device != y.device or residual.dtype != y.dtype
                                 or residual.shape != y.shape or not residual.is_contiguous()):
        raise ValueError(f"residual must be contiguous {tuple(y.shape)} float32 on "
                         f"{y.device}, got {tuple(residual.shape)} {residual.dtype} on "
                         f"{residual.device}")
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = lib.conv_epilogue_launch(
            y.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
            N, C, H * W, int(relu), stream)
    if code != 0:
        raise RuntimeError(f"conv epilogue kernel launch failed: "
                           f"{lib.conv_epilogue_error_string(code).decode()}")
    if capturing:
        conv_epilogue_cuda.captured += 1
    else:
        conv_epilogue_cuda.launches += 1
    return y


conv_epilogue_cuda.launches = conv_epilogue_cuda.captured = 0


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """THE conv epilogue: the kernel on a CUDA device, its plain version on
    the CPU; any other device raises. There is no fallback from the kernel
    to the plain version."""
    if y.device.type == "cuda":
        return conv_epilogue_cuda(y, bias, residual, relu)
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, residual, relu)
    raise ValueError(f"conv_epilogue has no path for device {y.device}")
