"""The reference's convolutions and linear layers, and the control's precision.

On a CUDA card the control runs these in TF32 through PyTorch's switches
(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32).
A CPU has no TF32, so there `TF32` makes them round both operands to TF32's
10-bit mantissa first, as the tensor cores do, and accumulate in f32.
"""

import torch
import torch.nn.functional as F

TF32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    if not TF32 or x.device.type != "cpu" or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(_tf32(x), _tf32(w), b, stride, padding)


def linear(x, w, b=None):
    return F.linear(_tf32(x), _tf32(w), b)


def set_tf32(on: bool) -> None:
    global TF32
    TF32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
