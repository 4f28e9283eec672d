"""The int8 convolution of both PTQ conv towers (YOLOv3 and SPIN's ResNet-50).

The JAX package computes every quantized conv as
jax.lax.conv_general_dilated(s8, s8, preferred_element_type=int32)
(models/detector.py:_conv_block, models/resnet_int8.py:_qconv): XLA's
product, not a Pallas kernel. The port does the same with a library
product:

* on a CUDA device: im2col of the int8 activation ((ky, kx, cin)-major
  columns, the HWIO kernel's row order; a 1x1 stride-1 conv needs none) and
  torch._int_mm (s8 x s8 -> s32 on cuBLASLt) against the (N, K) weight
  matrix derived once at load. _int_mm takes K and N in multiples of 8 and
  more than 16 rows, so K is zero-padded (YOLO's conv_0 has K = 27, SPIN's
  conv1 K = 147) and tiny inputs gain zero rows;
* on the CPU (the plain version): the same convolution in float64, whose
  sums are exact here (|sum| <= 127^2 * 9 * 1024 < 2^53; float32 is not).

Around the product, the JAX order of operations:
    xq = clip(round(x.astype(cd) * (1 / in_scale).astype(cd)), -127, 127)
    y  = acc.astype(f32) * (in_scale * w_scale) + bias
    y  = leaky 0.1 (detector) | ReLU (SPIN) | none
    -> y.astype(cd), or int8 for the next conv (the q8 `out_scale` handoff)
where cd is the compute dtype (bf16 for the quantized detector) and round
is half-to-even in both frameworks. Tensors are NCHW (the towers' layout,
channels-last in memory on the card); the CUDA product works on NHWC.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LEAKY_SLOPE = 0.1


def quantize(x: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """clip(round(x * inv_s), -127, 127) as int8 (round half-to-even)."""
    return torch.clamp(torch.round(x * inv_s), -127.0, 127.0).to(torch.int8)


def leaky(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y > 0, y, LEAKY_SLOPE * y)


def _pads(pad):
    """An int padding, or a (rows, columns) pair, as the pair."""
    return (pad, pad) if isinstance(pad, int) else (int(pad[0]), int(pad[1]))


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, pad) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B*Ho*Wo, kh*kw*C) columns in (ky, kx, cin)
    order; pad: an int, or a (rows, columns) pair."""
    B, H, W, C = xq.shape
    ph, pw = _pads(pad)
    if kh == kw == 1 and stride == 1 and ph == pw == 0:
        return xq.reshape(B * H * W, C)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph)) if (ph or pw) else xq
    Ho = (H + 2 * ph - kh) // stride + 1
    Wo = (W + 2 * pw - kw) // stride + 1
    taps = [xp[:, ky:ky + stride * (Ho - 1) + 1:stride, kx:kx + stride * (Wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(B * Ho * Wo, kh * kw * C)


def int_conv_nhwc(xq: torch.Tensor, wmat: torch.Tensor, kh: int, kw: int, stride: int,
                  pad) -> torch.Tensor:
    """The s8 x s8 -> s32 product on CUDA: xq (B, H, W, C) int8, wmat
    (N, K_pad) int8 with K_pad >= kh*kw*C a multiple of 8; pad an int or
    a (rows, columns) pair. Returns (B, Ho, Wo, N) int32."""
    B, H, W, _ = xq.shape
    ph, pw = _pads(pad)
    Ho = (H + 2 * ph - kh) // stride + 1
    Wo = (W + 2 * pw - kw) // stride + 1
    cols = _im2col(xq, kh, kw, stride, (ph, pw))
    M, K = cols.shape
    K_pad = wmat.shape[1]
    M_pad = max(M, 17)
    if K != K_pad or M != M_pad or not cols.is_contiguous():
        cols = F.pad(cols, (0, K_pad - K, 0, M_pad - M))
    return torch._int_mm(cols, wmat.t())[:M].reshape(B, Ho, Wo, -1)


def int_conv_plain(xq: torch.Tensor, qkernel_oihw: torch.Tensor, stride: int,
                   pad) -> torch.Tensor:
    """The plain version of the product on any device: float64 conv of the
    int8 values, exact. xq (B, C, H, W) int8 -> (B, N, Ho, Wo) float64;
    pad an int or a (rows, columns) pair."""
    return F.conv2d(xq.to(torch.float64), qkernel_oihw.to(torch.float64),
                    stride=stride, padding=_pads(pad))


def weight_matrix(qkernel_hwio: np.ndarray) -> np.ndarray:
    """HWIO int8 kernel -> the (N, K_pad) GEMM matrix: row n holds output
    channel n's (ky, kx, cin) weights, zero-padded to a multiple of 8."""
    kh, kw, cin, n = qkernel_hwio.shape
    k = kh * kw * cin
    out = np.zeros((n, -(-k // 8) * 8), np.int8)
    out[:, :k] = np.asarray(qkernel_hwio, np.int8).reshape(k, n).T
    return out


class QConv2d(nn.Module):
    """One quantized conv with its fused epilogue. forward(x NCHW, compute
    dtype) -> NCHW in the compute dtype, or int8 when `out_scale` is set.

    Buffers: the HWIO kernel's GEMM matrix `wmat` (N, K_pad) and its OIHW
    copy `qkernel` (int8), `dq` = in_scale * w_scale (f32), `bias` (f32),
    `inv_s` = 1 / in_scale (f32) and, for the handoff, `inv_out` =
    1 / out_scale (f32). The f32 buffers keep their dtype: cast the module
    with .to(device) only (a dtype cast raises)."""

    def __init__(self, qkernel_hwio, w_scale, in_scale, bias, stride: int, pad: int,
                 act: Optional[str], out_scale=None):
        super().__init__()
        q = np.asarray(qkernel_hwio, np.int8)
        self.kh, self.kw = q.shape[0], q.shape[1]
        self.stride, self.pad, self.act = int(stride), int(pad), act
        f32 = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731 (owns a copy)
        in_scale = f32(in_scale)
        self.register_buffer("wmat", torch.as_tensor(weight_matrix(q)))
        self.register_buffer("qkernel", torch.as_tensor(np.ascontiguousarray(
            q.transpose(3, 2, 0, 1))))
        self.register_buffer("dq", in_scale * f32(w_scale))
        self.register_buffer("bias", f32(bias))
        self.register_buffer("inv_s", 1.0 / in_scale)
        self.register_buffer("inv_out", None if out_scale is None else 1.0 / f32(out_scale))

    def _apply(self, fn, recurse=True):
        dtypes = {k: b.dtype for k, b in self._buffers.items() if b is not None}
        out = super()._apply(fn, recurse)
        if any(b.dtype != dtypes[k] for k, b in self._buffers.items() if b is not None):
            raise TypeError("QConv2d keeps int8 weights and float32 scales; move it "
                            "with .to(device) only")
        return out

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype, pad=None) -> torch.Tensor:
        """pad: the (rows, columns) padding in place of the layer's own."""
        pad = self.pad if pad is None else pad
        if x.dtype == torch.int8:
            xq = x  # q8 handoff: already scaled by this layer's in_scale
        else:
            xq = quantize(x.to(compute_dtype), self.inv_s.to(compute_dtype))
        if x.device.type == "cuda":
            acc = int_conv_nhwc(xq.permute(0, 2, 3, 1).contiguous(), self.wmat, self.kh,
                                self.kw, self.stride, pad).permute(0, 3, 1, 2)
        elif x.device.type == "cpu":
            acc = int_conv_plain(xq, self.qkernel, self.stride, pad)
        else:
            raise ValueError(f"the int8 conv has no path for device {x.device}")
        y = acc.to(torch.float32) * self.dq[:, None, None] + self.bias[:, None, None]
        if self.act == "leaky":
            y = leaky(y)
        elif self.act == "relu":
            y = torch.relu(y)
        return quantize(y, self.inv_out) if self.inv_out is not None else y.to(compute_dtype)


def quantize_kernel(kernel_hwio: np.ndarray):
    """Symmetric per-output-channel int8 weights, host-side, in the JAX
    package's arithmetic: (qkernel HWIO int8, w_scale f32)."""
    kernel = np.asarray(kernel_hwio, np.float32)
    w_scale = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-12) / 127.0
    qkernel = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
    return qkernel, w_scale.astype(np.float32)


def act_scale(absmax: float) -> np.float32:
    """The static per-tensor activation scale from a calibrated absmax."""
    return np.float32(max(absmax, 1e-12) / 127.0)


def layer_arrays(layer: Dict) -> Dict[str, np.ndarray]:
    """A layer dict's leaves as numpy arrays (tensors moved to the host)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in layer.items()}
