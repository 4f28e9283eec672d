"""Kernel K5 on Hopper: one whole int8 Darknet-53 residual stage.

Replaces fused_residual_stage (poserisk_release_tpu/ops/yolo_stage_pallas.py:
147, body _stage_kernel): for each residual block j of a stage,

    q  = clip(round(h * inv_s[j, 0]), +-127)           quantize the stream
    a  = leaky(d1[j] * (q @ qk1[j]) + b1[j])           1x1 s8 matmul, epilogue
    aq = clip(round(a * inv_s[j, 1]), +-127)           quantize
    y  = leaky(d3[j] * conv3x3(aq, qk3[j]) + b3[j])    3x3 s8 conv, zero pad
    h  = h + y                                         f32 shortcut

with the residual stream in f32 from the stage's input to its output, which
is cast back to the input dtype. The JAX package calls it only from its
experiment tool (tools/exp_fused_stage.py), and so does the port
(poserisk_release_tpu_torch/tools/exp_fused_stage.py); no product path
runs it.

pack_yolo_stage stacks a stage's int8 params with the JAX package's checks,
shapes and host arithmetic (yolo_stage_pallas.py:50-96).
fused_residual_stage_plain is the plain version: torch ops in the kernel's
order, the int32 sums taken exactly in float64. fused_residual_stage_cuda
launches csrc/yolo_stage.cu: one quantize launch for the first block's int8
input, then per block a 1x1 int8 GEMM and a 3x3 int8 implicit GEMM on wgmma
s8 tensor-core instructions fed by a ring of cp.async copies; the 3x3 writes
the next block's int8 input beside the f32 stream. Its source says what
bounds it and how it is laid out. fused_residual_stage dispatches a CUDA
tensor to the kernel and a CPU tensor to the plain version, and raises on
any other device.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from poserisk_release_tpu_torch.ops.qconv import leaky


def pack_yolo_stage(qparams: Dict, start: int, n_blocks: int) -> Dict[str, np.ndarray]:
    """Stack one residual stage's int8 params (a quantize_yolo_params
    state_dict; `start` is the spec index of the stage's first 1x1 conv,
    blocks being (1x1 @ i, 3x3 @ i+1, shortcut @ i+2)). Requires every conv
    of the stage to be quantized. Returns host arrays:
      qk1 (n, C, C/2) s8, qk3 (n, 9*C/2, C) s8 ((ky, kx, cin)-major rows),
      d1/b1 (n, 1, C/2) f32, d3/b3 (n, 1, C) f32 (in_scale * w_scale and
      the folded bias of the 1x1 / 3x3), inv_s (n, 2) f32 (1 / in_scale of
      the 1x1 and the 3x3, divided in float64)."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    def arr(key):
        v = qparams[key]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    qk1, qk3, d1, b1, d3, b3, inv_s = [], [], [], [], [], [], []
    for j in range(n_blocks):
        i = start + 3 * j
        if not (YOLOV3_SPEC[i][0] == "conv" and YOLOV3_SPEC[i][2] == 1
                and YOLOV3_SPEC[i + 1][0] == "conv" and YOLOV3_SPEC[i + 1][2] == 3
                and YOLOV3_SPEC[i + 2][0] == "shortcut"):
            raise ValueError(f"spec index {i} does not start a residual block")
        l1, l3 = f"conv_{i}", f"conv_{i + 1}"
        if f"{l1}.qkernel" not in qparams or f"{l3}.qkernel" not in qparams:
            raise ValueError(
                f"fused stage needs whole-tower int8; conv_{i}/conv_{i + 1} "
                "are not quantized")
        k1, k3 = arr(f"{l1}.qkernel"), arr(f"{l3}.qkernel")  # (1,1,C,C/2), (3,3,C/2,C)
        qk1.append(k1[0, 0])
        qk3.append(k3.reshape(-1, k3.shape[-1]))
        s1, s3 = float(arr(f"{l1}.in_scale")), float(arr(f"{l3}.in_scale"))
        d1.append(np.asarray(arr(f"{l1}.w_scale"), np.float32) * s1)
        b1.append(np.asarray(arr(f"{l1}.q_bias_leaky"), np.float32))
        d3.append(np.asarray(arr(f"{l3}.w_scale"), np.float32) * s3)
        b3.append(np.asarray(arr(f"{l3}.q_bias_leaky"), np.float32))
        inv_s.append([1.0 / s1, 1.0 / s3])
    return {
        "qk1": np.stack(qk1), "qk3": np.stack(qk3),
        "d1": np.stack(d1).astype(np.float32)[:, None, :],
        "b1": np.stack(b1).astype(np.float32)[:, None, :],
        "d3": np.stack(d3).astype(np.float32)[:, None, :],
        "b3": np.stack(b3).astype(np.float32)[:, None, :],
        "inv_s": np.asarray(inv_s, np.float32),
    }


def _pack_tensors(pack: Dict, device) -> Dict[str, torch.Tensor]:
    """The pack's arrays as tensors on `device` (no copy for those already
    there)."""
    return {k: torch.as_tensor(v, device=device) for k, v in pack.items()
            if k in ("qk1", "qk3", "d1", "b1", "d3", "b3", "inv_s")}


def _quant(x: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * inv_s), -127.0, 127.0)


def fused_residual_stage_plain(h: torch.Tensor, pack: Dict, n_blocks: int) -> torch.Tensor:
    """The plain version of K5 on any device: h (B, H, W, C) bf16/f32 ->
    the same shape and dtype. Quantized values are held as float64 integers,
    so the s8 products and their int32 sums are exact."""
    p = _pack_tensors(pack, h.device)
    B, H, W, C = h.shape
    half = C // 2
    hs = h.to(torch.float32).reshape(B * H * W, C)
    for j in range(n_blocks):
        q = _quant(hs, p["inv_s"][j, 0]).to(torch.float64)
        a = (q @ p["qk1"][j].to(torch.float64)).to(torch.float32)
        a = leaky(a * p["d1"][j, 0] + p["b1"][j, 0])
        aq = _quant(a, p["inv_s"][j, 1]).to(torch.float64).reshape(B, H, W, half)
        pad = torch.nn.functional.pad(aq, (0, 0, 1, 1, 1, 1))
        k3 = p["qk3"][j].to(torch.float64)
        acc = torch.zeros((B * H * W, C), dtype=torch.float64, device=h.device)
        for ky in range(3):
            for kx in range(3):
                t = ky * 3 + kx
                acc += pad[:, ky:ky + H, kx:kx + W, :].reshape(B * H * W, half) @ \
                    k3[t * half:(t + 1) * half]
        y = leaky(acc.to(torch.float32) * p["d3"][j, 0] + p["b3"][j, 0])
        hs = hs + y
    return hs.reshape(B, H, W, C).to(h.dtype)


def _lib():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("yolo_stage")
    if lib.yolo_stage_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yolo_stage_launch.argtypes = [
            p, i, p, i,  # h, in_bf16, out, out_bf16
            p, p, p,  # scratch: f32 stream, q (M, C) s8, aq (M, C/2) s8
            p, p, p,  # qk1t (n, C/2, C), d1, b1
            p, p, p,  # qk3t (n, C, 9*C/2), d3, b3
            p, i,  # inv_s (n, 2) f32 in host memory, n_blocks
            i, i, i, i,  # B, H, W, C
            p,  # stream
        ]
        lib.yolo_stage_launch.restype = ctypes.c_int
        lib.yolo_stage_error_string.argtypes = [ctypes.c_int]
        lib.yolo_stage_error_string.restype = ctypes.c_char_p
    return lib


def device_pack(pack: Dict, device) -> Dict[str, torch.Tensor]:
    """pack_yolo_stage's arrays on `device` (the plain version takes them as
    they are), plus the int8 weights transposed once into the kernel's
    K-contiguous layout, qk1t (n, C/2, C) and qk3t (n, C, 9*C/2), and the
    host copy of inv_s that the launches read."""
    p = _pack_tensors(pack, device)
    return dict(p, qk1t=p["qk1"].transpose(1, 2).contiguous(),
                qk3t=p["qk3"].transpose(1, 2).contiguous(),
                inv_s_host=np.ascontiguousarray(p["inv_s"].cpu().numpy(), np.float32))


def fused_residual_stage_cuda(h: torch.Tensor, pack: Dict, n_blocks: int) -> torch.Tensor:
    """K5 on the card: h (B, H, W, C) bf16/f32, contiguous, on a CUDA device
    -> a new tensor of the same shape and dtype. `pack` is pack_yolo_stage's
    output or device_pack's (reused across calls). C must be a multiple of
    128. Raises on any input the kernel does not take and on a refused
    launch."""
    if h.device.type != "cuda":
        raise ValueError(f"fused_residual_stage_cuda needs a CUDA tensor, got {h.device}")
    if h.dtype not in (torch.float32, torch.bfloat16) or h.dim() != 4:
        raise ValueError(f"h must be (B, H, W, C) f32/bf16, got {tuple(h.shape)} {h.dtype}")
    if not h.is_contiguous():
        raise ValueError("fused_residual_stage_cuda needs a contiguous h")
    B, H, W, C = (int(s) for s in h.shape)
    if C % 128:
        raise ValueError(f"channels must be a multiple of 128, got {C}")
    p = pack if "qk1t" in pack else device_pack(pack, h.device)
    if (n_blocks < 1 or tuple(p["qk1t"].shape) != (n_blocks, C // 2, C)
            or p["qk1t"].device != h.device):
        raise ValueError(f"pack does not hold {n_blocks} blocks of C = {C} on {h.device}")
    out = torch.empty_like(h)
    if B * H * W == 0:
        return out
    # The f32 stream between blocks, the int8 input of each block's 1x1 (q)
    # and of its 3x3 (aq).
    M = B * H * W
    stream = (torch.empty((M, C), dtype=torch.float32, device=h.device)
              if n_blocks > 1 else None)
    q = torch.empty((M, C), dtype=torch.int8, device=h.device)
    aq = torch.empty((M, C // 2), dtype=torch.int8, device=h.device)
    inv_s = p["inv_s_host"]
    lib = _lib()
    with torch.cuda.device(h.device):
        code = lib.yolo_stage_launch(
            h.data_ptr(), int(h.dtype == torch.bfloat16), out.data_ptr(),
            int(out.dtype == torch.bfloat16), None if stream is None else stream.data_ptr(),
            q.data_ptr(), aq.data_ptr(),
            p["qk1t"].data_ptr(), p["d1"].data_ptr(), p["b1"].data_ptr(),
            p["qk3t"].data_ptr(), p["d3"].data_ptr(), p["b3"].data_ptr(),
            inv_s.ctypes.data, n_blocks, B, H, W, C,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"yolo_stage kernel launch failed: {lib.yolo_stage_error_string(code).decode()}")
    # The quantize launch, then each block's 1x1 and 3x3 kernels.
    fused_residual_stage_cuda.launches += 2 * n_blocks + 1
    return out


fused_residual_stage_cuda.launches = 0


def fused_residual_stage(h: torch.Tensor, pack: Dict, n_blocks: int) -> torch.Tensor:
    """K5 on a CUDA device, its plain version on the CPU; any other device
    raises. There is no fallback from the kernel to the plain version."""
    if h.device.type == "cuda":
        return fused_residual_stage_cuda(h.contiguous(), pack, n_blocks)
    if h.device.type == "cpu":
        return fused_residual_stage_plain(h, pack, n_blocks)
    raise ValueError(f"fused_residual_stage has no path for device {h.device}")
