"""BN-folded / int8-PTQ ResNet-50 backbone for SPIN's --spin_int8 path.

Port of the JAX package's models/resnet_int8.py. The strict SPIN backbone is
the nn.Module in models/resnet.py; this module re-expresses the same network
as a function over a flat parameter dict, so BatchNorm folds into the conv
weights once at load and the convs can run int8 (ops/qconv). A wholly
folded f32 backbone (no int8 layer) runs each conv bias-free and then one
epilogue pass (ops/epilogue.conv_epilogue): the strict-f32 HMR on the card
(pipeline.PoseEstimator), NCHW throughout there.

Pipeline: fold_resnet50_params(hmr_state_dict) -> calibrate_resnet50(folded,
sample_crops) -> quantize_resnet50(folded, scales) [-> bias_correct_resnet50]
-> resnet50_forward(q, x). The dicts keep the JAX package's names and
layouts ({conv name: {kernel HWIO, bias}} folded, {qkernel HWIO int8,
w_scale, in_scale, bias} quantized), so models/convert.resnet_params_from_jax
hands the JAX package's dicts over unchanged. prepare_resnet50 derives what
the device runs (GEMM matrices of the int8 convs, OIHW float weights) once.

Reference network: torchvision ResNet-50 v1.5 inside SPIN's hmr (reference
lib/core/base.py:81-84).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from poserisk_release_tpu_torch.models.convert import fold_bn_kernel_bias
from poserisk_release_tpu_torch.models.resnet import resnet50_walk
from poserisk_release_tpu_torch.ops import epilogue
from poserisk_release_tpu_torch.ops.qconv import (
    QConv2d,
    act_scale,
    layer_arrays,
    quantize_kernel,
)

BN_EPS = 1e-5
STAGES = ((1, 3, 64), (2, 4, 128), (3, 6, 256), (4, 3, 512))


def _np(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def fold_resnet50_params(state_dict: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's HMR (or bare ResNet50) state_dict -> {conv_name: {kernel
    HWIO, bias}} with inference BatchNorm folded in (f32, the JAX package's
    arithmetic: models/convert.fold_bn_kernel_bias)."""

    def grab(conv: str, bn: str):
        w, b = fold_bn_kernel_bias(*(_np(state_dict[f"{p}.{k}"]) for p, k in (
            (conv, "weight"), (bn, "weight"), (bn, "bias"), (bn, "running_mean"),
            (bn, "running_var"))), eps=BN_EPS)
        return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
                "bias": np.asarray(b, np.float32)}

    folded = {"conv1": grab("conv1", "bn1")}
    for stage, n_blocks, _planes in STAGES:
        for block in range(n_blocks):
            base, mod = f"layer{stage}_{block}", f"layer{stage}.{block}"
            for i in (1, 2, 3):
                folded[f"{base}.conv{i}"] = grab(f"{mod}.conv{i}", f"{mod}.bn{i}")
            if block == 0:
                folded[f"{base}.downsample"] = grab(f"{mod}.downsample.0",
                                                    f"{mod}.downsample.1")
    return folded


def _conv_geometry() -> Dict[str, tuple]:
    """conv name -> (stride, pad), in resnet50_forward's traversal order."""
    geo = {"conv1": (2, 3)}
    for stage, n_blocks, _planes in STAGES:
        for block in range(n_blocks):
            stride = 2 if (stage > 1 and block == 0) else 1
            base = f"layer{stage}_{block}"
            geo[f"{base}.conv1"] = (1, 0)
            geo[f"{base}.conv2"] = (stride, 1)
            geo[f"{base}.conv3"] = (1, 0)
            if block == 0:
                geo[f"{base}.downsample"] = (stride, 0)
    return geo


class _FloatConv:
    """A folded float conv: conv in the compute dtype, then + bias."""

    def __init__(self, kernel_hwio, bias, stride: int, pad: int, device):
        self.weight = torch.as_tensor(np.ascontiguousarray(
            np.transpose(np.asarray(kernel_hwio, np.float32), (3, 2, 0, 1))), device=device)
        self.bias = torch.as_tensor(np.asarray(bias, np.float32), device=device)
        self.stride, self.pad = stride, pad

    def __call__(self, x: torch.Tensor, compute_dtype: torch.dtype, pad=None) -> torch.Tensor:
        """pad: the (rows, columns) padding in place of the layer's own."""
        y = F.conv2d(x.to(compute_dtype), self.weight.to(compute_dtype), stride=self.stride,
                     padding=self.pad if pad is None else pad)
        return y + self.bias.to(compute_dtype)[None, :, None, None]

    def fused(self, x: torch.Tensor, pad, relu: bool,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
        """f32: the conv without its bias (F.conv2d would add it in a kernel
        of its own), then one in-place epilogue pass: + bias, + residual,
        ReLU where asked (resnet50_walk's epilogue contract)."""
        return epilogue.conv_epilogue(F.conv2d(x, self.weight, None, self.stride, pad),
                                      self.bias, residual, relu)


def prepare_resnet50(params: Dict, device) -> Dict[str, object]:
    """A folded or quantized dict -> {conv name: callable(x NCHW, compute
    dtype)} on `device`: QConv2d for the int8 convs (GEMM matrices derived
    here, once), float convs otherwise."""
    out: Dict[str, object] = {}
    for name, (stride, pad) in _conv_geometry().items():
        layer = layer_arrays(params[name])
        if "qkernel" in layer:
            out[name] = QConv2d(layer["qkernel"], layer["w_scale"], layer["in_scale"],
                                layer["bias"], stride, pad, act=None).to(device)
        else:
            out[name] = _FloatConv(layer["kernel"], layer["bias"], stride, pad, device)
    out["__prepared__"] = True
    return out


def resnet50_forward(params: Dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
                     _record: Optional[Dict[str, torch.Tensor]] = None,
                     rows=None) -> torch.Tensor:
    """(B, 224, 224, 3) [0, 1] NHWC -> (B, 2048) pooled features (f32). The
    same math as models/resnet.ResNet50 with inference BN folded into the
    convs; layers carrying 'qkernel' run int8. `params` is a folded or
    quantized dict, or prepare_resnet50's output (reused across calls).
    rows: this rank's crop rows under the spatial axis (models/resnet.
    resnet50_walk)."""
    layers = params if "__prepared__" in params else prepare_resnet50(params, x.device)
    # A wholly float backbone in f32 (the strict HMR on the card, the
    # calibration walk) takes one epilogue pass a conv for its bias, the
    # block's identity and the ReLU; int8 layers and other dtypes keep the
    # walk's own add and ReLU.
    fused = compute_dtype == torch.float32 and all(
        isinstance(layer, _FloatConv) for key, layer in layers.items() if key != "__prepared__")

    def conv(name, t, stride, padding, relu=False, residual=None):
        key = name.replace(".", "_", 1) if name.startswith("layer") else name
        if _record is not None:
            _record[key] = t.float()
        if fused:
            return layers[key].fused(t, padding, relu, residual)
        return layers[key](t, compute_dtype, padding)

    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last in memory
    if fused:
        x = x.to(compute_dtype)
        if x.is_cuda:
            # The one layout copy: cuDNN's strict-f32 convs are NCHW
            # kernels, which on channels-last tensors transpose each conv's
            # input and output, and the epilogue kernel reads NCHW-contiguous
            # outputs. The CPU keeps the view, so its numbers stay those of
            # the walk's own add and ReLU, bit for bit.
            x = x.contiguous()
    return resnet50_walk(x, conv, rows=rows, epilogue=fused)


def calibrate_resnet50(folded: Dict, crops: torch.Tensor,
                       percentile: float | None = None) -> Dict[str, float]:
    """Per-conv input activation scales over a calibration batch (an f32
    walk): absmax, or with `percentile` (99.9-99.999) that percentile of |x|
    with linear interpolation (saturating PTQ, for trained checkpoints with
    outlier channels). torch.quantile takes at most 2^24 elements, so
    calibrate on <= 8 crops, as the pipeline does."""
    record: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        resnet50_forward(folded, crops, torch.float32, _record=record)
        if percentile is None:
            vals = [record[k].abs().amax() for k in record]
        else:
            vals = [torch.quantile(record[k].abs().flatten(), percentile / 100.0,
                                   interpolation="linear") for k in record]
    return dict(zip(record, torch.stack(vals).cpu().tolist()))


def bias_correct_resnet50(folded: Dict, qparams: Dict, crops: torch.Tensor) -> Dict:
    """Fold the expected per-channel quantization error E[conv_f32(x) -
    conv_int8(x)] (estimated on the calibration batch, at the float
    activations, pre-ReLU) into each quantized conv's bias. Returns a new
    qparams dict."""
    record: Dict[str, torch.Tensor] = {}
    geo = _conv_geometry()
    out = dict(qparams)
    with torch.no_grad():
        resnet50_forward(folded, crops, torch.float32, _record=record)
        for name, x_f in record.items():
            layer = layer_arrays(qparams[name])
            if "qkernel" not in layer:
                continue  # a float layer under a min_stage boundary: no error
            stride, pad = geo[name]
            f = layer_arrays(folded[name])
            y_f = _FloatConv(f["kernel"], f["bias"], stride, pad, x_f.device)(x_f, torch.float32)
            y_q = QConv2d(layer["qkernel"], layer["w_scale"], layer["in_scale"], layer["bias"],
                          stride, pad, act=None).to(x_f.device)(x_f, torch.float32)
            corr = (y_f - y_q).mean(dim=(0, 2, 3)).cpu().numpy()
            out[name] = dict(layer, bias=layer["bias"] + corr.astype(np.float32))
    return out


def _conv_stage(name: str) -> int:
    """Stage of a folded-conv name: the conv1 stem is 0, layer{s}_* is s."""
    return int(name[5]) if name.startswith("layer") else 0


def quantize_resnet50(folded: Dict, act_absmax: Dict[str, float],
                      min_stage: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Folded params -> int8 PTQ params: symmetric per-output-channel
    weights and calibrated per-tensor activations, as the detector. Only
    convs in residual stage >= min_stage are quantized (the stem is stage
    0); shallower layers keep the float path."""
    if min_stage > max(_conv_stage(n) for n in folded):
        raise ValueError(
            f"int8_min_stage={min_stage} quantizes zero convs "
            "(deepest ResNet-50 stage is 4)")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, layer in folded.items():
        layer = layer_arrays(layer)
        if _conv_stage(name) < min_stage:
            out[name] = dict(layer)
            continue
        qkernel, w_scale = quantize_kernel(layer["kernel"])
        out[name] = {"qkernel": qkernel, "w_scale": w_scale,
                     "in_scale": np.asarray(act_scale(act_absmax[name])),
                     "bias": np.asarray(layer["bias"], np.float32)}
    return out
