"""Person detectors of the port: YOLOv3 (float or int8) and the deterministic stub.

Port of the JAX package's models/detector.py. The
reference delegates detection to the multi-person-tracker's YOLOv3 (416
canvas, threshold 0.1); here the 75-conv graph is the same data-driven spec
of the canonical yolov3.cfg (Darknet-53 + three detection heads), walked by
an nn.Module in NCHW (channels-last memory) with the letterbox on the device
(ops/crop.letterbox_device*: kernel K2 on the card), the box decode on the
device, and the score filter + NMS on the host per frame.

Weights: the standard `yolov3.weights` darknet binary, or with no file a
deterministic random init with the JAX package's draws. The port's weight
format is the module's own state_dict (conv weights OIHW); the bridge to
the JAX package's params tree is models/convert.yolo_params_to_state_dict.

Detections are (x1, y1, x2, y2, score) in ORIGINAL frame coordinates for
the person class only, what SORT consumes.

int8 post-training quantization (the JAX package's models/detector.py:
206-434): calibrate_yolo_activations records each conv input's absmax in
the same walk that detects, quantize_yolo_params turns the folded weights
into symmetric per-output-channel int8 with static per-tensor activation
scales (whole tower by default: 72 of 75 convs, the three heads stay
float), and a quantized YoloV3 runs its int8 convs through ops/qconv and
every other op in bfloat16, as the JAX package's compute_dtype bf16 does.
The quantized weights keep the JAX package's names and its HWIO `qkernel`
layout under the conv's prefix (conv_{i}.qkernel, .w_scale, .in_scale,
.q_bias_leaky, .out_scale); the GEMM matrices are derived at load.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from poserisk_release_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Architecture spec (canonical yolov3.cfg), the JAX package's YOLOV3_SPEC.
# Each entry: ("conv", filters, ksize, stride, batch_norm) | ("shortcut", from)
#           | ("route", [idxs]) | ("upsample",) | ("yolo", anchor_set)
# Indices in route/shortcut refer to entry positions in this list.
# ---------------------------------------------------------------------------
def _residual(filters: int, n: int) -> List[tuple]:
    out = []
    for _ in range(n):
        out.append(("conv", filters // 2, 1, 1, True))
        out.append(("conv", filters, 3, 1, True))
        out.append(("shortcut", -3))
    return out


YOLOV3_SPEC: List[tuple] = [
    ("conv", 32, 3, 1, True),
    ("conv", 64, 3, 2, True),
    *_residual(64, 1),
    ("conv", 128, 3, 2, True),
    *_residual(128, 2),
    ("conv", 256, 3, 2, True),
    *_residual(256, 8),  # ends at spec index 36 (route point)
    ("conv", 512, 3, 2, True),
    *_residual(512, 8),  # ends at spec index 61 (route point)
    ("conv", 1024, 3, 2, True),
    *_residual(1024, 4),
    # Head 1 (stride 32)
    ("conv", 512, 1, 1, True),
    ("conv", 1024, 3, 1, True),
    ("conv", 512, 1, 1, True),
    ("conv", 1024, 3, 1, True),
    ("conv", 512, 1, 1, True),  # spec index 79: branch point
    ("conv", 1024, 3, 1, True),
    ("conv", 255, 1, 1, False),
    ("yolo", 2),
    # Head 2 (stride 16)
    ("route", [79]),
    ("conv", 256, 1, 1, True),
    ("upsample",),
    ("route", [-1, 61]),
    ("conv", 256, 1, 1, True),
    ("conv", 512, 3, 1, True),
    ("conv", 256, 1, 1, True),
    ("conv", 512, 3, 1, True),
    ("conv", 256, 1, 1, True),  # branch point (spec index 91)
    ("conv", 512, 3, 1, True),
    ("conv", 255, 1, 1, False),
    ("yolo", 1),
    # Head 3 (stride 8)
    ("route", [91]),
    ("conv", 128, 1, 1, True),
    ("upsample",),
    ("route", [-1, 36]),
    ("conv", 128, 1, 1, True),
    ("conv", 256, 3, 1, True),
    ("conv", 128, 1, 1, True),
    ("conv", 256, 3, 1, True),
    ("conv", 128, 1, 1, True),
    ("conv", 256, 3, 1, True),
    ("conv", 255, 1, 1, False),
    ("yolo", 0),
]

ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),  # stride 8
    ((30, 61), (62, 45), (59, 119)),  # stride 16
    ((116, 90), (156, 198), (373, 326)),  # stride 32
)
NUM_CLASSES = 80
PERSON_CLASS = 0
BN_EPS = 1e-5
LEAKY_SLOPE = 0.1
_BN_KEYS = ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def conv_indices() -> List[int]:
    """Spec positions that are conv layers, in darknet weight-file order."""
    return [i for i, e in enumerate(YOLOV3_SPEC) if e[0] == "conv"]


def _conv_in_channels() -> Dict[int, int]:
    """{spec index: input channels} of every conv."""
    in_ch, channels, out = 3, [], {}
    for i, entry in enumerate(YOLOV3_SPEC):
        if entry[0] == "conv":
            out[i] = in_ch
            in_ch = entry[1]
        elif entry[0] == "route":
            in_ch = sum(channels[r if r >= 0 else i + r] for r in entry[1])
        channels.append(in_ch)
    return out


def _saved_outputs() -> set:
    """Spec indices whose output a later shortcut or route reads."""
    saved = set()
    for i, entry in enumerate(YOLOV3_SPEC):
        if entry[0] == "shortcut":
            saved.add(i + entry[1])
        elif entry[0] == "route":
            saved.update(r if r >= 0 else i + r for r in entry[1])
    return saved


def init_yolo_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random init (He-style, unfolded BN at identity) as a
    state_dict of numpy arrays: the JAX package's draws, in its order
    (kernels drawn HWIO, stored OIHW)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    for i, in_ch in _conv_in_channels().items():
        _, filters, ksize, _stride, bn = YOLOV3_SPEC[i]
        fan_in = in_ch * ksize * ksize
        kernel = rng.normal(0, np.sqrt(2.0 / fan_in), (ksize, ksize, in_ch, filters))
        sd[f"conv_{i}.conv.weight"] = np.ascontiguousarray(
            np.transpose(kernel.astype(np.float32), (3, 2, 0, 1)))
        if bn:
            sd[f"conv_{i}.bn.weight"] = np.ones(filters, np.float32)
            sd[f"conv_{i}.bn.bias"] = np.zeros(filters, np.float32)
            sd[f"conv_{i}.bn.running_mean"] = np.zeros(filters, np.float32)
            sd[f"conv_{i}.bn.running_var"] = np.ones(filters, np.float32)
        else:
            sd[f"conv_{i}.conv.bias"] = np.zeros(filters, np.float32)
    return sd


def load_darknet_weights(path: str) -> Dict[str, np.ndarray]:
    """Parse the standard darknet binary into a state_dict: a 5-int32
    header, then per conv [bn_bias, bn_scale, bn_mean, bn_var] or
    [conv_bias], then the kernel, which the file holds OIHW (torch's layout)."""
    with open(path, "rb") as f:
        np.fromfile(f, np.int32, 5)  # header (major, minor, revision, seen)
        blob = np.fromfile(f, np.float32)

    sd: Dict[str, np.ndarray] = {}
    ptr = 0
    for i, in_ch in _conv_in_channels().items():
        _, filters, ksize, _stride, bn = YOLOV3_SPEC[i]
        names = (("bn.bias", "bn.weight", "bn.running_mean", "bn.running_var") if bn
                 else ("conv.bias",))
        for name in names:
            sd[f"conv_{i}.{name}"] = blob[ptr:ptr + filters].copy()
            ptr += filters
        n_w = filters * in_ch * ksize * ksize
        sd[f"conv_{i}.conv.weight"] = blob[ptr:ptr + n_w].reshape(
            filters, in_ch, ksize, ksize).copy()
        ptr += n_w
    if ptr != blob.size:
        raise ValueError(f"darknet weight size mismatch: used {ptr} of {blob.size}")
    return sd


def fold_bn_params(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold eval-mode BatchNorm into the conv weights and biases once, at
    load time (models.convert.fold_bn_kernel_bias): every conv then has a
    weight and a bias, and the BN layers carry leaky ReLU alone."""
    from poserisk_release_tpu_torch.models.convert import fold_bn_kernel_bias

    out: Dict[str, np.ndarray] = {}
    for i in conv_indices():
        p = f"conv_{i}."
        if p + "bn.weight" in sd:
            w, b = fold_bn_kernel_bias(*(sd[p + k] for k in ("conv.weight",) + _BN_KEYS),
                                       eps=BN_EPS)
        else:
            w, b = np.asarray(sd[p + "conv.weight"], np.float32), sd[p + "conv.bias"]
        out[p + "conv.weight"] = w
        out[p + "conv.bias"] = np.asarray(b, np.float32)
    return out


# ---------------------------------------------------------------------------
# Post-training int8 quantization (PTQ)
# ---------------------------------------------------------------------------
def is_quantized(sd: Dict) -> bool:
    return any(k.endswith(".qkernel") for k in sd)


def _calibration_walk(model: "YoloV3", letterboxed: torch.Tensor):
    """({conv_name: absmax of its input}, decoded detections) from ONE float
    walk, so the calibrating first call detects each chunk without running
    the tower twice. letterboxed: (B, H, W, 3) in [0, 1]."""
    absmax: Dict[str, torch.Tensor] = {}

    def tap(name: str, v: torch.Tensor) -> None:
        absmax[name] = v.float().abs().amax()

    with torch.no_grad():
        det = model(letterboxed.permute(0, 3, 1, 2).to(model.compute_dtype), tap=tap)
    names = list(absmax)
    values = torch.stack([absmax[n] for n in names]).cpu().tolist()
    return dict(zip(names, values)), det


def calibrate_yolo_activations(model: "YoloV3", letterboxed: torch.Tensor) -> Dict[str, float]:
    """Per-conv input absmax over a calibration batch of letterboxed frames,
    from the float tower's own graph walk (its tap hook), so the scales
    cannot desynchronise from the inference graph. Use merge_absmax to
    accumulate over several batches."""
    return _calibration_walk(model, letterboxed)[0]


def merge_absmax(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Elementwise max of two calibration records (multi-batch calibration)."""
    if not a:
        return dict(b)
    return {k: max(a[k], b[k]) for k in a}


def conv_input_downsample() -> Dict[str, int]:
    """{conv_name: downsample factor of that conv's INPUT} relative to the
    canvas (1 = full resolution, 32 = the deepest grid), from the spec walk;
    independent of the canvas, so the mixed-precision boundary holds for
    square and rect canvases alike."""
    factors: List[int] = []
    f = 1
    out: Dict[str, int] = {}
    for i, entry in enumerate(YOLOV3_SPEC):
        kind = entry[0]
        if kind == "conv":
            out[f"conv_{i}"] = f
            f *= entry[3]
        elif kind == "route":
            f = factors[entry[1][0] if entry[1][0] >= 0 else i + entry[1][0]]
        elif kind == "upsample":
            f //= 2
        factors.append(f)
    return out


def _q8_handoff_convs() -> set:
    """Spec indices of convs whose one consumer is the next conv: they may
    emit that conv's int8 input directly (no shortcut or route reads them)."""
    saved = _saved_outputs()
    return {i for i, entry in enumerate(YOLOV3_SPEC)
            if entry[0] == "conv" and i not in saved and i + 1 < len(YOLOV3_SPEC)
            and YOLOV3_SPEC[i + 1][0] == "conv"}


def quantize_yolo_params(folded: Dict, act_absmax: Dict[str, float], min_downsample: int = 1,
                         q8_handoff: bool = False) -> Dict[str, np.ndarray]:
    """BN-folded state_dict -> int8 PTQ state_dict (the JAX package's
    quantize_yolo_params, value for value).

    Weights: symmetric per-output-channel int8 (scale = absmax / 127 per
    channel), kept HWIO as conv_{i}.qkernel. Activations: symmetric
    per-tensor int8 with the calibrated static scale (conv_{i}.in_scale).
    The three bias-only head convs stay float, as does every conv whose
    input sits below the `min_downsample` factor. q8_handoff: a quantized
    conv whose one consumer is the next quantized conv stores that conv's
    in_scale as conv_{i}.out_scale and emits int8 from its epilogue."""
    from poserisk_release_tpu_torch.ops.qconv import act_scale, quantize_kernel

    if any(k.endswith("bn.weight") for k in folded):
        raise ValueError("int8 PTQ requires BN-folded params (fold_bn=True)")
    ds = conv_input_downsample()
    out: Dict[str, np.ndarray] = {}
    quantized = set()
    for i in conv_indices():
        name = f"conv_{i}"
        weight = np.asarray(_np(folded[f"{name}.conv.weight"]), np.float32)
        bias = np.asarray(_np(folded[f"{name}.conv.bias"]), np.float32)
        if not YOLOV3_SPEC[i][4] or ds[name] < min_downsample:
            out[f"{name}.conv.weight"], out[f"{name}.conv.bias"] = weight, bias
            continue
        quantized.add(i)
        qkernel, w_scale = quantize_kernel(np.transpose(weight, (2, 3, 1, 0)))
        out[f"{name}.qkernel"] = qkernel
        out[f"{name}.w_scale"] = w_scale
        out[f"{name}.in_scale"] = np.asarray(act_scale(act_absmax[name]))
        out[f"{name}.q_bias_leaky"] = bias
    if not quantized:
        raise ValueError(
            f"int8_min_downsample={min_downsample} quantizes zero convs "
            f"(deepest downsample factor in the spec is {max(ds.values())})")
    for i in (_q8_handoff_convs() if q8_handoff else ()):
        if i in quantized and i + 1 in quantized:
            out[f"conv_{i}.out_scale"] = out[f"conv_{i + 1}.in_scale"]
    return out


def bias_correct_yolo(folded: Dict, qparams: Dict, letterboxed: torch.Tensor) -> Dict:
    """Fold the expected per-channel quantization error, E[conv_f32(x) -
    conv_int8(x)] at each quantized conv's float input on the calibration
    batch (pre-bias, pre-leaky), into its q_bias_leaky. Returns a new
    qparams state_dict. Not wired into the int8 path, as in the JAX package
    (its measured effect on random-init weights was neutral)."""
    model = YoloV3.from_state_dict(folded).to(letterboxed.device)
    inputs: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        model(letterboxed.permute(0, 3, 1, 2).float(), tap=inputs.__setitem__)
    out = dict(qparams)
    for name, corr in yolo_bias_corrections(folded, qparams, inputs).items():
        out[f"{name}.q_bias_leaky"] = (np.asarray(_np(qparams[f"{name}.q_bias_leaky"]),
                                                  np.float32) + corr)
    return out


def yolo_bias_corrections(folded: Dict, qparams: Dict,
                          inputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{conv name: mean over the batch and positions of conv_f32(x) -
    conv_int8(x)} for every quantized conv, from its float input x (NCHW)."""
    from poserisk_release_tpu_torch.ops.qconv import int_conv_plain, quantize

    corr = {}
    for i in conv_indices():
        name = f"conv_{i}"
        if f"{name}.qkernel" not in qparams:
            continue
        _, _, ksize, stride, _ = YOLOV3_SPEC[i]
        pad = (ksize - 1) // 2
        x_f = inputs[name].float()
        dev = x_f.device
        with torch.no_grad():
            y_f = F.conv2d(x_f, torch.as_tensor(_np(folded[f"{name}.conv.weight"]), device=dev),
                           stride=stride, padding=pad)
            in_scale = torch.as_tensor(_np(qparams[f"{name}.in_scale"]), device=dev)
            qk = torch.as_tensor(np.ascontiguousarray(
                np.transpose(_np(qparams[f"{name}.qkernel"]), (3, 2, 0, 1))), device=dev)
            y_q = int_conv_plain(quantize(x_f, 1.0 / in_scale), qk, stride, pad).float() * (
                in_scale * torch.as_tensor(_np(qparams[f"{name}.w_scale"]), device=dev)
            )[:, None, None]
            corr[name] = (y_f - y_q).mean(dim=(0, 2, 3)).cpu().numpy().astype(np.float32)
    return corr


def _np(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class ConvBlock(nn.Module):
    """One spec conv, float branches: conv with pad (k-1)//2, then folded
    bias + leaky 0.1, unfolded BN + leaky 0.1, or a plain bias (the heads)."""

    def __init__(self, in_ch: int, filters: int, ksize: int, stride: int, bn: bool,
                 folded: bool):
        super().__init__()
        unfolded = bn and not folded
        self.conv = nn.Conv2d(in_ch, filters, ksize, stride, (ksize - 1) // 2,
                              bias=not unfolded)
        self.bn = nn.BatchNorm2d(filters, eps=BN_EPS) if unfolded else None
        self.leaky = bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.leaky:
            x = F.leaky_relu(x, LEAKY_SLOPE)
        return x


def _decode_head(raw: torch.Tensor, anchor_set: int, stride: int) -> torch.Tensor:
    """raw: (B, 255, gh, gw) NCHW head output -> (B, gh*gw*3, 5)
    [cx, cy, w, h, person_score] in canvas pixels, anchors ordered
    (row, column, anchor) as the JAX package's NHWC decode has them."""
    B, gh, gw = raw.shape[0], raw.shape[2], raw.shape[3]
    # NCHW -> NHWC BEFORE the reshape: the 255 channels are 3 anchors x 85.
    raw = raw.permute(0, 2, 3, 1).to(torch.float32).reshape(B, gh, gw, 3, 5 + NUM_CLASSES)
    xy = torch.sigmoid(raw[..., 0:2])
    wh = raw[..., 2:4]
    obj = torch.sigmoid(raw[..., 4:5])
    cls_person = torch.sigmoid(raw[..., 5 + PERSON_CLASS:6 + PERSON_CLASS])
    gy, gx = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=raw.device),
                            torch.arange(gw, dtype=torch.float32, device=raw.device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]  # x first
    anchors = torch.tensor(ANCHORS[anchor_set], dtype=torch.float32,
                           device=raw.device)[None, None, None]
    cxcy = (xy + grid) * stride
    pwh = torch.exp(torch.clamp(wh, -20.0, 20.0)) * anchors
    out = torch.cat([cxcy, pwh, obj * cls_person], dim=-1)
    return out.reshape(B, gh * gw * 3, 5)


def qconv_block(layer: Dict, i: int):
    """The int8 conv block of spec index i from its quantized layer dict
    (qkernel, w_scale, in_scale, q_bias_leaky[, out_scale])."""
    from poserisk_release_tpu_torch.ops.qconv import QConv2d

    _, _filters, ksize, stride, _bn = YOLOV3_SPEC[i]
    return QConv2d(layer["qkernel"], layer["w_scale"], layer["in_scale"], layer["q_bias_leaky"],
                   stride, (ksize - 1) // 2, "leaky", layer.get("out_scale"))


def quantized_layer(sd: Dict, name: str) -> Dict[str, np.ndarray]:
    """One conv's int8 entries of a quantized state_dict, by their JAX names."""
    return {k.split(".", 1)[1]: _np(v) for k, v in sd.items() if k.startswith(name + ".")}


class YoloV3(nn.Module):
    """The YOLOV3_SPEC graph walk. forward(x (B, 3, H, W)) -> decoded
    (B, anchors, 5) f32; H and W are multiples of 32, not necessarily equal
    (the rect canvas). `folded` selects BN-folded convs (conv bias + leaky)
    over unfolded BatchNorm layers; `quantized` names the convs that are
    int8 (ops/qconv.QConv2d). A quantized tower computes in bfloat16 outside
    its int8 products."""

    def __init__(self, folded: bool = True, quantized: Dict[str, Dict] | None = None):
        super().__init__()
        self.folded = folded
        quantized = quantized or {}
        blocks = {}
        for i, in_ch in _conv_in_channels().items():
            name = f"conv_{i}"
            _, filters, ksize, stride, bn = YOLOV3_SPEC[i]
            if name in quantized:
                blocks[name] = qconv_block(quantized[name], i)
            else:
                blocks[name] = ConvBlock(in_ch, filters, ksize, stride, bn, folded=folded)
        self.blocks = nn.ModuleDict(blocks)
        self.quantized = bool(quantized)
        self._saved = _saved_outputs()

    @property
    def compute_dtype(self) -> torch.dtype:
        """bfloat16 for a quantized tower, else its weights' dtype."""
        return torch.bfloat16 if self.quantized else next(self.parameters()).dtype

    @classmethod
    def from_state_dict(cls, sd: Dict) -> "YoloV3":
        """The module for a state_dict of init_yolo_params /
        load_darknet_weights (unfolded), fold_bn_params (folded) or
        quantize_yolo_params (int8; its float convs are stored in bf16)."""
        quantized: Dict[str, Dict] = {}
        floats = {}
        for k, v in sd.items():
            name, rest = k.split(".", 1)
            if rest in ("qkernel", "w_scale", "in_scale", "q_bias_leaky", "out_scale"):
                quantized.setdefault(name, {})[rest] = _np(v)
            else:
                floats[k] = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        model = cls(folded=not any(k.endswith("bn.weight") for k in sd), quantized=quantized)
        # BatchNorm's num_batches_tracked counters may be absent (numpy
        # weights); every other key must match.
        res = model.blocks.load_state_dict(floats, strict=False)
        bad = list(res.unexpected_keys) + [
            k for k in res.missing_keys
            if not k.endswith("num_batches_tracked") and k.split(".", 1)[0] not in quantized]
        if bad:
            raise KeyError(f"YOLOv3 weights do not match the spec: {bad[:4]}")
        if quantized:
            for block in model.blocks.values():
                if isinstance(block, ConvBlock):
                    block.to(torch.bfloat16)
        return model.eval()

    def heads(self, x: torch.Tensor, tap=None) -> List[tuple]:
        """The raw head outputs [(raw (B, 255, gh, gw), anchor_set), ...] in
        spec order (stride 32, 16, 8). Only outputs a later shortcut or
        route reads are kept alive. tap(conv_name, conv_input), when given,
        sees every conv's input (the PTQ calibration hook)."""
        saved: Dict[int, torch.Tensor] = {}
        out = []
        for i, entry in enumerate(YOLOV3_SPEC):
            kind = entry[0]
            if kind == "conv":
                if tap is not None:
                    tap(f"conv_{i}", x)
                block = self.blocks[f"conv_{i}"]
                x = block(x) if isinstance(block, ConvBlock) else block(x, torch.bfloat16)
            elif kind == "shortcut":
                x = x + saved[i + entry[1]]
            elif kind == "route":
                parts = [saved[r if r >= 0 else i + r] for r in entry[1]]
                x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            elif kind == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "yolo":
                out.append((x, entry[1]))
            if i in self._saved:
                saved[i] = x
        return out

    def forward(self, x: torch.Tensor, tap=None) -> torch.Tensor:
        canvas_h = x.shape[2]
        return torch.cat([_decode_head(raw, anchor_set, canvas_h // raw.shape[2])
                          for raw, anchor_set in self.heads(x, tap)], dim=1)


def yolo_forward(model: YoloV3, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) letterboxed in [0, 1] (the letterbox's NHWC).
    Runs the conv tower in its compute dtype (the weights' dtype: cast a
    float model once, e.g. model.to(torch.bfloat16) for the fast path,
    rather than ~62M weights per call; bf16 for a quantized one) and
    decodes in f32. Returns (B, anchors, 5) [cx, cy, w, h, person_score] in
    canvas pixels."""
    with torch.no_grad():
        return model(images.permute(0, 3, 1, 2).to(model.compute_dtype))


def _topk_select(det: torch.Tensor, k: int) -> torch.Tensor:
    """(B, anchors, 5) -> the k best by score, score-descending, ties by the
    lower anchor index (the order of lax.top_k in the JAX package, which NMS
    determinism rests on): a stable descending sort, not torch.topk, which
    promises no order among ties on CUDA."""
    k = min(k, det.shape[1])
    order = torch.sort(det[..., 4], dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(det, 1, order[..., None].expand(-1, -1, det.shape[2]))


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy IoU NMS; returns kept indices sorted by descending score, ties
    by input order (a stable sort), as the JAX package's nms_xyxy."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return np.array(keep, np.int64)


class YoloDetector:
    """Batched YOLOv3 person detector with the MPT calling convention:
    __call__(frames (N, H, W, 3) uint8) -> per-frame (k, 5) [x1, y1, x2,
    y2, score] arrays.

    rect=True runs the tower on the rectangular canvas
    (ops/crop.rect_canvas_geometry); the default is the square 416 canvas of
    the upstream detector. max_device_dets: the host pulls only the k best
    anchors per frame unless some frame's k-th score still clears the
    threshold or any score is not finite, in which case it pulls them all,
    so results never depend on k (0 disables the cut). On a CUDA device the
    detector turns TF32 off (cuDNN convolutions default to it on Hopper),
    keeping the f32 tower within float rounding of the reference.

    int8=True is the JAX package's PTQ lifecycle: the first call runs the
    float tower while accumulating every conv input's absmax over ALL its
    chunks (a dark opening window alone must not pin the scales) and
    quantizes at its end (an empty first call stays float); calibrate()
    does the same explicitly without detecting; reset_calibration() restores
    the float weights kept on the host at quantization time.
    int8_min_downsample quantizes only convs whose input sits at >= that
    downsample factor. `params` holds the current state_dict (host numpy)."""

    def __init__(self, params: Dict, img_size: int = 416, detection_threshold: float = 0.1,
                 nms_threshold: float = 0.45, batch_size: int = 8, rect: bool = False,
                 max_device_dets: int = 256, int8: bool = False, int8_min_downsample: int = 1,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.img_size = int(img_size)
        self.detection_threshold = float(detection_threshold)
        self.nms_threshold = float(nms_threshold)
        self.batch_size = int(batch_size)
        self.rect = bool(rect)
        self.max_device_dets = int(max_device_dets)
        self.int8 = bool(int8)
        self.int8_min_downsample = int(int8_min_downsample)
        self._float_params = None
        self._load(params)

    def _load(self, params: Dict) -> None:
        self.params = {k: _np(v) for k, v in params.items()}
        self.model = YoloV3.from_state_dict(self.params).to(
            self.device, memory_format=torch.channels_last)

    @property
    def needs_calibration(self) -> bool:
        """True when int8 is requested and no activation scales are set yet."""
        return self.int8 and not is_quantized(self.params)

    def _check_foldable(self) -> None:
        if any(k.endswith("bn.weight") for k in self.params):
            raise ValueError("int8 PTQ requires BN-folded params (fold_bn=True)")

    def _quantize(self, absmax: Dict[str, float]) -> None:
        """Keep the float weights on the host (once), then switch to int8."""
        if self._float_params is None:
            self._float_params = self.params
        self._load(quantize_yolo_params(self.params, absmax,
                                        min_downsample=self.int8_min_downsample))

    def reset_calibration(self) -> None:
        """Drop the int8 activation scales: restore the float weights saved at
        quantization time, so the next call (or calibrate()) re-derives the
        scales from fresh frames. The per-video hook of
        DETECTOR.recalibrate_per_video."""
        if self.int8 and self._float_params is not None and is_quantized(self.params):
            self._load(self._float_params)

    def calibrate(self, frames_rgb: np.ndarray) -> None:
        """Explicit int8 calibration on representative frames: per-conv
        absmax over batch_size chunks, then quantize. No-op once quantized."""
        if not self.int8:
            raise ValueError("calibrate() requires int8=True")
        if is_quantized(self.params):
            return
        self._check_foldable()
        absmax: Dict[str, float] = {}
        for start in range(0, frames_rgb.shape[0], self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                frames_rgb[start:start + self.batch_size])).to(self.device)
            absmax = merge_absmax(absmax, calibrate_yolo_activations(
                self.model, self.letterbox(chunk)))
        self._quantize(absmax)

    @classmethod
    def from_weights(cls, weights_path: str | None, fold_bn: bool = True,
                     **kwargs) -> "YoloDetector":
        """From a darknet file, or the seed-0 random init when it is missing
        (as the JAX package does)."""
        if weights_path and osp.isfile(weights_path):
            params = load_darknet_weights(weights_path)
        else:
            params = init_yolo_params()
        if fold_bn:
            params = fold_bn_params(params)
        return cls(params=params, **kwargs)

    def _pull_detections(self, det_dev: torch.Tensor) -> np.ndarray:
        """Device decode -> host array through the top-k cut, with the
        truncation guard and the non-finite full pull."""
        if self.max_device_dets:
            raw = _topk_select(det_dev, self.max_device_dets).cpu().numpy()
            if raw.shape[1] >= det_dev.shape[1]:
                return raw  # k covered every anchor: raw is the full set
            scores = raw[..., 4]
            if np.isfinite(scores).all() and not (
                scores[:, -1] > self.detection_threshold
            ).any():
                return raw
        return det_dev.cpu().numpy()

    def letterbox(self, frames_u8: torch.Tensor) -> torch.Tensor:
        from poserisk_release_tpu_torch.ops.crop import letterbox_device, letterbox_device_rect

        fn = letterbox_device_rect if self.rect else letterbox_device
        return fn(frames_u8, self.img_size)

    def __call__(self, frames_rgb: np.ndarray) -> List[np.ndarray]:
        from poserisk_release_tpu_torch.ops.crop import canvas_geometry

        N, H, W = frames_rgb.shape[0], frames_rgb.shape[1], frames_rgb.shape[2]
        _, _, new_w, new_h, pad_x, pad_y = canvas_geometry(H, W, self.img_size, self.rect)
        # Exact inverse of the letterbox: integer pads + per-axis content
        # scale (the rounded content size makes sx != sy by up to half a
        # pixel; using both keeps the unmap exact).
        sx, sy = new_w / W, new_h / H
        calibrating = self.needs_calibration
        if calibrating:
            self._check_foldable()
        absmax: Dict[str, float] = {}
        results: List[np.ndarray] = []
        for start in range(0, N, self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                frames_rgb[start:start + self.batch_size])).to(self.device)
            if calibrating:
                vals, det_dev = _calibration_walk(self.model, self.letterbox(chunk))
                absmax = merge_absmax(absmax, vals)
            else:
                det_dev = yolo_forward(self.model, self.letterbox(chunk))
            raw = self._pull_detections(det_dev)
            for det in raw:
                det = det[det[:, 4] > self.detection_threshold]
                if det.size == 0:
                    results.append(np.zeros((0, 5), np.float32))
                    continue
                # Exact inverse of cv2's half-pixel mapping for centres;
                # sizes scale linearly.
                cx = (det[:, 0] - pad_x + 0.5) / sx - 0.5
                cy = (det[:, 1] - pad_y + 0.5) / sy - 0.5
                w = det[:, 2] / sx
                h = det[:, 3] / sy
                boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, W - 1)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, H - 1)
                # Drop boxes degenerated by the frame clip (zero-area boxes
                # poison SORT's aspect-ratio Kalman state with NaNs).
                ok = ((boxes[:, 2] - boxes[:, 0]) >= 2) & ((boxes[:, 3] - boxes[:, 1]) >= 2)
                boxes, det = boxes[ok], det[ok]
                if boxes.shape[0] == 0:
                    results.append(np.zeros((0, 5), np.float32))
                    continue
                keep = nms_xyxy(boxes, det[:, 4], self.nms_threshold)
                results.append(
                    np.concatenate([boxes[keep], det[keep, 4:5]], axis=1).astype(np.float32))
        if calibrating and absmax:
            # An empty call gathered no statistics: stay float and let the
            # next non-empty call calibrate.
            self._quantize(absmax)
        return results


class StubDetector:
    """Deterministic detector for weight-free pipelines: the scripted
    per-frame boxes when given (each reshaped to (k, 5) float32), else one
    fixed box per frame, [0.25 W, 0.1 H, 0.75 W, 0.95 H] with score 0.99
    (x1, y1, x2, y2, score), as the JAX package's StubDetector."""

    def __init__(self, scripted: List[np.ndarray] | None = None):
        self.scripted = scripted

    def __call__(self, frames_rgb: np.ndarray) -> List[np.ndarray]:
        if self.scripted is not None:
            return [np.asarray(b, np.float32).reshape(-1, 5) for b in self.scripted]
        N, H, W = frames_rgb.shape[0], frames_rgb.shape[1], frames_rgb.shape[2]
        box = np.array([[W * 0.25, H * 0.1, W * 0.75, H * 0.95, 0.99]], np.float32)
        return [box.copy() for _ in range(N)]
