"""Person detectors of the port: YOLOv3 (float) and the deterministic stub.

Port of the JAX package's models/detector.py, float branches only. The
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
the person class only, what SORT consumes. The int8 detector (and its
calibration) is a later slice of the port (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


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


class YoloV3(nn.Module):
    """The YOLOV3_SPEC graph walk. forward(x (B, 3, H, W)) -> decoded
    (B, anchors, 5) f32; H and W are multiples of 32, not necessarily equal
    (the rect canvas). `folded` selects BN-folded convs (conv bias + leaky)
    over unfolded BatchNorm layers."""

    def __init__(self, folded: bool = True):
        super().__init__()
        self.folded = folded
        self.blocks = nn.ModuleDict({
            f"conv_{i}": ConvBlock(in_ch, *YOLOV3_SPEC[i][1:], folded=folded)
            for i, in_ch in _conv_in_channels().items()})
        self._saved = _saved_outputs()

    @classmethod
    def from_state_dict(cls, sd: Dict) -> "YoloV3":
        """The module for a state_dict of init_yolo_params /
        load_darknet_weights (unfolded) or fold_bn_params (folded)."""
        model = cls(folded=not any(k.endswith("bn.weight") for k in sd))
        sd = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
              for k, v in sd.items()}
        # BatchNorm's num_batches_tracked counters may be absent (numpy
        # weights); every other key must match.
        res = model.blocks.load_state_dict(sd, strict=False)
        bad = list(res.unexpected_keys) + [
            k for k in res.missing_keys if not k.endswith("num_batches_tracked")]
        if bad:
            raise KeyError(f"YOLOv3 weights do not match the spec: {bad[:4]}")
        return model.eval()

    def heads(self, x: torch.Tensor) -> List[tuple]:
        """The raw head outputs [(raw (B, 255, gh, gw), anchor_set), ...] in
        spec order (stride 32, 16, 8). Only outputs a later shortcut or
        route reads are kept alive."""
        saved: Dict[int, torch.Tensor] = {}
        out = []
        for i, entry in enumerate(YOLOV3_SPEC):
            kind = entry[0]
            if kind == "conv":
                x = self.blocks[f"conv_{i}"](x)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        canvas_h = x.shape[2]
        return torch.cat([_decode_head(raw, anchor_set, canvas_h // raw.shape[2])
                          for raw, anchor_set in self.heads(x)], dim=1)


def yolo_forward(model: YoloV3, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) letterboxed in [0, 1] (the letterbox's NHWC).
    Runs the conv tower in the dtype of the model's weights (cast the model
    once, e.g. model.to(torch.bfloat16) for the fast path, rather than ~62M
    weights per call) and decodes in f32. Returns (B, anchors, 5)
    [cx, cy, w, h, person_score] in canvas pixels."""
    with torch.no_grad():
        return model(images.permute(0, 3, 1, 2).to(next(model.parameters()).dtype))


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


INT8_LATER = ("the int8 detector is a later slice of the port "
              "(ROADMAP Queue 1 item 14)")


class YoloDetector:
    """Batched float YOLOv3 person detector with the MPT calling convention:
    __call__(frames (N, H, W, 3) uint8) -> per-frame (k, 5) [x1, y1, x2,
    y2, score] arrays.

    rect=True runs the tower on the rectangular canvas
    (ops/crop.rect_canvas_geometry); the default is the square 416 canvas of
    the upstream detector. max_device_dets: the host pulls only the k best
    anchors per frame unless some frame's k-th score still clears the
    threshold or any score is not finite, in which case it pulls them all,
    so results never depend on k (0 disables the cut). On a CUDA device the
    detector turns TF32 off (cuDNN convolutions default to it on Hopper),
    keeping the f32 tower within float rounding of the reference."""

    def __init__(self, params: Dict, img_size: int = 416, detection_threshold: float = 0.1,
                 nms_threshold: float = 0.45, batch_size: int = 8, rect: bool = False,
                 max_device_dets: int = 256, int8: bool = False, device=None):
        if int8:
            raise NotImplementedError(INT8_LATER)
        from poserisk_release_tpu_torch.pipeline import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = YoloV3.from_state_dict(params).to(
            self.device, memory_format=torch.channels_last)
        self.img_size = int(img_size)
        self.detection_threshold = float(detection_threshold)
        self.nms_threshold = float(nms_threshold)
        self.batch_size = int(batch_size)
        self.rect = bool(rect)
        self.max_device_dets = int(max_device_dets)

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
        results: List[np.ndarray] = []
        for start in range(0, N, self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                frames_rgb[start:start + self.batch_size])).to(self.device)
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
