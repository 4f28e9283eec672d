"""Plain YOLOv3 person detector: letterbox, Darknet-53 forward, decode, NMS.

The darknet `cfg/yolov3.cfg` graph (pjreddie.com): Darknet-53 and three
detection heads over 80 classes and 9 anchors, every conv with pad
(k - 1) // 2, BatchNorm in eval mode and leaky ReLU 0.1 except the three
1x1 heads, which carry a bias. Plain `torch` operations only, BatchNorm as
its own operation (never folded), NCHW.

The letterbox follows the upstream detector's cv2.resize (INTER_LINEAR,
half-pixel centres, edge clamp) onto a gray 128 canvas, on the rectangular
canvas: the square 416 letterbox's content scale, padded on each axis only to
a multiple of 32, the leading pad being the square pad modulo 32 (800x450
frames give a 416x288 canvas). Boxes are mapped back to the frame by the
exact inverse of that geometry, clipped to the frame, boxes under 2 px on a
side dropped, then thresholded on objectness x person score and
non-maximum suppressed (greedy, IoU, ties by anchor order).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import precision


def _residual(filters: int, n: int) -> List[tuple]:
    out = []
    for _ in range(n):
        out += [("conv", filters // 2, 1, 1, True), ("conv", filters, 3, 1, True), ("shortcut", -3)]
    return out


def _head(filters: int, anchor_set: int) -> List[tuple]:
    return [("conv", filters, 1, 1, True), ("conv", filters * 2, 3, 1, True),
            ("conv", filters, 1, 1, True), ("conv", filters * 2, 3, 1, True),
            ("conv", filters, 1, 1, True), ("conv", filters * 2, 3, 1, True),
            ("conv", 255, 1, 1, False), ("yolo", anchor_set)]


# yolov3.cfg in order: ("conv", filters, size, stride, batch_normalize),
# ("shortcut", from), ("route", layers), ("upsample",), ("yolo", anchor set).
SPEC: List[tuple] = [
    ("conv", 32, 3, 1, True), ("conv", 64, 3, 2, True), *_residual(64, 1),
    ("conv", 128, 3, 2, True), *_residual(128, 2),
    ("conv", 256, 3, 2, True), *_residual(256, 8),
    ("conv", 512, 3, 2, True), *_residual(512, 8),
    ("conv", 1024, 3, 2, True), *_residual(1024, 4),
    *_head(512, 2),
    ("route", [-4]), ("conv", 256, 1, 1, True), ("upsample",), ("route", [-1, 61]),
    *_head(256, 1),
    ("route", [-4]), ("conv", 128, 1, 1, True), ("upsample",), ("route", [-1, 36]),
    *_head(128, 0),
]
ANCHORS = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)),
           ((116, 90), (156, 198), (373, 326)))
NUM_CLASSES = 80
PERSON = 0
BN_EPS = 1e-5
LEAKY = 0.1
GRAY = 128.0


def conv_layers() -> List[Tuple[int, int, int, int, int, bool]]:
    """(spec index, in channels, filters, size, stride, batch_normalize) of
    every conv, in the weight file's order."""
    channels, out, in_ch = [], [], 3
    for i, entry in enumerate(SPEC):
        if entry[0] == "conv":
            out.append((i, in_ch, entry[1], entry[2], entry[3], entry[4]))
            in_ch = entry[1]
        elif entry[0] == "route":
            in_ch = sum(channels[r if r >= 0 else i + r] for r in entry[1])
        channels.append(in_ch)
    return out


def canvas(H: int, W: int, img_size: int = 416, multiple: int = 32):
    """(canvas_h, canvas_w, new_w, new_h, pad_x, pad_y) of the rect letterbox."""
    ratio = img_size / max(H, W)
    new_w, new_h = int(round(W * ratio)), int(round(H * ratio))
    pad_x = ((img_size - new_w) // 2) % multiple
    pad_y = ((img_size - new_h) // 2) % multiple
    return (-(-(new_h + pad_y) // multiple) * multiple, -(-(new_w + pad_x) // multiple) * multiple,
            new_w, new_h, pad_x, pad_y)


def _axis(out: int, pad: int, new: int, size: int):
    o = np.arange(out)
    inside = (o >= pad) & (o < pad + new)
    src = np.clip((o - pad + 0.5) * (size / new) - 0.5, 0.0, size - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, size - 1)
    frac = src - i0
    return i0, i1, frac, inside


def letterbox(frames_u8: torch.Tensor, img_size: int = 416) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, canvas_h, canvas_w) float32 in [0, 1]."""
    H, W = frames_u8.shape[1], frames_u8.shape[2]
    ch, cw, new_w, new_h, pad_x, pad_y = canvas(H, W, img_size)
    dev = frames_u8.device
    y0, y1, fy, iny = (torch.as_tensor(a, device=dev) for a in _axis(ch, pad_y, new_h, H))
    x0, x1, fx, inx = (torch.as_tensor(a, device=dev) for a in _axis(cw, pad_x, new_w, W))
    fy = fy.float()[None, :, None, None]
    fx = fx.float()[None, None, :, None]

    def px(yi, xi):
        return frames_u8[:, yi[:, None], xi[None, :]].float()

    top = px(y0, x0) * (1 - fx) + px(y0, x1) * fx
    bottom = px(y1, x0) * (1 - fx) + px(y1, x1) * fx
    img = top * (1 - fy) + bottom * fy
    band = (iny[:, None] & inx[None, :])[None, :, :, None]
    img = torch.where(band, img, torch.full_like(img, GRAY)) / 255.0
    return img.permute(0, 3, 1, 2).contiguous()


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            calibrate: bool = False, raw_heads: list = None) -> torch.Tensor:
    """Letterboxed (B, 3, h, w) -> decoded (B, anchors, 5) [cx, cy, w, h,
    objectness x person] in canvas pixels. params: the darknet weights under
    `conv_{i}.conv.weight`, `conv_{i}.conv.bias` (heads) and
    `conv_{i}.bn.{weight,bias,running_mean,running_var}`. calibrate=True
    normalises by the batch's statistics and writes them into the running
    ones (how the benchmark's weights get data-calibrated BatchNorm).
    raw_heads, a list, receives (spec index of the head conv, raw output)."""
    saved, outs = {}, []
    keep = set()
    for i, e in enumerate(SPEC):
        if e[0] == "shortcut":
            keep.add(i + e[1])
        elif e[0] == "route":
            keep.update(r if r >= 0 else i + r for r in e[1])
    canvas_h = x.shape[2]
    for i, e in enumerate(SPEC):
        if e[0] == "conv":
            p = f"conv_{i}."
            k = e[2]
            x = precision.conv2d(x, params[p + "conv.weight"], params.get(p + "conv.bias"),
                         e[3], (k - 1) // 2)
            if e[4]:
                x = F.batch_norm(x, params[p + "bn.running_mean"], params[p + "bn.running_var"],
                                 params[p + "bn.weight"], params[p + "bn.bias"], calibrate,
                                 1.0, BN_EPS)
                x = F.leaky_relu(x, LEAKY)
        elif e[0] == "shortcut":
            x = x + saved[i + e[1]]
        elif e[0] == "route":
            x = torch.cat([saved[r if r >= 0 else i + r] for r in e[1]], dim=1)
        elif e[0] == "upsample":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif e[0] == "yolo":
            if raw_heads is not None:
                raw_heads.append((i - 1, x))
            outs.append(decode(x, e[1], canvas_h // x.shape[2]))
        if i in keep:
            saved[i] = x
    return torch.cat(outs, dim=1)


def decode(raw: torch.Tensor, anchor_set: int, stride: int) -> torch.Tensor:
    B, _, gh, gw = raw.shape
    r = raw.float().permute(0, 2, 3, 1).reshape(B, gh, gw, 3, 5 + NUM_CLASSES)
    gy, gx = torch.meshgrid(torch.arange(gh, device=raw.device, dtype=torch.float32),
                            torch.arange(gw, device=raw.device, dtype=torch.float32),
                            indexing="ij")
    cx = (torch.sigmoid(r[..., 0]) + gx[..., None]) * stride
    cy = (torch.sigmoid(r[..., 1]) + gy[..., None]) * stride
    anchors = torch.tensor(ANCHORS[anchor_set], dtype=torch.float32, device=raw.device)
    w = torch.exp(torch.clamp(r[..., 2], -20, 20)) * anchors[:, 0]
    h = torch.exp(torch.clamp(r[..., 3], -20, 20)) * anchors[:, 1]
    score = torch.sigmoid(r[..., 4]) * torch.sigmoid(r[..., 5 + PERSON])
    return torch.stack([cx, cy, w, h, score], dim=-1).reshape(B, gh * gw * 3, 5)


def to_frame(det: np.ndarray, H: int, W: int, img_size: int = 416) -> np.ndarray:
    """Canvas-pixel (n, 5) [cx, cy, w, h, score] -> frame (n, 5) [x1, y1,
    x2, y2, score], clipped, with boxes under 2 px on a side dropped."""
    _, _, new_w, new_h, pad_x, pad_y = canvas(H, W, img_size)
    det = det.astype(np.float64)
    sx, sy = new_w / W, new_h / H
    cx = (det[:, 0] - pad_x + 0.5) / sx - 0.5
    cy = (det[:, 1] - pad_y + 0.5) / sy - 0.5
    w, h = det[:, 2] / sx, det[:, 3] / sy
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, det[:, 4]], axis=1)
    boxes[:, 0:4:2] = boxes[:, 0:4:2].clip(0, W - 1)
    boxes[:, 1:4:2] = boxes[:, 1:4:2].clip(0, H - 1)
    ok = ((boxes[:, 2] - boxes[:, 0]) >= 2) & ((boxes[:, 3] - boxes[:, 1]) >= 2)
    return boxes[ok]


def nms(boxes: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy NMS over (n, 5) [x1, y1, x2, y2, score]; the kept rows in
    descending score, ties in input order."""
    order = np.argsort(-boxes[:, 4], kind="stable")
    keep = []
    while order.size:
        i, rest = order[0], order[1:]
        keep.append(i)
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
        iou = inter / np.maximum(area(boxes[i]) + area(boxes[rest]) - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return boxes[np.array(keep, np.int64)] if keep else boxes[:0]


def detect(params, frames_u8: torch.Tensor, threshold: float, nms_thr: float,
           img_size: int = 416):
    """Per frame: (candidates (n, 5) over `threshold` / 2, kept (k, 5)),
    both [x1, y1, x2, y2, score] in frame pixels."""
    H, W = frames_u8.shape[1], frames_u8.shape[2]
    det = forward(params, letterbox(frames_u8, img_size)).cpu().numpy()
    out = []
    for d in det:
        boxes = to_frame(d, H, W, img_size)
        cand = boxes[boxes[:, 4] > threshold / 2]
        out.append((cand, nms(cand[cand[:, 4] > threshold], nms_thr)))
    return out
