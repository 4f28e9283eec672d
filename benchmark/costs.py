"""Operations and bytes the benchmark counts, from shapes alone.

Model FLOPs count each convolution and linear layer as 2 x multiply-adds
(biases, BatchNorm, activations, pooling, resampling, rotations, joints and
the rule engines are left out: they are under 1% of either model). Kernel
bytes count each output written once and, per frame, each source pixel
that a nonzero bilinear tap reads, read once; kernel operations are ~10 f32
operations per output value. Peaks are one NVIDIA H100 SXM's published
dense rates at its 700 W limit: 67 TFLOP/s in f32 outside the tensor cores
(the configurations run with TF32 off) and 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from benchmark.reference import hmr as ref_hmr
from benchmark.reference import yolo as ref_yolo

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_OUTPUT = 10


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return 2 * cin * cout * k * k * h_out * w_out


def yolo_flops(canvas_h: int, canvas_w: int) -> int:
    """YOLOv3's convolutions on one canvas_h x canvas_w letterbox."""
    sizes, total, hw = [], 0, (canvas_h, canvas_w)
    for i, e in enumerate(ref_yolo.SPEC):
        if e[0] == "conv":
            _, cout, k, s, _ = e
            hw = ((hw[0] + 2 * ((k - 1) // 2) - k) // s + 1, (hw[1] + 2 * ((k - 1) // 2) - k) // s + 1)
        elif e[0] == "route":
            hw = sizes[e[1][0] if e[1][0] >= 0 else i + e[1][0]]
        elif e[0] == "upsample":
            hw = (hw[0] * 2, hw[1] * 2)
        sizes.append(hw)
    for i, cin, cout, k, _, _ in ref_yolo.conv_layers():
        total += conv_flops(cin, cout, k, *sizes[i])
    return total


def hmr_flops(size: int = 224) -> int:
    """ResNet-50 on one size x size crop plus the 3 IEF steps."""
    h = (size + 6 - 7) // 2 + 1  # conv1, stride 2
    total = conv_flops(3, 64, 7, h, h)
    h = (h + 2 - 3) // 2 + 1  # max-pool
    inp = 64
    for li, (n, planes) in enumerate(zip(ref_hmr.LAYERS, ref_hmr.PLANES)):
        for bi in range(n):
            stride = 2 if (bi == 0 and li > 0) else 1
            h_out = (h - 1) // stride + 1
            if bi == 0:
                total += conv_flops(inp, planes * 4, 1, h_out, h_out)
            total += conv_flops(inp, planes, 1, h, h)
            total += conv_flops(planes, planes, 3, h_out, h_out)
            total += conv_flops(planes, planes * 4, 1, h_out, h_out)
            inp, h = planes * 4, h_out
    ief = 2 * ((2048 + 157) * 1024 + 1024 * 1024 + 1024 * 157)
    return total + ref_hmr.N_ITER * ief


def frame_flops(frame_hw: Tuple[int, int], detector: bool, img_size: int = 416) -> int:
    """Model FLOPs of one frame on the video path: the detector on its rect
    letterbox (when the configuration has one) and the pose model on one crop."""
    out = hmr_flops()
    if detector:
        ch, cw = ref_yolo.canvas(frame_hw[0], frame_hw[1], img_size)[:2]
        out += yolo_flops(ch, cw)
    return out


def _read(i0, i1, w0, w1) -> set:
    return set(np.asarray(i0)[np.asarray(w0) != 0].tolist()) | set(
        np.asarray(i1)[np.asarray(w1) != 0].tolist())


def crop_taps(c: np.ndarray, size: int):
    x0 = np.floor(c)
    f = c - x0
    i0 = x0.astype(np.int64)
    i1 = i0 + 1
    w0 = np.where((i0 >= 0) & (i0 < size), 1 - f, 0.0)
    w1 = np.where((i1 >= 0) & (i1 < size), f, 0.0)
    return np.clip(i0, 0, size - 1), np.clip(i1, 0, size - 1), w0, w1


def crop_source_sets(box, H: int, W: int, scale: float = 1.2, out: int = 224):
    d = np.arange(out) - out / 2
    rows = _read(*crop_taps(box[1] + d * (box[3] * scale / out), H))
    cols = _read(*crop_taps(box[0] + d * (box[2] * scale / out), W))
    return rows, cols


def k1_bytes(boxes: np.ndarray, H: int, W: int, out_bytes: int = 4, out: int = 224) -> int:
    """One crop launch (K1) over these (n, 4) boxes."""
    total = len(boxes) * out * out * 3 * out_bytes
    for b in boxes:
        rows, cols = crop_source_sets(b, H, W, out=out)
        total += len(rows) * len(cols) * 3
    return total


def k1_bound_s(boxes: np.ndarray, H: int, W: int, out: int = 224) -> float:
    ops = len(boxes) * out * out * 3 * OPS_PER_OUTPUT
    return max(k1_bytes(boxes, H, W, out=out) / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def letterbox_source_sets(H: int, W: int, img_size: int = 416):
    ch, cw, new_w, new_h, pad_x, pad_y = ref_yolo.canvas(H, W, img_size)
    sets = []
    for out, pad, new, size in ((ch, pad_y, new_h, H), (cw, pad_x, new_w, W)):
        i0, i1, frac, inside = ref_yolo._axis(out, pad, new, size)
        sets.append(_read(i0[inside], i1[inside], 1 - frac[inside], frac[inside]))
    return sets[0], sets[1], ch, cw


def k2_bytes(n_frames: int, H: int, W: int, out_bytes: int = 4, img_size: int = 416) -> int:
    """One letterbox launch (K2's letterbox-only mode) over n frames."""
    rows, cols, ch, cw = letterbox_source_sets(H, W, img_size)
    return n_frames * (ch * cw * 3 * out_bytes + len(rows) * len(cols) * 3)


def k2_bound_s(n_frames: int, H: int, W: int, img_size: int = 416) -> float:
    ch, cw = ref_yolo.canvas(H, W, img_size)[:2]
    ops = n_frames * ch * cw * 3 * OPS_PER_OUTPUT
    return max(k2_bytes(n_frames, H, W, img_size=img_size) / HBM_BYTES_PER_S,
               ops / F32_FLOPS_PER_S)
