"""Weights and SMPL tables made from the seed, on the device, in a few large draws.

The benchmark makes every weight itself and hands the same tensors to the
program and to the plain reference. Draws come from one torch.Generator
on the run's device: one normal draw for all conv and linear weights of a
model, one for all BatchNorm parameters, each then cut into its leaves and
scaled. The BatchNorm running statistics are then calibrated on eight of
the seed's frames (one pass of the plain reference with batch statistics),
as a trained network's are, so that every seed's heads and regressor sit in
the same working range, where a lower precision shows: seeded weights of
He's scale with BatchNorm at identity grow the residual streams until the
detector's heads saturate. The remaining scales are the configuration's
`assumed.init` numbers. A run keeps a host copy of what it made and hands
that to the reference after the window.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.core import traffic
from benchmark.reference import hmr as ref_hmr
from benchmark.reference import yolo as ref_yolo

CALIB_FRAMES = 8


def _generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63 - 1))
    return g


def _cut(flat: torch.Tensor, shapes: List[Tuple[int, ...]]) -> List[torch.Tensor]:
    out, at = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[at:at + n].view(s))
        at += n
    return out


def _bn_stats(g, device, widths: List[int], gammas: List[float], init: Dict):
    """Per BatchNorm: weight, bias, running_mean, running_var, from one draw."""
    total = sum(widths)
    u = torch.rand((4, total), generator=g, device=device)
    out = []
    at = 0
    for c, gamma in zip(widths, gammas):
        w, b, m, v = (u[k, at:at + c] for k in range(4))
        at += c
        out.append((gamma * (0.75 + 0.5 * w), init["bn_shift"] * (2 * b - 1),
                    init["bn_shift"] * (2 * m - 1), 0.75 + 0.5 * v))
    return out


def calibration_inputs(seed: int, frame_hw, device):
    """Eight of the seed's frames (uint8, on the device) and their boxes."""
    boxes = traffic.track_boxes(CALIB_FRAMES, frame_hw, seed, salt=99)
    frames = traffic.frames_for(boxes, frame_hw, seed)
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(boxes).to(device))


def _calibrated(forward, params, x, var_floor: float) -> None:
    """BatchNorm statistics from one pass over x. Each channel's variance
    gets `var_floor` x its layer's mean variance added: eight frames of one
    scene leave some channels all but constant, and a BatchNorm that divides
    by such a variance amplifies every rounding of that channel on other
    frames (a trained network's statistics come from a whole dataset)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            forward(params, x, calibrate=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k, v in params.items():
        if k.endswith("running_var"):
            v += var_floor * v.mean()


def yolo_params(seed: int, device, init: Dict, frame_hw=(450, 800),
                img_size: int = 416) -> Dict[str, torch.Tensor]:
    """Darknet YOLOv3 weights (BatchNorm unfolded, heads with a bias)."""
    layers = ref_yolo.conv_layers()
    g = _generator(seed, 1, device)
    shapes = [(f, c, k, k) for _, c, f, k, _, _ in layers]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g, device=device)
    # The second conv of each residual unit writes into the stream: a small
    # BatchNorm scale keeps the 23 residual sums from growing.
    residual_out = {i - 1 for i, e in enumerate(ref_yolo.SPEC) if e[0] == "shortcut"}
    bn_layers = [(i, f) for i, _, f, _, _, bn in layers if bn]
    stats = _bn_stats(g, device, [f for _, f in bn_layers],
                      [init["residual_gamma"] if i in residual_out else 1.0
                       for i, _ in bn_layers], init)
    params: Dict[str, torch.Tensor] = {}
    for (i, c, f, k, _, bn), w in zip(layers, _cut(flat, shapes)):
        gain = math.sqrt(2.0 / (c * k * k)) * (1.0 if bn else init["head_gain"])
        params[f"conv_{i}.conv.weight"] = w * gain
    for (i, f), (w, b, m, v) in zip(bn_layers, stats):
        p = f"conv_{i}.bn."
        params[p + "weight"], params[p + "bias"] = w, b
        params[p + "running_mean"], params[p + "running_var"] = m, v
    for i, _, f, _, _, bn in layers:
        if not bn:
            params[f"conv_{i}.conv.bias"] = torch.zeros((f,), device=device)
    frames, _ = calibration_inputs(seed, frame_hw, device)
    x = ref_yolo.letterbox(frames, img_size)
    _calibrated(ref_yolo.forward, params, x, init["bn_var_floor"])
    # Each head's objectness bias puts its `objectness_quantile` at logit 0,
    # and the person logit is centred: the same share of anchors clears the
    # threshold on every seed, as with a trained detector on a scene with people.
    heads = []
    with torch.no_grad():
        ref_yolo.forward(params, x, raw_heads=heads)
    for i, raw in heads:
        r = raw.float().permute(0, 2, 3, 1).reshape(-1, 3, 85)
        bias = params[f"conv_{i}.conv.bias"].view(3, 85)
        bias[:, 4] -= torch.quantile(r[:, :, 4], init["objectness_quantile"], dim=0)
        bias[:, 5] -= r[:, :, 5].mean(dim=0)
    return params


def hmr_convs() -> List[Tuple[str, str, int, int, int]]:
    """(conv name, BatchNorm name, in, out, size) of SPIN's ResNet-50."""
    out = [("conv1", "bn1", 3, 64, 7)]
    inp = 64
    for li, (n, planes) in enumerate(zip(ref_hmr.LAYERS, ref_hmr.PLANES)):
        for bi in range(n):
            q = f"layer{li + 1}.{bi}."
            if bi == 0:
                out.append((q + "downsample.0", q + "downsample.1", inp, planes * 4, 1))
            out += [(q + "conv1", q + "bn1", inp, planes, 1),
                    (q + "conv2", q + "bn2", planes, planes, 3),
                    (q + "conv3", q + "bn3", planes, planes * 4, 1)]
            inp = planes * 4
    return out


HMR_LINEAR = (("fc1", 2048 + 144 + 13, 1024), ("fc2", 1024, 1024), ("decpose", 1024, 144),
              ("decshape", 1024, 10), ("deccam", 1024, 3))


def hmr_params(seed: int, device, init: Dict, frame_hw=(450, 800)) -> Dict[str, torch.Tensor]:
    """SPIN HMR weights under the published checkpoint's names."""
    convs = hmr_convs()
    g = _generator(seed, 2, device)
    shapes = [(o, c, k, k) for _, _, c, o, k in convs] + [(o, c) for _, c, o in HMR_LINEAR]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g, device=device)
    leaves = _cut(flat, shapes)
    stats = _bn_stats(g, device, [o for _, _, _, o, _ in convs],
                      [init["residual_gamma"] if bn.endswith("bn3") else 1.0
                       for _, bn, _, _, _ in convs], init)
    p: Dict[str, torch.Tensor] = {}
    for (conv, bn, c, o, k), w, (gw, gb, m, v) in zip(convs, leaves, stats):
        p[conv + ".weight"] = w * math.sqrt(2.0 / (c * k * k))
        p[bn + ".weight"], p[bn + ".bias"] = gw, gb
        p[bn + ".running_mean"], p[bn + ".running_var"] = m, v
        p[bn + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    gains = {"fc1": init["fc1_gain"], "fc2": 1.0, "decpose": init["decpose_gain"],
             "decshape": init["decpose_gain"], "deccam": init["decpose_gain"]}
    for (name, c, o), w in zip(HMR_LINEAR, leaves[len(convs):]):
        p[name + ".weight"] = w * (gains[name] / math.sqrt(c))
        p[name + ".bias"] = torch.zeros((o,), device=device)
    p["init_pose"] = torch.tensor([1.0, 0, 0, 1, 0, 0] * 24, device=device)[None]
    p["init_shape"] = torch.zeros((1, 10), device=device)
    p["init_cam"] = torch.tensor([[0.9, 0.0, 0.0]], device=device)
    frames, boxes = calibration_inputs(seed, frame_hw, device)
    _calibrated(ref_hmr.features, p, ref_hmr.crop(frames, boxes), init["bn_var_floor"])
    return p


def to_host(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in params.items()}


def to_device(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in params.items()}


def smpl_arrays(seed: int, num_verts: int = 6890) -> Dict[str, np.ndarray]:
    """A neutral SMPL model at the published sizes (6,890 vertices, 24
    joints, 10 shape and 207 pose blend shapes): a humanoid chain of rest
    joints 12 cm apart, each vertex owned by a joint, J_regressor the mean of
    the owned vertices. Only v_template and J_regressor reach the joints
    (zero betas, no skinning); the rest is there at its size."""
    rng = np.random.RandomState(int(seed) % (2 ** 32))
    parents = np.array(ref_hmr.PARENTS, np.int64)
    joints = np.zeros((24, 3))
    for j in range(1, 24):
        d = rng.normal(size=3)
        joints[j] = joints[parents[j]] + d / np.linalg.norm(d) * 0.12
    owner = np.concatenate([np.arange(24), rng.randint(0, 24, num_verts - 24)])
    v_template = (joints[owner] + rng.normal(scale=0.05, size=(num_verts, 3))).astype(np.float32)
    counts = np.bincount(owner, minlength=24)
    j_reg = np.zeros((24, num_verts), np.float32)
    j_reg[owner, np.arange(num_verts)] = 1.0 / counts[owner]
    weights = np.zeros((num_verts, 24), np.float32)
    weights[np.arange(num_verts), owner] = 1.0
    return {
        "v_template": v_template,
        "shapedirs": np.zeros((num_verts, 3, 10), np.float32),
        "posedirs": np.zeros((num_verts, 3, 207), np.float32),
        "J_regressor": j_reg,
        "weights": weights,
        "kintree_parents": parents,
        "faces": np.stack([np.arange(num_verts - 2), np.arange(1, num_verts - 1),
                           np.arange(2, num_verts)], 1).astype(np.int32),
        "betas": np.zeros(10, np.float32),
    }
