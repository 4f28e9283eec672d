"""Plain SPIN pose path: bbox crop, HMR (ResNet-50 + IEF), SMPL joints.

SPIN's HMR (Kolotouros et al., ICCV 2019; github.com/nkolot/SPIN
models/hmr.py): torchvision's ResNet-50 v1.5 (bottlenecks [3, 4, 6, 3],
stride on the 3x3 conv, BatchNorm in eval mode, eps 1e-5) pooled to 2048,
then 3 iterative-error-feedback steps: [features, pose, shape, camera]
(2048 + 144 + 10 + 3) -> fc1 (1024) -> fc2 (1024) -> decpose (144),
decshape (10), deccam (3), each added to its state; no activation and no
dropout at inference. The 24 6D rotations become matrices by Gram-Schmidt
on the columns of their (3, 2) reshape.

The crop is the reference's cv2.warpAffine for rotation 0: a 224x224
bilinear resample of the bbox [cx, cy, w, h] scaled by 1.2,
src = c + (dst - 112) * (size * 1.2 / 224), taps outside the frame at
weight 0, then /255 (no mean or std normalisation).

SMPL joints for the scoring path: rest joints regressed from the template
mesh (zero betas), then the kinematic chain of the 24 joint rotations, the
root's forced to the axis-angle (3.14, 0, 0); millimetres, root-centred.
Plain `torch` operations, NCHW; nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import precision

BN_EPS = 1e-5
LAYERS = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)
N_ITER = 3
ROOT_AA = (3.14, 0.0, 0.0)
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


def crop(frames_u8: torch.Tensor, boxes: torch.Tensor, scale: float = 1.2,
         out: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames, (B, 4) [cx, cy, w, h] -> (B, 3, out, out) in [0, 1]."""
    B, H, W = frames_u8.shape[:3]
    boxes = boxes.double()
    d = torch.arange(out, device=frames_u8.device, dtype=torch.float64) - out / 2
    xs = boxes[:, 0:1] + d[None] * (boxes[:, 2:3] * scale / out)
    ys = boxes[:, 1:2] + d[None] * (boxes[:, 3:4] * scale / out)

    def taps(c, size):
        i0 = torch.floor(c)
        f = (c - i0).float()
        i0 = i0.long()
        i1 = i0 + 1
        w0 = torch.where((i0 >= 0) & (i0 < size), 1 - f, torch.zeros_like(f))
        w1 = torch.where((i1 >= 0) & (i1 < size), f, torch.zeros_like(f))
        return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w0, w1

    y0, y1, wy0, wy1 = taps(ys, H)
    x0, x1, wx0, wx1 = taps(xs, W)
    b = torch.arange(B, device=frames_u8.device)[:, None, None]

    def px(yi, xi):
        return frames_u8[b, yi[:, :, None], xi[:, None, :]].float()

    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    img = ((px(y0, x0) * wx0 + px(y0, x1) * wx1) * wy0[:, :, None, None]
           + (px(y1, x0) * wx0 + px(y1, x1) * wx1) * wy1[:, :, None, None]) / 255.0
    return img.permute(0, 3, 1, 2).contiguous()


def _conv_bn(p: Dict[str, torch.Tensor], conv: str, bn: str, x, stride=1, padding=0,
             calibrate=False):
    x = precision.conv2d(x, p[conv + ".weight"], None, stride, padding)
    return F.batch_norm(x, p[bn + ".running_mean"], p[bn + ".running_var"], p[bn + ".weight"],
                        p[bn + ".bias"], calibrate, 1.0, BN_EPS)


def features(p: Dict[str, torch.Tensor], x: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
    """(B, 3, 224, 224) -> pooled (B, 2048). calibrate=True normalises by
    the batch's statistics and writes them into the running ones."""
    c = calibrate
    x = F.relu(_conv_bn(p, "conv1", "bn1", x, 2, 3, c))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (n, planes) in enumerate(zip(LAYERS, PLANES)):
        for bi in range(n):
            q = f"layer{li + 1}.{bi}."
            stride = 2 if (bi == 0 and li > 0) else 1
            identity = x
            if bi == 0:
                identity = _conv_bn(p, q + "downsample.0", q + "downsample.1", x, stride, 0, c)
            y = F.relu(_conv_bn(p, q + "conv1", q + "bn1", x, 1, 0, c))
            y = F.relu(_conv_bn(p, q + "conv2", q + "bn2", y, stride, 1, c))
            y = _conv_bn(p, q + "conv3", q + "bn3", y, 1, 0, c)
            x = F.relu(y + identity)
    return x.mean(dim=(2, 3))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[..., 0], m[..., 1]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1)


def regress(p: Dict[str, torch.Tensor], xf: torch.Tensor) -> torch.Tensor:
    """Pooled features -> (B, 24, 3, 3) rotations after N_ITER IEF steps."""
    B = xf.shape[0]
    pose = p["init_pose"].expand(B, -1)
    shape = p["init_shape"].expand(B, -1)
    cam = p["init_cam"].expand(B, -1)

    def lin(name, t):
        return precision.linear(t, p[name + ".weight"], p[name + ".bias"])

    for _ in range(N_ITER):
        xc = lin("fc2", lin("fc1", torch.cat([xf, pose, shape, cam], dim=1)))
        pose = lin("decpose", xc) + pose
        shape = lin("decshape", xc) + shape
        cam = lin("deccam", xc) + cam
    return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3)


def rotations(p: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
              boxes: torch.Tensor) -> torch.Tensor:
    """Frames and their boxes -> the HMR's (B, 24, 3, 3) joint rotations."""
    return regress(p, features(p, crop(frames_u8, boxes)))


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta = aa.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = aa / theta
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1).reshape(aa.shape + (3,))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def joints_mm(smpl: Dict[str, torch.Tensor], rotmats: torch.Tensor) -> torch.Tensor:
    """(B, 24, 3, 3) local rotations -> (B, 24, 3) root-centred joints, mm."""
    rest = smpl["J_regressor"] @ smpl["v_template"]  # (24, 3): zero betas
    B = rotmats.shape[0]
    root = rodrigues(torch.tensor(ROOT_AA, dtype=rotmats.dtype, device=rotmats.device))
    R = [root.expand(B, 3, 3)]
    t = [rest[0].expand(B, 3)]
    for j in range(1, 24):
        q = PARENTS[j]
        R.append(R[q] @ rotmats[:, j])
        t.append(t[q] + (R[q] @ (rest[j] - rest[q])[:, None])[..., 0])
    joints = torch.stack(t, dim=1) * 1000.0
    return joints - joints[:, :1]


def euler_deg_to_rotmat(e: torch.Tensor) -> torch.Tensor:
    """XYZ Euler degrees (..., 3), R = Rz Ry Rx -> (..., 3, 3)."""
    x, y, z = (e * (math.pi / 180)).unbind(-1)
    cx, sx, cy, sy, cz, sz = x.cos(), x.sin(), y.cos(), y.sin(), z.cos(), z.sin()
    return torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                        -sy, cy * sx, cy * cx], dim=-1).reshape(e.shape + (3,))


def rotmat_to_euler_deg(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> XYZ Euler degrees with R = Rz Ry Rx (atan2 form)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1) * (180.0 / math.pi)
