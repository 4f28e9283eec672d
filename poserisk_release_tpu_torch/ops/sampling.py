"""Feature-map sampling utilities.

Port of the JAX package's ops/sampling.py, the reference's
sample_image_feature (lib/utils/funcs_utils.py:87-93): bilinear lookup of a
feature map at continuous 2-D points with grid_sample(align_corners=True)
semantics -- normalised coords in [-1, 1] map linearly onto the pixel
CENTRES of the first and last pixels, and taps outside the map read zero.
The JAX package writes the four taps out by hand (no Pallas kernel stands
behind it); here the same normalisation feeds F.grid_sample, which is the
function the reference calls.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F


def sample_image_feature(
    img_feat: torch.Tensor,  # (C, H, W) feature map
    xy: torch.Tensor,  # (N, 2) pixel coordinates in the ORIGINAL image frame
    width: float,
    height: float,
) -> torch.Tensor:
    """Returns (N, C) bilinear feature samples at the given points: the
    reference's normalisation x/width*2-1, y/height*2-1, then
    grid_sample(align_corners=True, padding_mode='zeros') over the feature
    map's own grid."""
    img_feat = torch.as_tensor(img_feat)
    xy = torch.as_tensor(xy, dtype=img_feat.dtype, device=img_feat.device)
    grid = torch.stack((xy[:, 0] / width * 2 - 1, xy[:, 1] / height * 2 - 1), dim=1)
    out = F.grid_sample(img_feat[None], grid[None, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, :, 0].t()


def count_parameters(params) -> int:
    """Total element count of a parameter tree (funcs_utils.py:143-144): an
    nn.Module's parameters, or a (nested) mapping of tensors or arrays such
    as a state_dict."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(count_parameters(v) for v in params.values())
    return int(params.numel()) if isinstance(params, torch.Tensor) else int(np.size(params))
