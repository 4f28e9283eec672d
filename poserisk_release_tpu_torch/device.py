"""The port's device rule, shared by its entry points, models and scorers."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, else CUDA; with neither a device nor CUDA it
    raises instead of using the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run the "
            "port on the CPU")
    return device
