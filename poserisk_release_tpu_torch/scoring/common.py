"""Shared helpers for the vectorised REBA/RULA rule engines (PyTorch)."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch


def chain(branches: Sequence[Tuple[torch.Tensor, object]], default) -> torch.Tensor:
    """Vectorised if/elif/else: the first true branch wins, like Python's
    chain. `branches` is an ordered list of (condition, value) pairs with
    int or int-tensor values; `default` is the else value. Several reference
    rules rely on earlier branches shadowing later, overlapping ones, so the
    selects apply from the last branch back to the first."""
    cond0 = branches[0][0]
    out = torch.as_tensor(default, dtype=torch.int32, device=cond0.device).expand(cond0.shape)
    for cond, value in reversed(branches):
        value = torch.as_tensor(value, dtype=torch.int32, device=cond0.device)
        out = torch.where(cond, value, out)
    return out


SCORE_CHUNK_MAX = 1024


def frame_scores_chunked(
    score_fn: Callable, poses: np.ndarray, info_packed: np.ndarray, device="cpu"
) -> Dict[str, np.ndarray]:
    """Run a per-frame scoring engine (reba/rula_frame_scores) on `device`
    in chunks of at most SCORE_CHUNK_MAX frames (bounded device memory;
    scoring has no cross-frame op, so chunking is exact).

    Dtype policy: the engine scores at the INPUT's precision, float64
    inputs in float64 and everything else in float32. The reference
    evaluates its rule chains on float64 angles against integer thresholds,
    so an angle within f32 rounding of a threshold (110 - 1e-6 rounds to
    110.0 in f32) would flip a branch if the engine downcast it."""
    poses = np.asarray(poses)
    if poses.dtype != np.float64:
        poses = poses.astype(np.float32)
    info = torch.as_tensor(np.asarray(info_packed, np.int32), device=device)
    outs = []
    for start in range(0, max(poses.shape[0], 1), SCORE_CHUNK_MAX):
        part = torch.as_tensor(poses[start:start + SCORE_CHUNK_MAX], device=device)
        outs.append({k: v.cpu().numpy() for k, v in score_fn(part, info).items()})
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


def table_gather(table: torch.Tensor, *indices: torch.Tensor) -> torch.Tensor:
    """Gather table[idx0, idx1, ...] for per-frame index arrays (0-based)."""
    flat = indices[0]
    for dim, idx in zip(table.shape[1:], indices[1:]):
        flat = flat * dim + idx
    return table.reshape(-1)[flat.long()]
