"""Person detectors of the port.

Only the deterministic StubDetector lives here for now: with no YOLOv3
weights present the Predictor runs it (pipeline.build_detector). The YOLOv3
float path, its device letterbox and the fused letterbox+crop kernel come
with the detector slice of the port.
"""

from __future__ import annotations

from typing import List

import numpy as np


class StubDetector:
    """Deterministic detector for weight-free pipelines: one fixed box per
    frame, [0.25 W, 0.1 H, 0.75 W, 0.95 H] with score 0.99 (x1, y1, x2, y2,
    score), as the JAX package's StubDetector gives without a script."""

    def __call__(self, frames_rgb: np.ndarray) -> List[np.ndarray]:
        N, H, W = frames_rgb.shape[0], frames_rgb.shape[1], frames_rgb.shape[2]
        box = np.array([[W * 0.25, H * 0.1, W * 0.75, H * 0.95, 0.99]], np.float32)
        return [box.copy() for _ in range(N)]
