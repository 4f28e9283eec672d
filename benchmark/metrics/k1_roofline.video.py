"""K1 (csrc/crop.cu, the pose crop) against its roofline: the mean bound of
a launch over the traced stretch's pose chunks (benchmark/costs.k1_bound_s
on each chunk's boxes: the larger of its bytes over 3.35 TB/s and ~10 f32
operations per output over 67 TFLOP/s) over the mean device time of a
launch in the stretch, from the profiler."""

import numpy as np

from benchmark import costs

MOVES = "frames_per_s"


def is_k1(name: str) -> bool:
    return "crop_kernel" in name and "letterbox" not in name and "window" not in name \
        and "multi" not in name


def read(run):
    st, tr = run.stretch, run.trace
    if tr is None or not st.get("boxes"):
        return None
    n, seconds = tr.kernel_time(is_k1)
    if not n or seconds <= 0:
        return None
    H, W = st["frame_hw"]
    chunk = st["chunk"]
    bounds = [costs.k1_bound_s(boxes[s:s + chunk], H, W)
              for boxes in st["boxes"] for s in range(0, len(boxes), chunk)]
    return float(np.mean(bounds)) / (seconds / n) * 100
