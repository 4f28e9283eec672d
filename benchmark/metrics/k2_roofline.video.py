"""K2 (csrc/letterbox_crop.cu, the detector's letterbox) against its roofline:
the bound of one launch on a detector window (benchmark/costs.k2_bound_s:
the larger of its bytes over 3.35 TB/s and ~10 f32 operations per output
over 67 TFLOP/s) over the mean device time of a launch in the traced
stretch, from the profiler."""

from benchmark import costs

MOVES = "frames_per_s"
KERNELS = ("letterbox_crop_kernel",)


def read(run):
    st, tr = run.stretch, run.trace
    if tr is None or not st.get("detector"):
        return None
    n, seconds = tr.kernel_time(lambda name: any(k in name for k in KERNELS))
    if not n or seconds <= 0:
        return None
    H, W = st["frame_hw"]
    return costs.k2_bound_s(st["window"], H, W) / (seconds / n) * 100
