"""The whole video step's share of the card's f32 peak: model FLOPs of the
frames completed in the traced stretch (whole clips) over the stretch's
time over 67 TFLOP/s (the configurations run with TF32 off). The FLOPs are
benchmark/costs.py's, counted from shapes: YOLOv3 on the 416x288 letterbox
when the configuration has a detector, ResNet-50 + IEF on one 224 crop."""

from benchmark import costs

MOVES = "frames_per_s"


def read(run):
    st, tr = run.stretch, run.trace
    if tr is None or not st.get("frames"):
        return None
    flops = st["frames"] * costs.frame_flops(st["frame_hw"], st["detector"])
    return flops / tr.window_s / costs.F32_FLOPS_PER_S * 100
