"""The device's idle share over the traced stretch: 1 - the union of kernel
intervals over the stretch's length, from torch.profiler."""

MOVES = "frames_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return (1 - tr.kernel_busy_s / tr.window_s) * 100
