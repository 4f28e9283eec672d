"""YoloDetector's time per 64 frames: the harness's host-clock span around each
detector(frames) call of the traced run's window (the call returns host
arrays, so the span holds its device work), summed over the window and
divided by its frames."""

MOVES = "frames_per_s"
SPAN = "detector"
PER_FRAMES = 64


def read(run):
    spans = run.spans.get(SPAN) or []
    seconds = sum(s for s, _ in spans)
    frames = sum(n for _, n in spans)
    if not frames:
        return None
    return seconds / frames * PER_FRAMES * 1e3
