"""The scorers' time per 64 frames: the harness's host-clock span around the
REBA and RULA scorer calls of the traced run's window, summed and divided
by its frames."""

MOVES = "frames_per_s"
SPAN = "score"
PER_FRAMES = 64


def read(run):
    spans = run.spans.get(SPAN) or []
    seconds = sum(s for s, _ in spans)
    frames = sum(n for _, n in spans)
    if not frames:
        return None
    return seconds / frames * PER_FRAMES * 1e3
