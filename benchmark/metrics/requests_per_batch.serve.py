"""PoseScoringServer's coalescing: requests over batches dispatched in the
traced run's window, from the differences of stats()' exact counters."""

MOVES = "latency_p95_ms"


def read(run):
    s = run.serve
    if not s.get("batches"):
        return None
    return s["requests"] / s["batches"]
