"""PoseScoringServer's padding: 1 - the real requests over the bucket rows
replayed, summed over the (n_real, bucket) pairs of stats()' batch_fill
for the traced run's window."""

MOVES = "latency_p95_ms"


def read(run):
    fills = run.serve.get("fills") or []
    rows = sum(b for _, b in fills)
    if not rows:
        return None
    return (1 - sum(n for n, _ in fills) / rows) * 100
