"""wave_ms_p90: the 90th percentile, over every wave of the window on every
rank, of the time between consecutive wave-boundary CUDA events (ms)."""

import statistics


def read(rec):
    ms = rec.get("wave_ms") if rec.get("unit") == "wave" else None
    if not ms or len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
