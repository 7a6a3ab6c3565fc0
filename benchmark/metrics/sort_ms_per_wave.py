"""sort_ms_per_wave: device time (ms) per traced wave of the kernels whose
name holds "sort": the radix sort of the per-bounce ray re-sort."""


def read(rec):
    t = rec.get("trace") if rec.get("unit") == "wave" else None
    if not t or t["sort_s"] <= 0:
        return None
    return t["sort_s"] * 1e3 / rec["trace_units"]
