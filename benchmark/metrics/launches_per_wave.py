"""launches_per_wave: CUDA kernels and copies per wave, counted from the
device events of the traced waves (rank 0)."""


def read(rec):
    if rec.get("unit") != "wave" or not rec.get("trace"):
        return None
    return rec["trace"]["n"] / rec["trace_units"]
