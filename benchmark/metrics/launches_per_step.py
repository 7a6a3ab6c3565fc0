"""launches_per_step: CUDA kernels and copies per training step, counted
from the device events of the traced steps."""


def read(rec):
    if rec.get("unit") != "step" or not rec.get("trace"):
        return None
    return rec["trace"]["n"] / rec["trace_units"]
