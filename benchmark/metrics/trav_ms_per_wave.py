"""trav_ms_per_wave: device time (ms) per wave of the traversal backend's
calls, by CUDA events around the callable in a subclass of the program's
dispatch.Intersectors handed to make_wave_fn."""


def read(rec):
    return rec.get("trav_ms_per_wave")
