"""steps_per_s: optimizer steps completed in the window over its wall time
(host clock, closed by a synchronize)."""


def read(rec):
    if rec.get("unit") != "step" or not rec.get("window_s"):
        return None
    return rec["steps"] / rec["window_s"]
