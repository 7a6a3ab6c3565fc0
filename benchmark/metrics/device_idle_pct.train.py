"""device_idle_pct.train: as device_idle_pct.render, over the traced
training steps."""


def read(rec):
    t = rec.get("trace") if rec.get("unit") == "step" else None
    if not t or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
