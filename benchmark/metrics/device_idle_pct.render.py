"""device_idle_pct.render: the share (%) of the traced waves' stretch, from
the first device event to the last (rank 0), in which no kernel or copy
runs: one minus the union of the events' intervals over the stretch."""


def read(rec):
    t = rec.get("trace") if rec.get("unit") == "wave" else None
    if not t or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
