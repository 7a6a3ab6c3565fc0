"""samples_per_s: pixel samples of the images completed in the window,
summed over ranks, over the window's wall time (host clock, closed by a
synchronize)."""


def read(rec):
    if rec.get("unit") != "wave" or not rec.get("window_s"):
        return None
    return rec["samples"] / rec["window_s"]
