"""resort_ms_per_wave: the device stretch (ms) per traced wave of the
program's bounce.resort spans: the per-bounce ray sort key, its argsort and
the gathers that permute the lane state; the mean over the ranks where
sharded."""


def read(rec):
    return rec.get("resort_ms_per_wave")
