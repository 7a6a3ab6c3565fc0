"""live_lane_pct: the live lanes of the traced waves' bounces (the
program's counters rays/camera rays + rays/indirect rays) over the lanes
the dense batch shaded (lanes/processed: the wave's lanes per bounce run),
in %; the mean over the ranks where sharded."""


def read(rec):
    return rec.get("live_lane_pct")
