"""trav_roofline_pct: the bound of one wave's traversal batches (the
benchmark's plain walk's tests and the records it read, at the float32 and
HBM peaks of harness/yardstick.py) over the device time of all the
intersector's calls of a wave, in %."""


def read(rec):
    b, t = rec.get("trav_bound_ms_per_wave"), rec.get("isect_ms_per_wave")
    if not b or not t:
        return None
    return 100.0 * b / t
