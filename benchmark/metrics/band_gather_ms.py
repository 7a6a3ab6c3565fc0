"""band_gather_ms: from the latest end of a rank's band.to_host span (its
band on the host, every wave of it done) to the end of rank 0's
image.develop span, in ms (host clock, one host for all ranks); the median
over the window's images (harness/spans.band_gather_ms)."""


def read(rec):
    return rec.get("band_gather_ms")
