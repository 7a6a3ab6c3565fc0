"""band_skew_pct: per image, the slowest rank's band time over the ranks'
mean, minus 1, in %; median over the window's images. A rank's band time
of an image is the sum of its waves after the first (CUDA events), since
the first wave's time holds the image's set-up and the wait at the
previous image's gather."""


def read(rec):
    return rec.get("band_skew_pct")
