"""gather_ms: the bands' gather over gloo and the develop of an image, in
ms: from the last rank's last wave callback to render_sharded's return on
rank 0 (host clock, one host for all ranks); median over the window's
images. The wait for the slowest band comes before it (band_skew_pct)."""


def read(rec):
    return rec.get("gather_ms")
