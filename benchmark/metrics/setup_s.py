"""setup_s: seconds from process start to the window's start (host clock)."""


def read(rec):
    return rec.get("setup_s")
