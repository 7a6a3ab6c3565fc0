"""sync_idle_pct.train: as sync_idle_pct.render, over the traced
training steps."""


def read(rec):
    return rec.get("sync_idle_pct.train")
