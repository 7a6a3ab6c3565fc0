"""sync_idle_pct.render: the share (%) of the traced waves' idle device
time (gaps in the union of their device events) in gaps that begin while
the host is inside a program span flagged sync (a host read that waits
for the device), by harness/spans.idle_by_span; the mean over the ranks
where sharded."""


def read(rec):
    return rec.get("sync_idle_pct.render")
