"""Reading the device trace: torch.profiler with CUDA activity only, its
device events taken as kineto hands them over (building prof.events()'s
tree is some twenty times slower on a profile of 100,000s of kernels).

`start()` and `stop(p)` bracket a stretch and return its device events
as (name, start_ns, end_ns); `summary` reduces them to what the
metric readers and the result line need: the count, the busy time (the
union of the events' intervals), the span from the first start to the last
end, the sums by name, and the longest idle gaps, each named by the
operations on either side of it.
"""

from __future__ import annotations


def start():
    """A started profiler of CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    p = profile(activities=[ProfilerActivity.CUDA])
    p.start()
    return p


def stop(p) -> list:
    """Stop `p` (the caller has synchronized) -> its device events as
    (name, start_ns, end_ns), by start."""
    from torch.autograd import DeviceType

    p.stop()
    out = []
    for e in p.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def summary(events: list, top: int = 10) -> dict:
    """-> n, busy_s, span_s, by_name {name: s}, device_ops [[name, s]] (the
    `top` longest by summed time), idle_gaps [[name, s]] (the `top`
    longest), sort_s (kernels whose name holds "sort")."""
    if not events:
        return {"n": 0, "busy_s": 0.0, "span_s": 0.0, "by_name": {}, "device_ops": [],
                "idle_gaps": [], "sort_s": 0.0}
    busy, gaps = 0, []
    cur_s, cur_e, prev_name = events[0][1], events[0][2], events[0][0]
    by_name = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, f"{prev_name[:60]} -> {name[:60]}"))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_name = name
    busy += cur_e - cur_s
    span = max(e for _, _, e in events) - events[0][1]
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"n": len(events), "busy_s": busy * 1e-9, "span_s": span * 1e-9,
            "by_name": {k: v * 1e-9 for k, v in by_name.items()},
            "device_ops": [[k[:120], v * 1e-9] for k, v in ops],
            "idle_gaps": [[name, g * 1e-9] for g, name in gaps[:top]],
            "sort_s": sum(v for k, v in by_name.items() if "sort" in k.lower()) * 1e-9}
