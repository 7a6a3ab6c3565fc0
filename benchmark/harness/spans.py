"""Reading the program's spans and counters beside the device trace.

The program records them while its tracing is on
(nn_bvh_tpu_torch/utils/stats.py: `enable()`, then `collect()` ->
{"spans", "counters"}). A span has its name, host start and end (t0_ns,
t1_ns, Unix-epoch ns: the clock of kineto's event times), its parent's
index in the list (-1 at the top), its unit (image, wave, step, rank), a
`sync` flag for host reads that wait for the device, and its device
stretch `device_ms` (CUDA events at entry and exit, idle inside it
included). Here:

- `self_ms`: a span's stretch less its children's;
- `per_unit`: device stretches summed by unit;
- `idle_by_span`: each idle gap between a stretch's device events (as
  trace.summary finds them: gaps in the union of the events' intervals)
  put down to the innermost program span open on the host when the gap
  began;
- `render_metrics`, `learner_metrics`: a traced stretch's per-layer
  numbers, under the names of their metrics;
- `band_gather_ms`: the bands' gather of render_sharded, over the ranks.
"""

from __future__ import annotations

import bisect
import statistics

# the shading stages of a Path wave: their self stretches leave out the
# traversal (isect.*), the re-sort and the host reads (sync.*)
SHADE = ("wave.tables", "wave.camera", "bounce.emission", "bounce.material", "bounce.light",
         "bounce.bsdf", "wave.tail", "wave.film")
OUTSIDE = "(no span)"


def self_ms(spans: list) -> list:
    """Each span's device stretch less its children's (ms; 0 without CUDA
    events)."""
    own = [s["device_ms"] or 0.0 for s in spans]
    for s in spans:
        if s["parent"] >= 0:
            own[s["parent"]] -= s["device_ms"] or 0.0
    return own


def per_unit(spans: list, names, key: str) -> dict:
    """{unit field `key`'s value: the sum of device_ms over the spans named
    in `names`}."""
    out = {}
    for s in spans:
        if s["name"] in names:
            out[s[key]] = out.get(s[key], 0.0) + (s["device_ms"] or 0.0)
    return out


def idle_gaps(events: list) -> list:
    """[(start_ns, length_ns)] of the gaps in the union of the device events'
    intervals ((name, start_ns, end_ns), by start)."""
    gaps = []
    if not events:
        return gaps
    cur_e = events[0][2]
    for _, s, e in events:
        if s > cur_e:
            gaps.append((cur_e, s - cur_e))
        cur_e = max(cur_e, e)
    return gaps


def open_at(spans: list, t0s: list, t: int) -> int:
    """The index of the innermost span open at host time t (-1: none). The
    spans are in entry order and nest, so it is the latest one started by
    t or one of its ancestors."""
    i = bisect.bisect_right(t0s, t) - 1
    while i >= 0 and spans[i]["t1_ns"] <= t:
        i = spans[i]["parent"]
    return i


def idle_by_span(events: list, spans: list) -> dict:
    """-> {"by_name": {span name: idle s}, "sync_s": idle in gaps that began
    inside a sync span (or a span within one), "idle_s": all idle}."""
    t0s = [s["t0_ns"] for s in spans]
    by, sync, total = {}, 0, 0
    for start, length in idle_gaps(events):
        i = open_at(spans, t0s, start)
        name = spans[i]["name"] if i >= 0 else OUTSIDE
        by[name] = by.get(name, 0) + length
        total += length
        while i >= 0:
            if spans[i]["sync"]:
                sync += length
                break
            i = spans[i]["parent"]
    return {"by_name": {k: v * 1e-9 for k, v in by.items()}, "sync_s": sync * 1e-9,
            "idle_s": total * 1e-9}


def top_idle(idle: dict, top: int = 10) -> list:
    """[[span name, idle s]] of the `top` spans that hold the most idle."""
    return [[k, v] for k, v in sorted(idle["by_name"].items(), key=lambda kv: -kv[1])[:top]]


def _sync_pct(idle: dict):
    return 100.0 * idle["sync_s"] / idle["idle_s"] if idle["idle_s"] > 0 else None


def render_metrics(col: dict, events: list, window_images: int, trace_image: int,
                   trace_waves) -> dict:
    """The render cells' numbers from one rank's collect() and the device
    events of its traced stretch: the waves `trace_waves` (sample indices)
    of image `trace_image`, and the window's images 0 .. window_images - 1.
    Keys: shade_ms_per_wave, resort_ms_per_wave, live_lane_pct,
    sync_idle_pct.render, image_setup_ms, idle_top."""
    spans = col["spans"]
    waves = set(trace_waves)
    n = len(waves)
    traced = [i for i, s in enumerate(spans) if s["image"] == trace_image and s["wave"] in waves]
    own = self_ms(spans)
    pick = lambda names, vals: sum(vals[i] for i in traced if spans[i]["name"] in names)
    out = {"shade_ms_per_wave": pick(SHADE, own) / n,
           "resort_ms_per_wave": pick(("bounce.resort",),
                                      [s["device_ms"] or 0.0 for s in spans]) / n}
    cnt = {}
    for c in col["counters"]:
        if c["image"] == trace_image and c["wave"] in waves:
            cnt[c["name"]] = cnt.get(c["name"], 0.0) + c["value"]
    if cnt.get("lanes/processed"):
        out["live_lane_pct"] = 100.0 * (cnt.get("rays/camera rays", 0.0)
                                        + cnt.get("rays/indirect rays", 0.0)) \
            / cnt["lanes/processed"]
    idle = idle_by_span(events, spans)
    out["sync_idle_pct.render"] = _sync_pct(idle)
    setup = [(s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in spans
             if s["name"] == "image.setup" and 0 <= s["image"] < window_images]
    out["image_setup_ms"] = statistics.median(setup) if setup else None
    out["idle_top"] = top_idle(idle)
    return out


def learner_metrics(col: dict, events: list, trace_steps: int) -> dict:
    """The learner cells' numbers from collect() and the device events of
    the traced stretch, its last `trace_steps` steps. Keys:
    fwd_ms_per_step, bwd_ms_per_step, update_ms_per_step,
    sync_idle_pct.train, idle_top."""
    spans = col["spans"]
    last = max((s["step"] for s in spans), default=-1)
    steps = set(range(last - trace_steps + 1, last + 1))
    out = {}
    for key, name in (("fwd_ms_per_step", "step.forward"), ("bwd_ms_per_step", "step.backward"),
                      ("update_ms_per_step", "step.update")):
        by = per_unit([s for s in spans if s["step"] in steps], (name,), "step")
        out[key] = sum(by.values()) / trace_steps if len(by) == trace_steps else None
    idle = idle_by_span(events, spans)
    out["sync_idle_pct.train"] = _sync_pct(idle)
    out["idle_top"] = top_idle(idle)
    return out


GATHER_SPANS = ("band.to_host", "image.develop")


def band_spans(col: dict) -> list:
    """The spans band_gather_ms reads, to send to rank 0."""
    return [{k: s[k] for k in ("name", "image", "rank", "t1_ns")} for s in col["spans"]
            if s["name"] in GATHER_SPANS]


def band_gather_ms(per_rank: list, window_images: int):
    """The median over the window's images of the time from the latest
    band.to_host end over the ranks (the last band on the host) to rank 0's
    image.develop end (ms; host clock, one host). `per_rank`: each rank's
    band_spans, rank 0 first."""
    out = []
    for img in range(window_images):
        ends = [s["t1_ns"] for spans in per_rank for s in spans
                if s["name"] == "band.to_host" and s["image"] == img]
        dev = [s["t1_ns"] for s in per_rank[0]
               if s["name"] == "image.develop" and s["image"] == img]
        if ends and dev:
            out.append((max(dev) - max(ends)) * 1e-6)
    return statistics.median(out) if out else None


def mean_over_ranks(per_rank: list, keys) -> dict:
    """{key: the mean over the ranks' values} of the keys every rank has."""
    out = {}
    for k in keys:
        vals = [r.get(k) for r in per_rank]
        if vals and all(v is not None for v in vals):
            out[k] = sum(vals) / len(vals)
    return out
