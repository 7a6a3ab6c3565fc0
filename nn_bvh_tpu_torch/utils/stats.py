"""The port's tracing: spans and counters on the device trace's clock, and
the --stats report (render_report, RENDER_COUNTERS: the JAX package's
nn_bvh_tpu/utils/stats.py).

Off by default: `enable()` turns it on, `disable()` off, `collect()`
returns what was recorded and `clear()` drops it.

- `span(name, sync=False, **attrs)`: a context manager that records the
  name, the host start and end (time.time_ns(), the Unix-epoch clock of
  kineto's event times), the enclosing span, the current unit (`advance`,
  `set_unit`: image and wave for the renderer, step for the learner, and
  the rank) and the attributes. With CUDA it also records a CUDA event on
  the current stream at entry and at exit: their elapsed time is the
  span's device stretch, idle inside it included, so the stretches of
  consecutive spans add up to the stretch that holds them. `sync=True`
  flags a span around a host read that waits for the device.
- `count(name, n)`: adds n, a number or a tensor summed on its own
  device, to the counter `name` of the current unit; device sums are read
  once, at collect().

When off, `span` returns one shared null context and `count`, `advance`
and `set_unit` return at once: no CUDA event, tensor op, host read or
list append.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

# the renderer's canonical counters (the JAX package's)
RENDER_COUNTERS = (
    "rays/camera rays",
    "rays/indirect rays",
    "rays/shadow rays",
    "intersections/hits",
    "paths/terminated by RR",
    "paths/reached max depth",
)
# the dense batch's lanes, live or dead, per segment the wave runs
COUNTERS = RENDER_COUNTERS + ("lanes/processed",)
UNIT_FIELDS = ("image", "wave", "step", "rank")

_NULL = contextlib.nullcontext()
_on = False
_cuda = False
_spans: list = []    # [name, t0_ns, t1_ns, parent, unit, attrs, sync, event0, event1]
_open: list = []     # indices of the open spans, innermost last
_counts: dict = {}   # (name, unit) -> [amounts]
_unit = (-1, None, -1, 0)


def enable(cuda: bool | None = None) -> None:
    """Turn tracing on; `cuda` (default: a card is available) records the
    spans' CUDA events. The rank starts as torch.distributed's, if a group
    is up."""
    global _on, _cuda
    _on = True
    _cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        set_unit(rank=dist.get_rank())


def disable() -> None:
    global _on
    _on = False


def clear() -> None:
    """Drop every span and counter and reset the unit."""
    global _unit
    _spans.clear()
    _open.clear()
    _counts.clear()
    _unit = (-1, None, -1, _unit[3])


def advance(kind: str) -> None:
    """Start the next image ("image", its wave unset) or step ("step")."""
    global _unit
    if not _on:
        return
    image, _, step, rank = _unit
    if kind == "image":
        _unit = (image + 1, None, step, rank)
    elif kind == "step":
        _unit = (image, None, step + 1, rank)
    else:
        raise ValueError(f"unit kind {kind!r} is not 'image' or 'step'")


def set_unit(**fields) -> None:
    """Set fields of the current unit (wave, rank, ...)."""
    global _unit
    if not _on:
        return
    u = dict(zip(UNIT_FIELDS, _unit))
    for k, v in fields.items():
        if k not in u:
            raise KeyError(f"unit field {k!r} is not one of {UNIT_FIELDS}")
        u[k] = v
    _unit = tuple(u[k] for k in UNIT_FIELDS)


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, sync: bool, attrs: dict):
        self.rec = [name, 0, 0, -1, _unit, attrs, sync, None, None]

    def __enter__(self):
        # the event first and the bookkeeping inside: on a launch-bound
        # stream the host time between one span's exit event and the next
        # one's entry event is device idle that no span holds
        r = self.rec
        if _cuda:
            r[7] = torch.cuda.Event(enable_timing=True)
            r[7].record()
        r[1] = time.time_ns()
        r[3] = _open[-1] if _open else -1
        _open.append(len(_spans))
        _spans.append(r)
        return self

    def __exit__(self, *exc):
        r = self.rec
        if _cuda:
            r[8] = torch.cuda.Event(enable_timing=True)
            r[8].record()
        r[2] = time.time_ns()
        if _open:
            _open.pop()
        return False


def span(name: str, sync: bool = False, **attrs):
    """A span named `name` around a `with` block (the shared null context
    when tracing is off)."""
    if not _on:
        return _NULL
    return _Span(name, sync, attrs)


def count(name: str, n) -> None:
    """Add n to the counter `name` of the current unit: a number, or a
    tensor whose sum (a boolean mask counts its True lanes) is taken on its
    device and read at collect()."""
    if not _on:
        return
    if name not in COUNTERS:
        raise KeyError(f"unknown counter {name!r}")
    if isinstance(n, torch.Tensor):
        n = n.sum()
    _counts.setdefault((name, _unit), []).append(n)


def _read(amounts: list) -> list:
    """The amounts as floats: the device tensors of each device stacked and
    read in one transfer."""
    out = [None if isinstance(a, torch.Tensor) else float(a) for a in amounts]
    by_dev: Dict[torch.device, list] = {}
    for i, a in enumerate(amounts):
        if isinstance(a, torch.Tensor):
            by_dev.setdefault(a.device, []).append(i)
    for idx in by_dev.values():
        vals = torch.stack([amounts[i].to(torch.float64) for i in idx]).tolist()
        for i, v in zip(idx, vals):
            out[i] = v
    return out


def _f32_sum(values) -> float:
    """The float32 sum in order, as the JAX package's counters add."""
    acc = np.float32(0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return float(acc)


def collect() -> dict:
    """-> {"spans": [...], "counters": [...]}, each a dict with the unit's
    fields. A span: name, t0_ns, t1_ns (host), parent (index into the list,
    -1 at the top), sync, device_ms (its CUDA events' elapsed time; None
    without them) and its attributes. A counter: name and value (float32
    sum). Waits for the recorded events and reads the device counters."""
    spans = []
    for name, t0, t1, parent, unit, attrs, sync, e0, e1 in _spans:
        ms = None
        if e0 is not None and e1 is not None:
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        spans.append(dict(zip(UNIT_FIELDS, unit), name=name, t0_ns=t0, t1_ns=t1,
                          parent=parent, sync=sync, device_ms=ms, **attrs))
    keys = list(_counts)
    flat = _read([a for k in keys for a in _counts[k]])
    counters, at = [], 0
    for name, unit in keys:
        n = len(_counts[(name, unit)])
        counters.append(dict(zip(UNIT_FIELDS, unit), name=name,
                             value=_f32_sum(flat[at:at + n])))
        at += n
    return {"spans": spans, "counters": counters}


def totals(collected: dict) -> Dict[str, float]:
    """{counter name: float32 sum over units} of collect()'s counters, the
    input of render_report."""
    by: Dict[str, list] = {}
    for c in collected["counters"]:
        by.setdefault(c["name"], []).append(c["value"])
    return {k: _f32_sum(v) for k, v in by.items()}


def render_report(counters: Dict[str, float]) -> str:
    """The report: "Statistics:", then each category ("cat/name" keys,
    sorted) with its counters."""
    lines = ["Statistics:"]
    groups: Dict[str, list] = {}
    for k, v in sorted(counters.items()):
        cat, _, name = k.partition("/")
        groups.setdefault(cat, []).append((name or cat, float(v)))
    for cat, items in groups.items():
        lines.append(f"  {cat}")
        for name, v in items:
            lines.append(f"    {name:<40} {v:,.0f}")
    return "\n".join(lines)
