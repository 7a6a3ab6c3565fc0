"""Render statistics counters (port of nn_bvh_tpu/utils/stats.py): a dict
of float32 0-d tensors, bumped functionally by host numbers or tensors on
any device, merged by name and printed as the --stats report. Float32 as
in the JAX package, so that the report strings are the same."""

from __future__ import annotations

from typing import Dict

import torch


def make_counters(names: tuple[str, ...]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros((), dtype=torch.float32) for n in names}


def bump(counters: Dict[str, torch.Tensor], name: str, amount) -> Dict[str, torch.Tensor]:
    """A copy of counters with `amount` added to `name`."""
    out = dict(counters)
    out[name] = counters[name] + torch.as_tensor(amount, dtype=torch.float32)
    return out


def merge(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: a[k] + b[k] for k in a}


def render_report(counters: Dict[str, torch.Tensor]) -> str:
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


# the renderer's canonical counters
RENDER_COUNTERS = (
    "rays/camera rays",
    "rays/indirect rays",
    "rays/shadow rays",
    "intersections/hits",
    "paths/terminated by RR",
    "paths/reached max depth",
)
