"""Finding a cell's pieces by name, each in a file of its own.

- `BENCHMARK.json` at the checkout's root: the cells, the end-to-end and
  per-layer metrics;
- `workloads/<cell>.json`: the cell's configuration, traffic and chips,
  and how its answers are checked;
- `configs/<config>.json`: the configuration as it is run;
- `traffic/<mix>.json`: the mix's parameters, and under "driver" the name
  of the module `traffic/<driver>.py` that generates and runs it;
- `metrics/<metric>.py`: a reader `read(rec) -> float | None` of one
  metric from a run's record.

A later change adds a cell, a mix, a driver or a metric as new files; no
existing file needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import SimpleNamespace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_dir: str = BENCH_DIR, benchmark: dict | None = None):
    """The cell `name` -> namespace(name, cell, config, traffic, driver,
    chips, end_to_end, per_layer). Its entry in BENCHMARK.json, when the
    file lists it, has to agree with its workload file."""
    cell = read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    if benchmark is None:
        path = os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
        benchmark = read_json(path) if os.path.exists(path) else {}
    entry = next((w for w in benchmark.get("workloads", []) if w["name"] == name), None)
    if entry is not None:
        for key in ("config", "traffic", "chips"):
            if entry[key] != cell[key]:
                raise ValueError(f"cell {name}: BENCHMARK.json has {key}={entry[key]!r}, "
                                 f"workloads/{name}.json {cell[key]!r}")
    config = read_json(os.path.join(bench_dir, "configs", f"{cell['config']}.json"))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
    driver = load_module(os.path.join(bench_dir, "traffic", f"{traffic['driver']}.py"),
                         f"bench_driver_{traffic['driver']}")
    pick = lambda ms: [m for m in ms if "workloads" not in m or name in m["workloads"]]
    return SimpleNamespace(name=name, cell=cell, config=config, traffic=traffic,
                           driver=driver, chips=int(cell["chips"]),
                           end_to_end=pick(benchmark.get("end_to_end", [])),
                           per_layer=pick(benchmark.get("per_layer", [])))


def read_metrics(metrics: list, rec: dict, bench_dir: str = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something in `rec`."""
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


FORBIDDEN = ("jax", "jaxlib", "flax", "nn_bvh_tpu")


def forbidden_modules(names) -> list:
    """The modules among `names` whose top-level name (before the first
    dot), compared whole, is the JAX package's, JAX's or flax's."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def context(**kw) -> SimpleNamespace:
    return SimpleNamespace(**kw)
