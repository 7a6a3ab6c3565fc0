"""Run one cell of the benchmark of nn_bvh_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device, with
--trace 1 the breakdown of the traced stretch, and last the numbers that
decided `correct`, each beside its limit; the same numbers end standard
error. A cell on several chips starts one process per chip (rank 0 writes
the line, which this process passes on), its collectives over gloo on a
free localhost port.

Exits non-zero without a result when CUDA is unavailable or has fewer
cards than the cell asks for, or when a module of JAX or of the JAX
package (`nn_bvh_tpu`, compared by its whole top-level name) is loaded in
any rank or in the process that starts them.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
for _p in (CHECKOUT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import spec as spec_mod  # noqa: E402


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own build/kernels and build/native are there already)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CHECKOUT, "build", sub)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, rank: int = 0,
             world: int = 1, port: int = 0, t0: float | None = None, overrides=None,
             bench_dir: str = BENCH_DIR) -> dict | None:
    """One run of cell `name` -> the result dict (None on ranks above 0).
    `device` None runs on this rank's CUDA card; tests pass the CPU and
    `overrides` ({"traffic": {...}, "config": {...}}) to shrink a cell."""
    sp = spec_mod.load_cell(name, bench_dir)
    for key, upd in (overrides or {}).items():
        getattr(sp, key).update(upd)
    ctx = spec_mod.context(name=name, cell=sp.cell, config=sp.config, traffic=sp.traffic,
                           seed=int(seed), seconds=float(seconds), trace=bool(trace),
                           device=device, rank=rank, world=world, port=port,
                           t0=T0 if t0 is None else t0)
    rec = sp.driver.run(ctx)
    if rank != 0:
        return None
    checks = rec["checks"]
    correct = bool(checks) and all(v is not None and v <= lim for _, v, lim in checks)
    metrics = spec_mod.read_metrics(sp.per_layer if trace else sp.end_to_end, rec, bench_dir)
    dev = rec["device"]
    out = {"correct": correct, "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def forbidden_on_every_rank(world: int) -> list:
    """The modules of JAX or the JAX package loaded in this process and,
    with several ranks, in any rank's (gathered over the cell's process
    group, which every rank reaches once its run is done)."""
    bad = spec_mod.forbidden_modules(list(sys.modules))
    if world <= 1:
        return bad
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("the ranks' modules cannot be gathered: no process group")
    every = [None] * world
    dist.all_gather_object(every, bad)
    return sorted(set().union(*every))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args, chips: int) -> int:
    """One process per chip, each this script with --rank; waits for all,
    then passes rank 0's standard output on if every rank ended with 0 and
    this process loaded nothing of JAX."""
    port = _free_port()
    env = dict(os.environ, BENCH_T0=repr(T0))
    procs = []
    for r in range(chips):
        argv = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
                str(args.trace), "--rank", str(r), "--world", str(chips), "--port", str(port)]
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE if r == 0
                                      else subprocess.DEVNULL, text=r == 0))
    rcs, out = [], ""
    try:
        out = procs[0].communicate(timeout=1500)[0]
        rcs = [procs[0].returncode] + [p.wait(timeout=1500) for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if _refused(spec_mod.forbidden_modules(list(sys.modules))):
        return 3
    if out and rcs and max(rcs) == 0:
        sys.stdout.write(out)
        sys.stdout.flush()
    return max(rcs) if rcs else 1


def _refused(bad: list) -> bool:
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
    return bool(bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _caches()
    chips = spec_mod.load_cell(args.workload).chips

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    if chips > 1 and args.rank is None:
        return _spawn(args, chips)
    rank = args.rank or 0
    t0 = float(os.environ.get("BENCH_T0", T0)) if args.rank is not None else T0
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), rank=rank,
                   world=args.world, port=args.port, t0=t0)
    if _refused(forbidden_on_every_rank(args.world)):
        return 3
    if out is None:
        return 0
    for n, c in out["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
