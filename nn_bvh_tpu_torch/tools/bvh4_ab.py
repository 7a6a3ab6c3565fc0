"""Device time of BVH4 traversal kernel sources, side by side, on the ray
batches of the bench wave.

    python -m nn_bvh_tpu_torch.tools.bvh4_ab [LABEL=PATH[:33] ...] [--json PATH]

Each PATH is a CUDA source with the C entry `bvh4_traverse` of
csrc/bvh4_traverse.cu (the same signature and node table); `:33` marks one
that reads (N, 3, 3) vertex triangles, otherwise it reads the 16-byte
records of `bvh4.pack_tris_cuda`. The tree's own kernel is always there,
labelled "tree". Every source is built with `kernels.NVCC_FLAGS` (and `-I`
the package's csrc/ and the source's own directory) and its ptxas report is
printed. On the bench scene (`bench_scene.build_bench_scene`), the nine
batches of one bench wave (`bench_scene.wave_batches`) and chip_smoke phase
3's four ("probe camera" and "probe incoherent" rays, closest and any-hit)
go through `bench_scene.time_traversals`: every kernel held against the
plain traversal, then read twice by `bench_scene.device_ms` in turns around
the others, with the plain walk's per-warp work, the bound, the host time of
a call and torch.profiler's time on two batches beside it.

Needs a CUDA card (exits 1 without one). The last line of standard output
is one JSON object with the summary, the card's name and its power limit;
--json PATH writes the full report (every reading of every batch) there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import kernels
from ..accel import bvh4_kernel, dispatch, kernel_launch
from . import bench_scene as bs


def build_sources(sources: dict) -> dict:
    """{label: path} -> {label: (C entry, ptxas report)}, built at once."""
    out_dir = os.path.join(kernels.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for label, path in sources.items():
        so = os.path.join(out_dir, f"lib{label}.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-I",
               os.path.dirname(os.path.abspath(path)), "-o", so, path]
        procs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    built = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{err}")
        fn = ctypes.CDLL(so).bvh4_traverse
        fn.argtypes = kernel_launch.ARGTYPES
        fn.restype = ctypes.c_int
        built[label] = (fn, err)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="LABEL=PATH[:33]")
    ap.add_argument("--json", help="write the full report to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bvh4_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    paths, vertex_tris = {}, set()
    for spec in args.sources:
        label, path = spec.split("=", 1)
        if path.endswith(":33"):
            vertex_tris.add(label)
            path = path[:-3]
        paths[label] = path
    paths["tree"] = os.path.join(kernels.CSRC, "bvh4_traverse.cu")
    built = build_sources(paths)
    ptxas = {label: kernels.ptxas_lines(log) for label, (_, log) in built.items()}
    for label, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {label}: {line}", flush=True)

    sc, dbvh, cam = bs.build_bench_scene()
    k_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="cuda_bvh4")
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    nodes, rec_tris = k_isect.tables

    def kernel_fn(label):
        fn = built[label][0]
        tris, shape = ((p_isect.tables[1], (None, 3, 3)) if label in vertex_tris
                       else (rec_tris, bvh4_kernel.TRI_SHAPE))
        return lambda o, d, t, a: kernel_launch.launch(fn, f"ab:{label}", nodes, (None, 4, 8),
                                                       tris, shape, o, d, t, a)

    wave = bs.wave_batches(sc, dbvh, cam, dev)
    wave_names = bs.wave_batch_names(wave)
    batches = dict(zip(wave_names, wave))
    for name, (o, d, t_max) in bs.probe_batches(sc, cam, dev).items():
        batches[f"probe {name} closest"] = (o, d, t_max, False)
        batches[f"probe {name} any"] = (o, d, t_max, True)
    fns = {label: kernel_fn(label) for label in built}
    rows = bs.time_traversals(fns, batches, p_isect)

    for name, row in rows.items():
        print(f"{name:24s} live {row['live']:7d}  nodes/lane {row['nodes_mean']:.2f} "
              f"p99 {row['nodes_p99']:.0f} max {row['nodes_max']}  tris/lane "
              f"{row['tris_mean']:.2f} max {row['tris_max']}  warp max nodes "
              f"{row['warp_nodes']:.2f} tris {row['warp_tris']:.2f}  bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}; {row['work']})  ties "
              f"{row['ties']}", flush=True)
    print(f"\n{'batch':24s}" + "".join(f"{lb:>22s}" for lb in fns) + "   bound", flush=True)
    for name, row in rows.items():
        cells = "".join(f"{min(v):10.4f}/{max(v):<10.4f} " for v in row["device_ms"].values())
        print(f"{name:24s}{cells}  {row['bound_ms']:.6f}", flush=True)
    summary = {}
    for label in fns:
        summary[label] = {
            "wave_ms": sum(bs.mean_ms(rows[n], label) for n in wave_names),
            "wave_host_us": sum(rows[n]["host_us"][label] for n in wave_names),
            "probe_ms": {n: bs.mean_ms(rows[n], label) for n in rows if n not in wave_names},
            "profiler_us": {n: rows[n]["profiler_us"][label] for n in bs.PROFILED}}
        print(f"{label}: traversal device ms per wave {summary[label]['wave_ms']:.4f}, host us "
              f"per wave {summary[label]['wave_host_us']:.1f}; phase-3 batches "
              f"{summary[label]['probe_ms']}; profiler us {summary[label]['profiler_us']}",
              flush=True)
    wave_bound = sum(rows[n]["bound_ms"] for n in wave_names)
    print(f"bound per wave {wave_bound:.6f} ms", flush=True)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "name_power_limit": smi,
                       "ptxas": ptxas, "batches": rows, "summary": summary,
                       "wave_bound_ms": wave_bound}, f, indent=1)
    print(json.dumps({"bvh4_ab": summary, "wave_bound_ms": wave_bound,
                      "device": torch.cuda.get_device_name(0), "name_power_limit": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
