"""Device time of per-ray traversal kernel sources, side by side, on the ray
batches of the bench wave.

    python -m nn_bvh_tpu_torch.tools.bvh4_ab LABEL=PATH[:ENTRY[:LAYOUT]] ... [--check]
        [--json PATH]

Each PATH is a CUDA source with the C entry ENTRY (default `bvh4_traverse`),
of the signature of csrc/*_traverse.cu (`trav::launch`), reading the tables
LAYOUT names (default: the tables of ENTRY's backend in `accel.dispatch`):

- `bvh4`: `bvh4.pack_bvh4_cuda` records (cuda_bvh4's);
- `bvh8`: `bvh8.pack_bvh8_cuda` records (cuda_bvh8's); `bvh8/33` the
  tables of the first BVH8 kernel (commit eb8ad6e): the same records with
  the collapse's own leaf entries -(1 + offset*8 + count-1), and (N, 3, 3)
  triangles;
- `binary`: `binary.pack_binary_pairs` records (cuda_binary's);
- `binary32`: `binary.pack_binary_cuda` 32-byte records (PR 2's kernel and
  the kernel lab's);

with 16-byte triangle records (`bvh4.pack_tris_cuda`), or (N, 3, 3)
vertices when LAYOUT ends in `/33`. The tree's own kernels are named like any
other source, e.g.

    tree=nn_bvh_tpu_torch/csrc/binary_traverse.cu:binary_traverse

Every source is built once with `kernels.NVCC_FLAGS` (and
`-I` the package's csrc/ and the source's own directory, which a quoted
include searches first) and its ptxas report is printed. On the bench scene
(`bench_scene.build_bench_scene`), the nine batches of one bench wave
(`bench_scene.wave_batches`) and chip_smoke phase 3's four ("probe camera"
and "probe incoherent" rays, closest and any-hit) go through
`bench_scene.time_traversals`, once for each family of tables (BVH4, BVH8,
binary): every kernel held against the family's plain traversal (plain,
plain_bvh8, plain_binary), then read twice by `bench_scene.device_ms` in
turns around the others of its family, with the plain walk's per-warp work,
the bound, the device time with L2 flushed before each call, the host time
of a call and torch.profiler's time on two batches beside it. `--check`
stops after the checks.

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

import numpy as np
import torch

from .. import kernels
from ..accel import binary, bvh4, bvh8, dispatch, kernel_launch
from ..geometry.scene import host
from . import bench_scene as bs

# ENTRY -> its default LAYOUT
ENTRY_LAYOUTS = {"bvh4_traverse": "bvh4", "bvh8_traverse": "bvh8",
                 "binary_traverse": "binary", "binary_traverse_deep": "binary"}
# node layout -> (family's plain backend, node shape the kernel is given)
NODE_LAYOUTS = {"bvh4": ("plain", (None, 4, 8)), "bvh8": ("plain_bvh8", (None, 8, 8)),
                "binary": ("plain_binary", (None, 16)),
                "binary32": ("plain_binary", (None, 8))}


def parse_spec(spec: str):
    """"LABEL=PATH[:ENTRY[:LAYOUT]]" -> (label, path, entry, layout)."""
    label, rest = spec.split("=", 1)
    path, entry, layout = (rest.split(":") + [None, None])[:3]
    entry = entry or "bvh4_traverse"
    layout = layout or ENTRY_LAYOUTS[entry]
    if layout.split("/")[0] not in NODE_LAYOUTS or layout.split("/")[1:] not in ([], ["33"]):
        raise ValueError(f"unknown table layout {layout!r}")
    return label, path, entry, layout


def build_sources(paths) -> dict:
    """[path] -> {path: (ctypes library, ptxas report)}, built at once."""
    out_dir = os.path.join(kernels.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for i, path in enumerate(dict.fromkeys(paths)):
        so = os.path.join(out_dir, f"lib{i}_{os.path.basename(path)}.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-I",
               os.path.dirname(os.path.abspath(path)), "-o", so, path]
        procs[path] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    built = {}
    for path, (so, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{err}")
        built[path] = (ctypes.CDLL(so), err)
    return built


def layout_tables(layout: str, sc, dbvh, dev) -> tuple:
    """The (nodes, tris) tensors of LAYOUT on `dev`."""
    kind, _, tri_kind = layout.partition("/")
    n = dbvh.n_nodes
    lo, hi, meta = (host(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    if kind == "binary32":
        nodes = binary.pack_binary_cuda(lo, hi, meta)
    else:
        nodes = dispatch._node_table(kind, dbvh)
        if layout == "bvh8/33":  # the first BVH8 kernel's leaf entries
            nodes[..., 6] = bvh8.collapse_bvh8(lo, hi, meta)[2].astype(np.int32).view(np.float32)
    tri_p = np.ascontiguousarray(host(sc.tri_p), dtype=np.float32)
    tris = tri_p if tri_kind == "33" else bvh4.pack_tris_cuda(tri_p)
    return torch.as_tensor(nodes, device=dev), torch.as_tensor(tris, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="LABEL=PATH[:ENTRY[:LAYOUT]]")
    ap.add_argument("--check", action="store_true", help="build and check, time nothing")
    ap.add_argument("--json", help="write the full report to this file")
    args = ap.parse_args(argv)
    specs = [parse_spec(s) for s in args.sources]
    if not torch.cuda.is_available():
        print("bvh4_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    built = build_sources([path for _, path, _, _ in specs])
    ptxas = {path: kernels.ptxas_lines(log) for path, (_, log) in built.items()}
    for path, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {path}: {line}", flush=True)

    sc, dbvh, cam = bs.build_bench_scene()
    wave = bs.wave_batches(sc, dbvh, cam, dev)
    wave_names = bs.wave_batch_names(wave)
    batches = dict(zip(wave_names, wave))
    for name, (o, d, t_max) in bs.probe_batches(sc, cam, dev).items():
        batches[f"probe {name} closest"] = (o, d, t_max, False)
        batches[f"probe {name} any"] = (o, d, t_max, True)

    tables = {}

    def kernel_fn(label, path, entry, layout):
        fn = getattr(built[path][0], entry)
        fn.argtypes = kernel_launch.ARGTYPES
        fn.restype = ctypes.c_int
        if layout not in tables:
            tables[layout] = layout_tables(layout, sc, dbvh, dev)
        nodes, tris = tables[layout]
        node_shape = NODE_LAYOUTS[layout.split("/")[0]][1]
        return lambda o, d, t, a: kernel_launch.launch(fn, f"ab:{label}", nodes, node_shape,
                                                       tris, (None, *tris.shape[1:]),
                                                       o, d, t, a)

    families = {}  # plain backend -> {label: fn}
    for label, path, entry, layout in specs:
        plain = NODE_LAYOUTS[layout.split("/")[0]][0]
        families.setdefault(plain, {})[label] = kernel_fn(label, path, entry, layout)
    summary, report = {}, {}
    for plain, fns in families.items():
        p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
        rows = bs.time_traversals(fns, batches, p_isect, timed=not args.check)
        report[plain] = rows
        print(f"\n{plain} family: {', '.join(fns)}", flush=True)
        for name, row in rows.items():
            print(f"{name:24s} live {row['live']:7d}  nodes/lane {row['nodes_mean']:.2f} "
                  f"p99 {row['nodes_p99']:.0f} max {row['nodes_max']}  tris/lane "
                  f"{row['tris_mean']:.2f} max {row['tris_max']}  warp max nodes "
                  f"{row['warp_nodes']:.2f} tris {row['warp_tris']:.2f}  bound "
                  f"{row['bound_ms']:.6f} ms ({row['bound_by']}; {row['work']})  ties "
                  f"{row['ties']}", flush=True)
        wave_bound = sum(rows[n]["bound_ms"] for n in wave_names)
        print(f"{plain} family: bound per wave {wave_bound:.6f} ms", flush=True)
        if args.check:
            summary.update({label: {"ties": sum(r["ties"][label] for r in rows.values())}
                            for label in fns})
            continue
        print(f"\n{'batch':24s}" + "".join(f"{lb + ' warm / cold':>30s}" for lb in fns)
              + "   bound", flush=True)
        for name, row in rows.items():
            cells = "".join(f"{min(v):9.4f}/{max(v):<9.4f} {row['cold_ms'][lb]:9.4f} "
                            for lb, v in row["device_ms"].items())
            print(f"{name:24s}{cells}  {row['bound_ms']:.6f}", flush=True)
        for label in fns:
            summary[label] = {
                "wave_ms": sum(bs.mean_ms(rows[n], label) for n in wave_names),
                "wave_bound_ms": wave_bound,
                "wave_cold_ms": sum(rows[n]["cold_ms"][label] for n in wave_names),
                "wave_host_us": sum(rows[n]["host_us"][label] for n in wave_names),
                "ties": sum(r["ties"][label] for r in rows.values()),
                "probe_ms": {n: bs.mean_ms(rows[n], label) for n in rows
                             if n not in wave_names},
                "profiler_us": {n: rows[n]["profiler_us"][label] for n in bs.PROFILED}}
            print(f"{label}: traversal device ms per wave {summary[label]['wave_ms']:.4f} "
                  f"(bound {wave_bound:.6f}; L2 flushed before each call "
                  f"{summary[label]['wave_cold_ms']:.4f}), host us per wave "
                  f"{summary[label]['wave_host_us']:.1f}; phase-3 batches "
                  f"{summary[label]['probe_ms']}; profiler us {summary[label]['profiler_us']}",
                  flush=True)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "name_power_limit": smi,
                       "ptxas": ptxas, "batches": report, "summary": summary}, f, indent=1)
    print(json.dumps({"bvh4_ab": summary, "device": torch.cuda.get_device_name(0),
                      "name_power_limit": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
