#!/usr/bin/env python3
"""Smoke run of the torch port (nn_bvh_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the bench configuration of bench.py (400x400
Path integrator, MIS + Russian roulette, depth 4, Sobol 16 spp, power light
sampler, the 52,996-triangle sphere-field scene), through its user entry
points, once per traversal backend, and checks it:

1. environment: a CUDA card is required; prints nvidia-smi's name and power
   limit;
2. build: compiles the three traversal sources of csrc/ with nvcc, one
   process each, all at once; prints their ptxas register / spill lines;
3. BVH4 kernel vs plain: closest-hit and any-hit on 160,000 camera rays and
   160,000 incoherent rays (20% dead lanes), through the CUDA kernel and the
   plain torch traversal; prim / occlusion must agree on >= 99.99% of live
   lanes and every disagreeing lane must be a tie with |dt| <= 1e-4;
   median times of 5 calls by CUDA events;
4. main path: make_wave_fn -> one warm-up wave + 4 timed waves; the image
   must be finite with mean > 0, and the kernel's launch count must equal
   the traversal calls the integrator made (0 < calls <= 9 per wave);
5. the same seed through backend="plain" and the kernel: film XYZ within
   rtol 1e-3 + atol 1e-4 on >= 99.5% of pixels, mean within 0.1%;
6. phase 3 for the binary (stack 64), deep binary (stack 128) and BVH8
   kernels against their plain versions;
7. a synthetic binary tree of depth 100 (too deep for the 64-entry stack,
   whose packer must refuse it) through the deep binary kernel and its plain
   version, with phase 3's checks;
8. one bench wave per new backend through make_wave_fn: launches of its
   kernel = traversal calls, no other kernel launched, film within phase 5's
   tolerance of the cuda_bvh4 film of the same seed;
9. a bound per kernel on the incoherent closest batch: the larger of
   FLOPs / 67 TFLOP/s (float32 outside the tensor cores) and bytes /
   3.35 TB/s, with the box and triangle tests counted by the plain version
   on the same batch.

Any failure raises (exit code != 0). The last two lines of standard output
are a JSON record of the kernels and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

DEPTH = 4
# Work per test, counted from csrc/traverse_common.cuh. A box (slab) test:
# 6 sub + 6 mul, 5 min/max for tn, 5 for tf, 1 mul by 1.0000004, 3 compares
# = 26. A Moller-Trumbore test: 6 sub for the edges, 9 for p, 5 for det,
# 1 compare of |det|, 1 div, 3 sub for s, 6 for b1, 9 for q, 6 for b2, 6 for
# t, 5 compares + 1 add for the hit = 58. The sort of a wide node's children
# is not counted.
FLOPS_SLAB = 26
FLOPS_TRI = 58
PEAK_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# name, CUDA backend, plain twin, source, TPU kernel it replaces
KERNELS = [
    ("bvh4_traverse", "cuda_bvh4", "plain", "nn_bvh_tpu_torch/csrc/bvh4_traverse.cu",
     "nn_bvh_tpu/accel/pallas_bvh4.py:297"),
    ("binary_traverse", "cuda_binary", "plain_binary",
     "nn_bvh_tpu_torch/csrc/binary_traverse.cu", "nn_bvh_tpu/accel/pallas_traverse.py:373"),
    ("binary_traverse_deep", "cuda_binary_deep", "plain_binary_deep",
     "nn_bvh_tpu_torch/csrc/binary_traverse.cu", "nn_bvh_tpu/accel/hbm_traverse.py:255"),
    ("bvh8_traverse", "cuda_bvh8", "plain_bvh8", "nn_bvh_tpu_torch/csrc/bvh8_traverse.cu",
     "nn_bvh_tpu/accel/pallas_bvh8.py:223"),
]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def launch_counts() -> dict:
    from nn_bvh_tpu_torch.accel import kernel_launch

    return dict(kernel_launch.n_launches)


def reset_counts():
    from nn_bvh_tpu_torch.accel import kernel_launch

    kernel_launch.n_launches.clear()


def bench_batches(torch, sc, cam, dev):
    """Camera rays of sample 0 and incoherent rays (origins in the scene box,
    uniform directions), one t_max with 20% dead lanes."""
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

    R = cam.width * cam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    sid = torch.zeros(R, dtype=torch.int32, device=dev)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    u_pix = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_PIXEL), -1)
    u_lens = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_LENS), -1)
    o_cam, d_cam = camera_mod.generate_rays(cam, pix, u_pix, u_lens)
    rs = np.random.RandomState(7)
    lo, hi = np.asarray(sc.bounds)
    o_inc = (lo + rs.rand(R, 3) * (hi - lo)).astype(np.float32)
    d_inc = rs.randn(R, 3).astype(np.float32)
    d_inc /= np.linalg.norm(d_inc, axis=1, keepdims=True)
    dead = rs.rand(R) < 0.2
    t_max = torch.as_tensor(np.where(dead, -1.0, 1e30).astype(np.float32), device=dev)
    return {"camera": (o_cam.contiguous(), d_cam.contiguous(), t_max),
            "incoherent": (torch.as_tensor(o_inc, device=dev),
                           torch.as_tensor(d_inc, device=dev), t_max)}


def compare(torch, label, kernel, plain, o, d, t_max):
    """Kernel vs plain (callables (o, d, t_max, any_hit)) on one batch ->
    (prim agreement, occlusion agreement, max |dt| on agreeing hits, hit rate)."""
    live = t_max > 0
    hk = kernel(o, d, t_max, False)
    hp = plain(o, d, t_max, False)
    torch.cuda.synchronize()
    same = (hk.prim == hp.prim) & live
    agree = same.sum().item() / live.sum().item()
    both = live & (hk.prim >= 0) & (hp.prim >= 0)
    dt = (hk.t - hp.t).abs()
    bad = live & ~same & ~(both & (dt <= 1e-4))
    check(agree >= 0.9999, f"{label} closest: prim agrees on {agree:.6f} of live lanes")
    check(int(bad.sum()) == 0, f"{label} closest: {int(bad.sum())} non-tie disagreements")
    check(bool((hk.prim[~live] == -1).all() and torch.isinf(hk.t[~live]).all()),
          f"{label} closest: dead lanes must miss")
    agreeing = live & same & (hk.prim >= 0)
    err = float(dt[agreeing].max()) if bool(agreeing.any()) else 0.0
    ok_k = kernel(o, d, t_max, True)
    ok_p = plain(o, d, t_max, True)
    occ = ((ok_k == ok_p) & live).sum().item() / live.sum().item()
    check(occ >= 0.9999, f"{label} any-hit: occlusion agrees on {occ:.6f}")
    check(bool(ok_k[~live].all()), f"{label} any-hit: dead lanes must report occluded")
    rate = float(((hk.prim >= 0) & live).sum()) / float(live.sum())
    return agree, occ, err, rate


def phase_kernel_vs_plain(torch, sc, dbvh, batches, dev, backend, plain, phase):
    """Phases 3 and 6 for one kernel -> ({(batch, mode): {kernel, plain ms}},
    max |dt|, the plain Intersectors)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import median_ms

    k_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
    nodes, tris = k_isect.tables
    print(f"phase {phase}: {backend}: node table {tuple(nodes.shape)}, "
          f"{tris.shape[0]} triangle slots")
    results = {}
    max_err = 0.0
    for name, (o, d, t_max) in batches.items():
        kern = lambda *a: k_isect.fn(*k_isect.tables, *a)
        pl = lambda *a: p_isect.fn(*p_isect.tables, *a)
        agree, occ, err, rate = compare(torch, f"{backend} {name}", kern, pl, o, d, t_max)
        max_err = max(max_err, err)
        for mode, any_hit in (("closest", False), ("any_hit", True)):
            times = {"kernel": median_ms(lambda: kern(o, d, t_max, any_hit)),
                     "plain": median_ms(lambda: pl(o, d, t_max, any_hit))}
            results[(name, mode)] = times
            print(f"phase {phase}: {backend} {name} {mode}: kernel {times['kernel']:.4f} ms, "
                  f"plain {times['plain']:.2f} ms (median of 5)")
        print(f"phase {phase}: {backend} {name}: prim agree {agree:.6f}, occlusion agree "
              f"{occ:.6f}, hit rate {rate:.4f}, max |dt| on agreeing hits {err:.3g}")
    return results, max_err, p_isect


def phase_main_path(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=2)
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
    film = film_mod.make_film(cam.height, cam.width, dev)

    reset_counts()
    isect.n_calls = 0
    t0 = time.perf_counter()
    film = wave(film, 0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    n_waves = 4
    t0 = time.perf_counter()
    for s in range(1, 1 + n_waves):
        film = wave(film, s)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.get("bvh4_traverse", 0)
    calls = isect.n_calls

    check(launches == calls, f"kernel launches {launches} != traversal calls {calls}")
    check(0 < launches <= (2 * DEPTH + 1) * (1 + n_waves),
          f"{launches} traversal calls for {1 + n_waves} waves")
    check(sum(counts.values()) == launches, f"other kernels launched: {counts}")
    img = film_mod.develop(film)
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()) and mean > 0, f"bad image, mean {mean}")
    rays_per_s = cam.width * cam.height * (2 * DEPTH + 1) * n_waves / dt
    print(f"phase 4: warm-up wave {warm:.3f} s, {n_waves} waves {dt:.3f} s "
          f"({dt / n_waves * 1e3:.1f} ms/wave), {rays_per_s / 1e6:.3f} Mrays/s "
          f"(R*(2*depth+1)*waves/s), {launches} kernel launches = {calls} "
          f"traversal calls, image mean {mean:.5f}")
    return launches


def one_wave(torch, sc, dbvh, cam, dev, backend):
    """One bench wave (sample 0) through `backend` -> (film XYZ, kernel
    launches by name, traversal calls, seconds)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=2)
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
    film = film_mod.make_film(cam.height, cam.width, dev)
    reset_counts()
    t0 = time.perf_counter()
    xyz = wave(film, 0).xyz
    torch.cuda.synchronize()
    return xyz, launch_counts(), isect.n_calls, time.perf_counter() - t0


def film_agreement(a, b):
    close = ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all(-1).float().mean().item()
    rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-12)
    return close, rel


def phase_same_seed(torch, sc, dbvh, cam, dev):
    films = {}
    for backend in ("plain", "cuda_bvh4"):
        films[backend], _, _, sec = one_wave(torch, sc, dbvh, cam, dev, backend)
        print(f"phase 5: {backend} wave {sec:.3f} s")
    close, rel = film_agreement(films["cuda_bvh4"], films["plain"])
    check(close >= 0.995, f"film XYZ agrees on {close:.5f} of pixels")
    check(rel <= 1e-3, f"film mean differs by {rel:.3g}")
    print(f"phase 5: film XYZ agrees on {close:.6f} of pixels, mean rel diff {rel:.3g}")
    return films["cuda_bvh4"]


def phase_deep_tree(torch, dev, R):
    from nn_bvh_tpu_torch.accel import binary, binary_kernel, traverse
    from nn_bvh_tpu_torch.tools import bench_scene

    levels = 100
    tri, db = bench_scene.build_deep_tree(levels)
    try:
        binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta, 64)
        check(False, "the 64-entry packer accepted a tree of depth 100")
    except ValueError:
        pass
    nodes = torch.as_tensor(binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta, 128),
                            device=dev)
    tris = torch.as_tensor(tri, device=dev)
    o, d, t_max = (torch.as_tensor(x, device=dev)
                   for x in bench_scene.deep_tree_rays(levels, R))
    kern = lambda *a: binary_kernel.traverse(nodes, tris, *a, stack=128)
    pl = lambda *a: traverse.traverse_binary_plain(nodes, tris, *a, stack_depth=128)
    agree, occ, err, rate = compare(torch, "deep tree", kern, pl, o, d, t_max)
    brute = traverse.intersect_brute(tris, o, d, t_max)
    hk = kern(o, d, t_max, False)
    check(bool(torch.equal(hk.prim, brute.prim)), "deep tree: kernel differs from brute force")
    print(f"phase 7: depth-{binary.tree_depth(db.node_meta)} tree, {R} rays: prim agree "
          f"{agree:.6f}, occlusion agree {occ:.6f}, hit rate {rate:.4f}, max |dt| {err:.3g}, "
          f"prims equal to brute force")


def bound_ms(torch, p_isect, o, d, t_max):
    """Least time for the closest-hit batch: max(FLOPs / peak, bytes / peak)
    in ms, with the tests this batch needs counted by the plain version and
    the rays' bytes counted for the lanes the kernel reads them for."""
    counts = {}
    p_isect.fn(*p_isect.tables, o, d, t_max, False, counts=counts)
    slab, tri = int(counts["slab"].sum()), int(counts["tri"].sum())
    flops = slab * FLOPS_SLAB + tri * FLOPS_TRI
    R, live = o.shape[0], int((t_max > 0).sum())
    table_bytes = sum(t.numel() * t.element_size() for t in p_isect.tables)
    # every lane reads t_max and writes t, prim, b1, b2; only a live lane
    # reads its o and d
    nbytes = live * (12 + 12) + R * 4 + R * 16 + table_bytes
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, dict(slab_tests=slab, tri_tests=tri, flops=flops,
                                         bytes=nbytes)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch import kernels
    from nn_bvh_tpu_torch.tools.bench_scene import build_bench_scene

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    sources = ("bvh4_traverse", "binary_traverse", "bvh8_traverse")
    t0 = time.perf_counter()
    kernels.build(*sources)
    for name in sources:
        kernels.load(name)
    print(f"phase 2: built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in kernels.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"phase 2: {name}: {line.strip()}")

    t0 = time.perf_counter()
    sc, dbvh, cam = build_bench_scene()
    print(f"phase 3: bench scene {sc.n_tris} triangles, {sc.n_lights} lights, "
          f"{dbvh.n_nodes} binary nodes, built in {time.perf_counter() - t0:.2f} s")
    check(sc.n_tris == 52996, f"bench scene has {sc.n_tris} triangles, expected 52996")
    batches = bench_batches(torch, sc, cam, dev)
    R = cam.width * cam.height

    rows = {}
    for name, backend, plain, source, replaces in KERNELS:
        phase = 3 if backend == "cuda_bvh4" else 6
        times, max_err, p_isect = phase_kernel_vs_plain(torch, sc, dbvh, batches, dev,
                                                        backend, plain, phase)
        rows[name] = dict(times=times, max_err=max_err, p_isect=p_isect)
        if backend == "cuda_bvh4":
            rows[name]["launches"] = phase_main_path(torch, sc, dbvh, cam, dev)
            ref_film = phase_same_seed(torch, sc, dbvh, cam, dev)
    phase_deep_tree(torch, dev, R)

    for name, backend, *_ in KERNELS[1:]:
        xyz, counts, calls, sec = one_wave(torch, sc, dbvh, cam, dev, backend)
        launches = counts.get(name, 0)
        check(launches == calls and 0 < calls <= 2 * DEPTH + 1,
              f"{backend}: {launches} kernel launches for {calls} traversal calls")
        check(sum(counts.values()) == launches, f"{backend}: other kernels launched: {counts}")
        close, rel = film_agreement(xyz, ref_film)
        check(close >= 0.995 and rel <= 1e-3,
              f"{backend}: film agrees with cuda_bvh4 on {close:.5f} of pixels, "
              f"mean rel diff {rel:.3g}")
        rows[name]["launches"] = launches
        print(f"phase 8: {backend} wave {sec:.3f} s, {launches} kernel launches = {calls} "
              f"traversal calls, film vs cuda_bvh4: {close:.6f} of pixels, mean rel "
              f"diff {rel:.3g}")

    out = []
    o, d, t_max = batches["incoherent"]
    for name, backend, plain, source, replaces in KERNELS:
        row = rows[name]
        bound, by, work = bound_ms(torch, row["p_isect"], o, d, t_max)
        rep = row["times"][("incoherent", "closest")]
        print(f"phase 9: {name}: incoherent closest {rep['kernel']:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {work})")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": row["launches"], "max_abs_err": row["max_err"],
                    "ms": rep["kernel"], "plain_ms": rep["plain"], "bound_ms": bound,
                    "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
