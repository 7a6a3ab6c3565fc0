#!/usr/bin/env python3
"""Smoke run of the torch port (nn_bvh_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the bench configuration of bench.py (400x400
Path integrator, MIS + Russian roulette, depth 4, Sobol 16 spp, power light
sampler, the 52,996-triangle sphere-field scene), through its user entry
points, once per traversal backend, and checks it:

1. environment: a CUDA card is required; prints nvidia-smi's name and power
   limit;
2. build: compiles the three traversal sources and the lab's of csrc/ with
   nvcc, one process each, all at once; prints their ptxas register / spill
   lines and fails if any kernel spills (the lab's floor and its probe
   too);
3. BVH4 kernel vs plain: closest-hit and any-hit on 160,000 camera rays and
   160,000 incoherent rays (20% dead lanes), through the CUDA kernel and the
   plain torch traversal, under the kernels' contract
   (tools/bench_scene.check_hits): closest-hit t bit-equal on every lane,
   prim, b1, b2 equal wherever prim is, a differing prim only on an exact t
   tie of two hit triangles (tie lanes counted and printed), any-hit
   occlusion equal on every lane, dead lanes miss (closest) or report
   occluded (any-hit). Kernel times are device times (bench_scene.device_ms:
   50 back-to-back calls between two CUDA events, the stream held busy while
   the host enqueues them), with the host's time per call (host_us) and one
   launch between two events (median of 5, host and device time together,
   as earlier rounds timed it); the plain version's median of 5 calls;
4. main path: make_wave_fn -> one warm-up wave + 4 timed waves; the image
   must be finite with mean > 0, and the kernel's launch count must equal
   the traversal calls the integrator made (0 < calls <= 9 per wave);
5. the same seed through backend="plain" and the kernel: film XYZ within
   rtol 1e-3 + atol 1e-4 on >= 99.5% of pixels, mean within 0.1%;
6. phase 3 for the binary (stack 64), deep binary (stack 128) and BVH8
   kernels against their plain versions, the same contract and times;
7. a synthetic binary tree of depth 100 (too deep for the 64-entry stack,
   whose packer must refuse it) through the deep binary kernel and its plain
   version, with phase 3's checks;
8. one bench wave per new backend through make_wave_fn: launches of its
   kernel = traversal calls, no other kernel launched, film within phase 5's
   tolerance of the cuda_bvh4 film of the same seed;
9. a bound per kernel on the incoherent closest batch
   (bench_scene.traversal_bound): the larger of FLOPs / 67 TFLOP/s (float32
   outside the tensor cores) and bytes / 3.35 TB/s, with the box and
   triangle tests, and the node records and triangles read, counted by the
   plain version on the same batch, beside the kernel's device time;
10. the kernel lab's main path (`python -m nn_bvh_tpu_torch.tools.kernel_lab`,
   the bench scene's camera, bounce and shadow classes at R = 65,536):
   launches of lab_traverse, floor_bench and brless_traverse > 0, and one
   of binary_traverse (the camera hits of the ray classes), nothing else;
11. each lab variant (kernel_lab.VARIANTS: lab_traverse rows 8, 16, 32,
   k_pop 2 and 4, no leaf tests, vec; brless_traverse both modes) on each
   class: its time (CUDA events, median of 5) beside cuda_binary's
   (device_ms), the cluster geometry it ran with (kernel_lab.launch_geometry:
   blocks per packet, threads a block) and the microseconds per
   visit of the longest packet (ms / its visits: max cnt, or for brless the
   plain version's count where it ran); its prims against
   cuda_binary's on live lanes (a lane that differs must be a tie, both
   hits, |dt| <= 1e-4); bit for bit against its plain version (t, prim,
   cnt, cnt2) on the camera and shadow classes, and on the bounce class
   for the first variant of each kernel (the plain walk takes seconds
   there), whose plain call is timed, with a bound by phase 9's rule: its
   box and triangle tests counted by the plain version on that batch (every
   lane's box test per packet visit, the triangle tests masked in), o and d
   for every lane (dead lanes vote in a packet);
12. the loop-floor probe, one packet a cluster as the lab's packets are:
   the three floor_bench variants (stack only,
   +load, +slab) at n_iter = 20,000 at each geometry of
   kernel_lab.FLOOR_GEOMETRIES (rows 32 at the lab's cluster of 8 blocks of
   512 threads; rows 4 as one block of 512; rows 4 as 8 blocks of 64), bit
   for bit against floor_bench_plain, in ns an iteration (the mean of two
   medians of 5); each with its bound by bytes or FLOPs and its chain
   estimate: 20,000 times the cycles of the pieces on the variant's chain
   of dependences (kernel_lab.floor_cycles: each piece timed alone by
   clock64 on the card; kernel_lab.floor_chain) at the SM clock nvidia-smi
   prints while the card spins, and its share of the kernel's time (above
   100% where the pieces overlap in the kernel); then a lab visit split
   by the floor's steps at rows 32 (stack and barrier, record load and
   publication, vote) beside phase 11's microseconds per visit of the
   longest packet without and with leaf tests;
13. the nine traversal batches of one bench wave (sample 0 through the
   default cuda_bvh4 intersectors, recorded as trace_wave hands them over,
   in its lane order, as bench_scene.wave_batches does; launch counts reset
   just before and read just after: 9 launches = 9 traversal calls),
   through bench_scene.time_traversals for each of the four per-ray kernels
   (bvh4_traverse against plain, binary_traverse and binary_traverse_deep
   against plain_binary, bvh8_traverse against plain_bvh8): for each batch,
   its live lanes, the plain walk's work per lane and per warp
   (bench_scene.warp_work), the kernel's device time (two readings), its
   device time with L2 flushed before each call (device_ms(cold=True): a
   write of twice the card's L2, the median of 50 calls each between its
   own events) and host time, the plain version's time, the bound by phase
   9's rule, and phase 3's contract with its tie count; then for each
   kernel the sums, its "traversal device ms per wave" warm and cold with
   its bound, and torch.profiler's device time of the kernel on two batches
   beside device_ms;
14. gradients: d sum(film.xyz)/R / d mat_coeffs and / d light_scale of one
   bench wave (depth 4, Russian roulette off: rr_depth 99) by autograd,
   through cuda_bvh4 and through the plain traversal on the card (rtol 1e-3
   + atol 1e-6), central finite differences with common random numbers on
   the coefficient of largest gradient (relative error < 2%), the forward +
   backward time by CUDA events and the peak memory;
15. VolPath through make_wave_fn, which takes the phased wave
   (volpath.make_phased_wave) over cuda_bvh4: `volpath_bench` (the bench
   scene and wave with kind="volpath") over 16 waves, its image mean within
   5% of Path's over the same 16 waves; `volpath_fog` (the fog sphere of
   tests/test_phased_wave.py at 400x400 with the crown's settings: depth
   100, rr_depth 2, MIS, power light sampler; Sobol for the crown's
   Halton); for each the wave time by CUDA events (a warm-up, then 3
   waves), bvh4_traverse launches a wave, the CUDA kernels of a wave
   (torch.profiler), the lanes and live lanes of each phase; the fog image
   finite with mean > 0, its peak memory, and its phased wave over
   cuda_bvh4 against trace_wave_vol over the plain traversal on the same
   samples (atol and rtol 1e-5), every batch the phased wave hands the
   kernel held against the plain traversal (phase 3's contract, tie lanes
   counted); the fog scene as built (its sphere opaque: no ray enters the
   medium) and with the sphere as a medium boundary (rays scatter in it);
16. the materials: `bench_scene.build_material_scene()` (the bench
   geometry, its 24 spheres cycling through twelve materials: smooth and
   rough dielectric, thin dielectric, diffuse transmission, coated diffuse
   and coated conductor, a mix, hair, a measured GGX table, subsurface,
   spectral gold, diffuse) at 400x400 through make_wave_fn on cuda_bvh4 with
   the bench configuration: the wave time by CUDA events (a warm-up, then 3
   waves), bvh4_traverse launches a wave, peak memory, CUDA kernels and
   copies a wave (torch.profiler), also with the coated spheres made
   diffuse (the layered walk's share); the image finite with mean > 0; the
   same seed through the plain traversal gives the same film by phase 5's
   rule, while every batch the kernel is handed (the subsurface probes
   among them) is held against the plain traversal (phase 3's contract,
   tie lanes counted); the gradient of one wave with Russian roulette off
   (d sum(film.xyz)/R / d mat_coeffs, by autograd over two chunks of
   80,000 lanes, which bounds autograd's memory) finite on every material
   and equal through cuda_bvh4 and the plain traversal (rtol 1e-3 + atol
   1e-6), its forward + backward time and peak memory; then phase 15's fog
   run on `build_fog_scene(interface="glass")` (a dielectric sphere, eta
   1.33, holding the fog): time, launches, phases, the phased wave against
   trace_wave_vol (1e-5), lane scatterings in the fog > 0, and the lanes
   whose medium changed on real transmission through the glass > 0. Each
   line ends with the seconds since phase 16 began.

Any failure raises (exit code != 0). The last two lines of standard output
are a JSON record of the kernels and {"ok": true, "device": {...}}.
"""

import functools
import json
import subprocess
import sys
import time

DEPTH = 4  # bench_scene.BENCH_DEPTH

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
LAB_SOURCE = "nn_bvh_tpu_torch/csrc/kernel_lab.cu"
LAB_REPLACES = {"lab_traverse": "tools/perf/kernel_lab.py:202",
                "brless_traverse": "tools/perf/kernel_lab.py:360",
                "floor_bench": "tools/perf/kernel_lab.py:434"}
LAB_R = 65536
FLOPS_FLOOR_SLAB = 6  # per lane: 2 sub, min, max, mul, compare


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def launch_counts() -> dict:
    from nn_bvh_tpu_torch.accel import kernel_launch

    return dict(kernel_launch.n_launches)


def reset_counts():
    from nn_bvh_tpu_torch.accel import kernel_launch

    kernel_launch.n_launches.clear()


def compare(torch, label, kernel, plain, o, d, t_max):
    """Kernel vs plain (callables (o, d, t_max, any_hit)) on one batch under
    the kernels' contract (bench_scene.check_hits) -> (tie lanes, max |dt|
    over lanes where both hit, hit rate of the live lanes)."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    live = t_max > 0
    hk = kernel(o, d, t_max, False)
    hp = plain(o, d, t_max, False)
    torch.cuda.synchronize()
    ties = bs.check_hits(hk, hp, t_max, False, f"{label} closest")
    both = (hk.prim >= 0) & (hp.prim >= 0)
    err = float((hk.t - hp.t)[both].abs().max()) if bool(both.any()) else 0.0
    bs.check_hits(kernel(o, d, t_max, True), plain(o, d, t_max, True), t_max, True,
                  f"{label} any-hit")
    rate = float(((hk.prim >= 0) & live).sum()) / float(live.sum())
    return ties, err, rate


def phase_kernel_vs_plain(torch, sc, dbvh, batches, dev, backend, plain, phase):
    """Phases 3 and 6 for one kernel -> ({(batch, mode): {device ms, host
    us, single-launch ms, plain ms}}, max |dt|, the plain Intersectors)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import device_ms, host_us, median_ms

    k_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
    nodes, tris = k_isect.tables
    print(f"phase {phase}: {backend}: node table {tuple(nodes.shape)}, triangle table "
          f"{tuple(tris.shape)}")
    results = {}
    max_err = 0.0
    for name, (o, d, t_max) in batches.items():
        kern = lambda *a: k_isect.fn(*k_isect.tables, *a)
        pl = lambda *a: p_isect.fn(*p_isect.tables, *a)
        ties, err, rate = compare(torch, f"{backend} {name}", kern, pl, o, d, t_max)
        max_err = max(max_err, err)
        for mode, any_hit in (("closest", False), ("any_hit", True)):
            call = lambda: kern(o, d, t_max, any_hit)
            times = {"kernel": device_ms(call), "host_us": host_us(call),
                     "single": median_ms(call),
                     "plain": median_ms(lambda: pl(o, d, t_max, any_hit))}
            results[(name, mode)] = times
            print(f"phase {phase}: {backend} {name} {mode}: kernel {times['kernel']:.4f} ms "
                  f"device (50 calls), host {times['host_us']:.1f} us/call, one launch "
                  f"between events {times['single']:.4f} ms; plain {times['plain']:.2f} ms "
                  f"(median of 5)")
        print(f"phase {phase}: {backend} {name}: contract met (t bit-equal, prim/b1/b2 equal "
              f"but {ties} tie lanes, occlusion equal), hit rate {rate:.4f}, max |dt| {err:.3g}")
    return results, max_err, p_isect


def phase_main_path(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import bench_config
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg, sampler_cfg = bench_config()
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
    from nn_bvh_tpu_torch.tools.bench_scene import bench_config
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg, sampler_cfg = bench_config()
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
    from nn_bvh_tpu_torch.accel import binary, binary_kernel, bvh4, traverse
    from nn_bvh_tpu_torch.tools import bench_scene

    levels = 100
    tri, db = bench_scene.build_deep_tree(levels)
    try:
        binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 64)
        check(False, "the 64-entry packer accepted a tree of depth 100")
    except ValueError:
        pass
    nodes = torch.as_tensor(binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 128),
                            device=dev)
    tris = torch.as_tensor(bvh4.pack_tris_cuda(tri), device=dev)
    o, d, t_max = (torch.as_tensor(x, device=dev)
                   for x in bench_scene.deep_tree_rays(levels, R))
    kern = lambda *a: binary_kernel.traverse(nodes, tris, *a, stack=128)
    pl = lambda *a: traverse.traverse_binary_plain(nodes, tris, *a, stack_depth=128)
    ties, err, rate = compare(torch, "deep tree", kern, pl, o, d, t_max)
    brute = traverse.intersect_brute(torch.as_tensor(tri, device=dev), o, d, t_max)
    hk = kern(o, d, t_max, False)
    check(bool(torch.equal(hk.prim, brute.prim)), "deep tree: kernel differs from brute force")
    print(f"phase 7: depth-{binary.tree_depth(db.node_meta)} tree, {R} rays: contract met "
          f"({ties} tie lanes), hit rate {rate:.4f}, max |dt| {err:.3g}, prims equal to brute "
          f"force")


def bound_ms(torch, p_isect, o, d, t_max):
    """Phase 9's bound of one closest-hit call (bench_scene.traversal_bound),
    the work counted by the plain version on this batch -> (ms, by, work)."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    counts = {}
    p_isect.fn(*p_isect.tables, o, d, t_max, False, counts=counts)
    return bs.traversal_bound(counts, t_max, False, p_isect.tables[0])


def phase_wave_batches(torch, sc, dbvh, cam, dev):
    """Phase 13: the nine traversal batches of one bench wave, recorded
    through cuda_bvh4, then every per-ray kernel held against its plain
    version and timed on them, one family of tables at a time -> {kernel:
    totals over the wave}."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    reset_counts()
    rec = bs.RecordingIntersectors(dispatch.make_intersectors(sc, dbvh, dev))
    bs.bench_wave(sc, dbvh, cam, rec)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(rec.backend == "cuda_bvh4" and counts == {"bvh4_traverse": rec.n_calls}
          and len(rec.batches) == rec.n_calls == 2 * DEPTH + 1,
          f"wave batches: {len(rec.batches)} batches, launches {counts}")
    batches = dict(zip(bs.wave_batch_names(rec.batches), rec.batches))
    families = {}  # plain twin -> {kernel name: fn(o, d, t_max, any_hit)}
    for name, backend, plain, *_ in KERNELS:
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        families.setdefault(plain, {})[name] = functools.partial(isect.fn, *isect.tables)
    totals = {}
    for plain, fns in families.items():
        p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
        rows = bs.time_traversals(fns, batches, p_isect)
        for kname in fns:
            total = {"device_ms": 0.0, "cold_ms": 0.0, "host_us": 0.0, "bound_ms": 0.0,
                     "plain_ms": 0.0, "ties": 0}
            for name, row in rows.items():
                ms = bs.mean_ms(row, kname)
                for key, val in (("device_ms", ms), ("cold_ms", row["cold_ms"][kname]),
                                 ("host_us", row["host_us"][kname]),
                                 ("bound_ms", row["bound_ms"]), ("plain_ms", row["plain_ms"]),
                                 ("ties", row["ties"][kname])):
                    total[key] += val
                print(f"phase 13: {kname} {name:18s} live {row['live']:6d}; nodes/lane "
                      f"{row['nodes_mean']:.2f} p99 {row['nodes_p99']:.0f} max "
                      f"{row['nodes_max']}; tris/lane {row['tris_mean']:.2f} max "
                      f"{row['tris_max']}; warp max nodes {row['warp_nodes']:.1f} tris "
                      f"{row['warp_tris']:.1f}; kernel "
                      f"{'/'.join(f'{v:.4f}' for v in row['device_ms'][kname])} ms device "
                      f"(L2 flushed: {row['cold_ms'][kname]:.4f}), "
                      f"{row['host_us'][kname]:.1f} us host; {plain} {row['plain_ms']:.1f} ms; "
                      f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}; {row['work']}); "
                      f"contract met, {row['ties'][kname]} ties", flush=True)
            print(f"phase 13: {kname}: traversal device ms per wave {total['device_ms']:.4f} "
                  f"warm, {total['cold_ms']:.4f} with L2 flushed before each call, "
                  f"bound {total['bound_ms']:.6f} ms (host {total['host_us']:.1f} us, {plain} "
                  f"{total['plain_ms']:.1f} ms), {total['ties']} tie lanes", flush=True)
            for name in bs.PROFILED:
                prof = rows[name]["profiler_us"][kname]
                print(f"phase 13: {kname} profiler on {name}: "
                      + ("no device time recorded" if prof == 0 else f"{prof:.2f} us per call")
                      + f"; device_ms {bs.mean_ms(rows[name], kname) * 1e3:.2f} us per call")
            totals[kname] = total
    return totals


def phase_lab_main_path(torch):
    """Phase 10: the lab's entry point, counts reset just before and read
    just after -> launches by kernel name."""
    import contextlib
    import io

    from nn_bvh_tpu_torch.tools import kernel_lab

    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kernel_lab.main([])
    torch.cuda.synchronize()
    counts = launch_counts()
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines and lines[-1].startswith('{"kernel_lab"'),
          f"kernel_lab main returned {rc}")
    for line in lines[:-1]:
        print(f"phase 10: {line}")
    check(all(counts.get(n, 0) > 0 for n in LAB_REPLACES), f"lab kernels not launched: {counts}")
    # the camera hits that the bounce and shadow rays start from: one call
    check(set(counts) - set(LAB_REPLACES) == {"binary_traverse"}
          and counts["binary_traverse"] == 1, f"other kernels launched by the lab: {counts}")
    print(f"phase 10: kernel_lab main in {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


def event_ms(torch, fn):
    """-> (ms of one call of fn by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def lab_bound(lab_counts, R, Rp, table_bytes):
    """Phase 9's rule for a lab traversal: FLOPs of the lane box tests and
    the triangle tests masked in; bytes of o and d for every lane of the
    batch (dead lanes vote in a packet), t_max, the four outputs of the
    padded batch, the tables once."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    slab, tri = int(lab_counts["slab"].sum()), int(lab_counts["tri"].sum())
    flops = slab * bs.FLOPS_SLAB + tri * bs.FLOPS_TRI
    nbytes = R * (12 + 12 + 4) + Rp * 16 + table_bytes
    return flops, nbytes, dict(lane_slab_tests=slab, lane_tri_tests=tri)


def phase_lab_variants(torch, sc, dbvh, cam, dev):
    """Phases 11 and 12 -> {kernel: row of the kernels line without launches}."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import kernel_lab
    from nn_bvh_tpu_torch.tools.bench_scene import bound_of, device_ms, median_ms

    rays = kernel_lab.ray_classes(sc, dbvh, cam, LAB_R, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev, backend="cuda_binary")
    nodes, tris = kernel_lab.lab_tables(sc, dbvh, dev)
    table_bytes = nodes.numel() * nodes.element_size() + tris.numel() * tris.element_size()
    kern = {"lab_traverse": kernel_lab.lab_traverse, "brless_traverse": kernel_lab.brless_traverse}
    plain = {"lab_traverse": kernel_lab.lab_traverse_plain,
             "brless_traverse": kernel_lab.brless_traverse_plain}
    rows = {}
    ms_binary = {}
    visit_us = {}  # bounce class: us per visit of the longest packet, by variant
    for cls, (o, d, t_max) in rays.items():
        live = (t_max > 0).cpu()
        ref = isect.closest(o, d, t_max)
        ms_binary[cls] = device_ms(lambda: isect.closest(o, d, t_max))
        print(f"phase 11: {cls}: {int(live.sum())} live lanes, cuda_binary {ms_binary[cls]:.4f} ms, "
              f"hits {int((ref.prim >= 0).sum())}")
        for tag, (name, kw) in kernel_lab.VARIANTS.items():
            timed = cls == "bounce" and name not in rows
            out = kern[name](nodes, tris, o, d, t_max, **kw)
            ms = median_ms(lambda: kern[name](nodes, tris, o, d, t_max, **kw))
            r = kw["rows"]
            line = (f"phase 11: {tag:20s} {cls:7s} kernel {ms:9.4f} ms, cluster/threads "
                    f"{kernel_lab.launch_geometry(r)}")
            visits = int(out[2].max())
            if kw.get("count"):
                line += f", iters {int(out[2][::r, 0].sum())}, leafs {int(out[3][::r, 0].sum())}"
            prim, t = out[1].reshape(-1)[:LAB_R].cpu(), out[0].reshape(-1)[:LAB_R].cpu()
            if kw.get("leaf_mode") != "none":
                bp, bt = ref.prim.cpu(), ref.t.cpu()
                differ = live & (prim != bp)
                ties = differ & (prim >= 0) & (bp >= 0) & ((t - bt).abs() <= 1e-4)
                check(bool((differ == ties).all()),
                      f"{tag} {cls}: {int((differ & ~ties).sum())} live prims differ from "
                      "cuda_binary's and are no tie")
                line += f", prims = cuda_binary's ({int(ties.sum())} ties)"
            else:
                check(bool((prim == -1).all()), f"{tag} {cls}: no leaf tests, yet a hit")
            # the plain walk of the bounce class takes seconds a call on the card:
            # there only the timed variant of each kernel
            if cls != "bounce" or timed:
                lab_counts = {}
                plain_ms, want = event_ms(torch, lambda: plain[name](nodes, tris, o, d, t_max,
                                                                     counts=lab_counts, **kw))
                for a, b, what in zip(out, want, ("t", "prim", "cnt", "cnt2")):
                    check(a.shape == b.shape and bool(torch.equal(a, b)),
                          f"{tag} {cls}: {what} differs from the plain version")
                line += f", bit-equal to plain ({plain_ms:.1f} ms, one call)"
                if not visits:  # brless writes no counters: the plain walk's visits
                    visits = int(lab_counts["slab"].max()) // (r * 128)
            if visits:
                line += f", {ms * 1e3 / visits:.3f} us per visit of the longest packet ({visits})"
                if cls == "bounce":
                    visit_us[tag] = ms * 1e3 / visits
            if timed:
                flops, nbytes, work = lab_bound(lab_counts, LAB_R, out[0].numel(), table_bytes)
                bound, by = bound_of(flops, nbytes)
                rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                              "max_abs_err": float((out[0] - want[0]).abs().max())}
                line += (f"; cuda_binary {ms_binary[cls]:.4f} ms; bound {bound:.6f} ms ({by}; "
                         f"{work}, {flops} FLOPs, {nbytes} bytes)")
            print(line, flush=True)

    rows["floor_bench"] = phase_floor(torch, nodes, kernel_lab.floor_ox(rays), visit_us)
    return rows


def floor_bound(rows, with_load, with_slab, n_iter):
    """Phase 12's bound of one floor call (FLOPs and bytes of its inputs and
    output) -> (ms, by, FLOPs, bytes): the slab test on every lane each
    iteration, or one add a lane at the end and one a record; the distinct
    records read, ox where the slab reads it, the output."""
    from nn_bvh_tpu_torch.tools import kernel_lab
    from nn_bvh_tpu_torch.tools.bench_scene import bound_of

    lanes = rows * 128
    addr = kernel_lab.floor_addr(kernel_lab.floor_nodes(n_iter))
    rec_bytes = int(addr.unique().numel()) * 32 if with_load else 0
    flops = n_iter * lanes * FLOPS_FLOOR_SLAB if with_slab else (n_iter + lanes
                                                                 if with_load else 0)
    nbytes = rec_bytes + lanes * 4 * (2 if with_slab else 1)
    return (*bound_of(flops, nbytes), flops, nbytes)


def phase_floor(torch, nodes, ox, visit_us):
    """Phase 12: the floor sweep (kernel_lab.floor_sweep: every variant at
    every geometry of FLOOR_GEOMETRIES, bit for bit against the plain
    version), the pieces of an iteration (floor_cycles) and each variant's
    chain estimate at the SM clock, the split of a lab visit -> the
    floor_bench row of the kernels line."""
    from nn_bvh_tpu_torch.tools import kernel_lab as kl
    from nn_bvh_tpu_torch.tools.bench_scene import _sleep_cycles_per_ms

    sweep = kl.floor_sweep({"kernel": kl.floor_bench}, nodes, ox)
    clock = kl.sm_clock_mhz()
    print(f"phase 12: SM clock {clock:.0f} MHz (nvidia-smi clocks.sm while the card spins; "
          f"torch.cuda._sleep's clock64 rate {_sleep_cycles_per_ms() / 1e3:.0f} MHz)")
    n_iter = kl.FLOOR_ITERS
    row = None
    ns = {}
    for geo, (rows, cluster) in kl.FLOOR_GEOMETRIES.items():
        kl.floor_cycles(nodes, rows, cluster)  # a warm-up
        pieces = kl.floor_cycles(nodes, rows, cluster)
        chain = kl.floor_chain(pieces)
        print(f"phase 12: floor {geo}, cluster/threads {kl.launch_geometry(rows, cluster)}: "
              "cycles a step, each piece alone (floor_cycles, clock64, 1,000 steps): "
              + ", ".join(f"{p} {c:.1f}" for p, c in pieces.items()), flush=True)
        for variant, (wl, ws) in kl.FLOOR_VARIANTS.items():
            times = sweep[(variant, geo)]["kernel"]
            ms = sum(times) / len(times)
            ns[(variant, geo)] = kl.ns_per_iter(times)
            bound, by, flops, nbytes = floor_bound(rows, wl, ws, n_iter)
            chain_ms = n_iter * chain[variant] / (clock * 1e3)
            print(f"phase 12: floor {variant:10s} {geo:16s} {ns[(variant, geo)]:8.2f} ns/iter "
                  f"({'/'.join(f'{x:.4f}' for x in times)} ms), bit-equal to plain; bound "
                  f"{bound:.6f} ms ({by}; {flops} FLOPs, {nbytes} bytes); chain estimate "
                  f"{chain_ms:.4f} ms ({chain[variant]:.1f} cycles an iteration), "
                  f"{chain_ms / ms:.1%} of the kernel's time", flush=True)
            if geo == "rows=32" and variant == "+load":
                plain_ms, _ = event_ms(torch, lambda: kl.floor_bench_plain(nodes, ox, n_iter,
                                                                             wl, ws))
                row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "max_abs_err": 0.0}
    stack, load, slab = (ns[(v, "rows=32")] for v in kl.FLOOR_VARIANTS)
    print(f"phase 12: a lab visit at rows 32 by the floor: stack and barrier {stack:.2f} ns, "
          f"record load and publication {load - stack:.2f} ns, vote {slab - load:.2f} ns "
          f"(+slab {slab:.2f} ns); the lab's visit of the longest packet (phase 11, bounce): "
          f"{visit_us['lab rows=32 no leaf']:.3f} us without leaf tests, "
          f"{visit_us['lab rows=32 k=1']:.3f} us with them")
    return row


def phase_gradients(torch, sc, dbvh, cam, dev):
    """Phase 14: d sum(film)/R / d mat_coeffs and d / d light_scale of one
    bench wave (depth 4, Russian roulette off), through cuda_bvh4 and through
    the plain traversal on the card; central finite differences on one
    coefficient; forward + backward time and peak memory."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    tsc = scene_mod.to_device(sc, dev)
    lst = lightsamplers.build(tsc, cfg.light_sampler, dev)
    R = cam.width * cam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)
    ls = tsc.light_scale.detach().clone().requires_grad_(True)

    def loss(isect, mat_coeffs, light_scale):
        s2 = tsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        L, lam, pdf, fw = integrator.trace_wave(s2, None, cam, scfg, cfg, pix, 0, lst, isect)
        film = film_mod.add_samples(film_mod.make_film(cam.height, cam.width, dev), pix, L, lam,
                                    pdf, filter_weight=fw, sequential=True)
        return film.xyz.sum() / R

    def grads(isect):
        value = loss(isect, mc, ls)
        return value, torch.autograd.grad(value, (mc, ls))

    k_isect = dispatch.make_intersectors(sc, dbvh, dev)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    grads(k_isect)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    ms, (value, g_k) = event_ms(torch, lambda: grads(k_isect))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(counts.get("bvh4_traverse", 0) > 0 and set(counts) == {"bvh4_traverse"},
          f"gradient wave launches {counts}")
    _, g_p = grads(p_isect)
    rtol, atol = 1e-3, 1e-6
    for name, a, b in zip(("mat_coeffs", "light_scale"), g_k, g_p):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0, f"{name} grad {a}")
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"{name}: kernel grad differs from plain by {float((a - b).abs().max()):.3g}")
    err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    # central differences with common random numbers on the largest coefficient
    i, j = divmod(int(g_k[0].abs().argmax()), 3)
    eps = 1e-3
    step = torch.zeros_like(mc)
    step[i, j] = eps
    with torch.no_grad():
        fd = (float(loss(k_isect, mc + step, ls)) - float(loss(k_isect, mc - step, ls))) / (2 * eps)
    rel = abs(float(g_k[0][i, j]) - fd) / max(abs(fd), 1e-12)
    check(rel < 0.02, f"finite differences: autograd {float(g_k[0][i, j])} vs {fd}")
    print(f"phase 14: loss {value.item():.6f}; d/d mat_coeffs {g_k[0].flatten().tolist()}, "
          f"d/d light_scale {g_k[1].flatten().tolist()}; kernel vs plain traversal: max |diff| "
          f"{err:.3g} (rtol {rtol}, atol {atol}); finite differences on mat_coeffs[{i},{j}] "
          f"(eps {eps}): autograd {float(g_k[0][i, j]):.6f}, central difference {fd:.6f}, "
          f"relative error {rel:.2e} (< 2e-2); forward + backward {ms:.1f} ms by CUDA events, "
          f"peak memory {peak / 2**20:.1f} MiB above the {base_mem / 2**20:.1f} MiB held "
          f"before; launches {counts}", flush=True)


def cuda_kernel_count(torch, fn) -> int | None:
    """CUDA kernels and copies launched by fn (torch.profiler, device
    activity only: the host's op events would make a profile of 100,000s of
    kernels take minutes to read), None when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    return n or None


def timed_waves(torch, label, wave, film, first: int, n: int):
    """Samples first .. first+n-1 through wave, timed by CUDA events ->
    (film, ms a wave, bvh4_traverse launches a wave, phases of the last)."""
    reset_counts()
    ms, film = event_ms(torch, lambda: functools.reduce(wave, range(first, first + n), film))
    counts = launch_counts()
    check(set(counts) == {"bvh4_traverse"}, f"{label}: launches {counts}")
    return film, ms / n, counts.get("bvh4_traverse", 0) / n, getattr(wave, "phases", None)


def phase_volpath(torch, sc, dbvh, cam, dev):
    """Phase 15: VolPath on the card through make_wave_fn (the phased wave
    over cuda_bvh4): volpath_bench against Path over 16 waves, and
    volpath_fog (the crown's settings) against trace_wave_vol."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    waves = 16
    means = {}
    for label, (cfg, scfg) in (("volpath_bench", bench_scene.volpath_bench_config()),
                               ("path", bench_scene.bench_config())):
        isect = dispatch.make_intersectors(sc, dbvh, dev)
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        check((label == "path") != hasattr(wave, "phases"), f"{label}: wrong wave function")
        film = wave(film_mod.make_film(cam.height, cam.width, dev), 0)  # warm-up
        film, ms, launches, phases = timed_waves(torch, label, wave, film, 1, 3)
        film = functools.reduce(wave, range(4, waves), film)
        img = film_mod.develop(film)
        means[label] = float(img.mean())
        check(bool(torch.isfinite(img).all()) and means[label] > 0, f"{label}: bad image")
        print(f"phase 15: {label}: {ms:.1f} ms a wave (CUDA events, 3 waves after a warm-up), "
              f"{launches:.1f} bvh4_traverse launches a wave"
              + ("" if phases is None else f", phases (depth, lanes, live) {phases}")
              + f"; image mean over {waves} waves {means[label]:.6f}", flush=True)
        if label == "volpath_bench":
            n_k = cuda_kernel_count(torch, lambda: wave(film, waves))
            print(f"phase 15: volpath_bench: CUDA kernels a wave (torch.profiler): "
                  f"{n_k if n_k is not None else 'not measured'}", flush=True)
    rel = abs(means["volpath_bench"] - means["path"]) / means["path"]
    check(rel < 0.05, f"volpath_bench mean {means['volpath_bench']} vs path {means['path']}")
    print(f"phase 15: volpath_bench mean vs Path mean over {waves} waves: {rel:.4f} (< 0.05)")

    for interface in (False, True):
        phase_fog(torch, dev, interface)


def phase_fog(torch, dev, interface, phase: int = 15):
    """Phase 15's `volpath_fog` (interface=False: the scene as
    tests/test_phased_wave.py builds it, its diffuse sphere opaque) or the
    same with the sphere as a pure medium boundary (True) or as glass
    ("glass", phase 16), so rays enter the fog: time, launches and phases of
    the phased wave, then the phased wave over cuda_bvh4 against
    trace_wave_vol over the plain traversal on the same samples, each batch
    of the kernel held against the plain traversal, counting the lanes that
    scattered in the medium there and the lanes whose medium changed."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator, volpath

    label = "volpath_fog" + {False: "", True: " (sphere as medium boundary)",
                             "glass": " (glass sphere)"}[interface]
    fsc, fdbvh, fcam = bench_scene.build_fog_scene(interface=interface)
    cfg, scfg = bench_scene.volpath_fog_config()
    isect = dispatch.make_intersectors(fsc, fdbvh, dev)
    wave = integrator.make_wave_fn(fsc, fdbvh, fcam, scfg, cfg, isect=isect)
    check(hasattr(wave, "phases"), f"{label}: make_wave_fn did not take the phased wave")
    film = wave(film_mod.make_film(fcam.height, fcam.width, dev), 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    film, ms, launches, phases = timed_waves(torch, label, wave, film, 1, 3)
    peak = torch.cuda.max_memory_allocated() - base_mem
    img = film_mod.develop(film)
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"{label}: bad image")
    # phase 16 counts no kernels here (~500,000 a wave, its time is enough)
    n_k = cuda_kernel_count(torch, lambda: wave(film, 4)) if phase == 15 else None
    print(f"phase {phase}: {label} ({fsc.n_tris} triangles, {fsc.n_media} medium, "
          f"{fcam.width}x{fcam.height}, depth {cfg.max_depth}): {ms:.1f} ms a wave (CUDA "
          f"events, 3 waves after a warm-up), {launches:.1f} bvh4_traverse launches a wave, "
          f"CUDA kernels and copies a wave (torch.profiler): "
          f"{n_k if n_k is not None else 'not measured'}, peak memory "
          f"{peak / 2**20:.1f} MiB above {base_mem / 2**20:.1f} MiB; phases of wave 3 (depth, "
          f"lanes, live): {phases}; image mean {float(img.mean()):.6f}", flush=True)

    # the phased wave over cuda_bvh4 against the whole-wave trace over the
    # plain traversal, same samples, on the card; every batch the phased wave
    # hands the kernel is also held against the plain traversal (check_hits)
    tsc = scene_mod.to_device(fsc, dev)
    R = fcam.width * fcam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    p_isect = dispatch.make_intersectors(fsc, fdbvh, dev, backend="plain")
    checked = bench_scene.CheckedIntersectors(isect, p_isect, label)
    wave = integrator.make_wave_fn(fsc, fdbvh, fcam, scfg, cfg, isect=checked)
    f_ph = f_pl = film_mod.make_film(fcam.height, fcam.width, dev)
    scattered, changed = [], []
    events, bounce = volpath.medium_events, volpath.bounce

    def counted(*a, **kw):
        out = events(*a, **kw)
        scattered.append(int(out[0].sum()))
        return out

    def counted_bounce(ctx, depth, state, allow_scatter=True):
        # lanes whose medium the bounce changed, matched by their caller lane
        out = bounce(ctx, depth, state, allow_scatter)
        n = int(max(state.perm.max(), out.perm.max())) + 1
        before = torch.full((n,), -2, dtype=torch.int32, device=dev)
        after = before.clone()
        before[state.perm] = state.cur_med
        after[out.perm] = out.cur_med
        changed.append(int((before != after).sum()))
        return out

    volpath.medium_events, volpath.bounce = counted, counted_bounce
    try:
        for s in range(2):
            f_ph = wave(f_ph, s)
            L, lam, pdf, fw = volpath.trace_wave_vol(tsc, None, fcam, scfg, cfg, pix, s, None,
                                                     p_isect)
            f_pl = film_mod.add_samples(f_pl, pix, L, lam, pdf, filter_weight=fw,
                                        sequential=True)
    finally:
        volpath.medium_events, volpath.bounce = events, bounce
    a, b = film_mod.develop(f_ph), film_mod.develop(f_pl)
    diff = float((a - b).abs().max())
    check(bool(torch.allclose(a, b, atol=1e-5, rtol=1e-5)),
          f"{label}: phased wave differs from trace_wave_vol by {diff}")
    check((sum(scattered) > 0) == bool(interface), f"{label}: {sum(scattered)} lanes scattered")
    # the glass scene has no pure interface: each change is a real transmission
    check(interface != "glass" or sum(changed) > 0, f"{label}: no medium change")
    sizes = sorted({n for n, _ in checked.sizes}, reverse=True)
    print(f"phase {phase}: {label}: phased wave (cuda_bvh4) vs trace_wave_vol (plain), 2 "
          f"waves: max |diff| {diff:.3g} (atol 1e-5, rtol 1e-5); lane scatterings in the "
          f"medium {sum(scattered)}, lanes whose medium changed {sum(changed)} (both waves of "
          f"each); the kernel held against plain on all {len(checked.sizes)} batches of the "
          f"phased wave (lanes {sizes}), contract met, {checked.ties} tie lanes", flush=True)


def phase_materials(torch, dev):
    """Phase 16: the material scene through make_wave_fn on cuda_bvh4 (time,
    launches, kernels, memory; the diffuse variant's kernels), the same seed
    through the plain traversal with every batch held against it, the
    gradient of a wave through both, then the glass fog scene."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator, subsurface

    t0 = time.perf_counter()
    msc, mdbvh, mcam = bench_scene.build_material_scene()
    dsc, ddbvh, _ = bench_scene.build_material_scene(coated=False)
    check(msc.n_tris == 52996, f"material scene has {msc.n_tris} triangles")
    print(f"phase 16: material scene {msc.n_tris} triangles, {len(msc.mat_type)} materials "
          f"(spheres: {', '.join(bench_scene.MATERIAL_KINDS)}), {msc.n_lights} lights, "
          f"built twice (as is, coated spheres diffuse) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    cfg, scfg = bench_scene.bench_config()
    label = "material scene"
    make_film = lambda: film_mod.make_film(mcam.height, mcam.width, dev)
    isect = dispatch.make_intersectors(msc, mdbvh, dev)
    check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
    wave = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=isect)
    film = wave(make_film(), 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    film, ms, launches, _ = timed_waves(torch, label, wave, film, 1, 3)
    peak = torch.cuda.max_memory_allocated() - base_mem
    img = film_mod.develop(film)
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"{label}: bad image")
    n_k = cuda_kernel_count(torch, lambda: wave(film, 4))
    dwave = integrator.make_wave_fn(dsc, ddbvh, mcam, scfg, cfg,
                                    isect=dispatch.make_intersectors(dsc, ddbvh, dev))
    dfilm = dwave(make_film(), 0)  # warm-up
    n_kd = cuda_kernel_count(torch, lambda: dwave(dfilm, 1))
    nm = lambda n: "not measured" if n is None else n
    print(f"phase 16: {label} ({mcam.width}x{mcam.height}, Path MIS, depth 4, rr_depth 2, "
          f"Sobol 16 spp): "
          f"{ms:.1f} ms a wave (CUDA events, 3 waves after a warm-up), {launches:.1f} "
          f"bvh4_traverse launches a wave, peak memory {peak / 2**20:.1f} MiB above "
          f"{base_mem / 2**20:.1f} MiB; CUDA kernels and copies a wave (torch.profiler): "
          f"{nm(n_k)}, {nm(n_kd)} with the coated spheres diffuse; image mean "
          f"{float(img.mean()):.6f} [{time.perf_counter() - t0:.0f} s]", flush=True)

    # the same seed through the plain traversal; each batch of the kernel
    # (the subsurface probes among them) held against the plain traversal
    plain = dispatch.make_intersectors(msc, mdbvh, dev, backend="plain")
    checked = bench_scene.CheckedIntersectors(isect, plain, label)
    f_k = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=checked)(make_film(), 0)
    f_p = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=plain)(make_film(), 0)
    close, rel = film_agreement(f_k.xyz, f_p.xyz)
    check(close >= 0.995 and rel <= 1e-3,
          f"{label}: film agrees with the plain traversal on {close:.5f} of pixels, "
          f"mean rel diff {rel:.3g}")
    n_any = sum(1 for _, a in checked.sizes if a)
    n_closest = len(checked.sizes) - n_any
    check(n_closest == 1 + n_any * (1 + subsurface.N_PROBE),
          f"{label}: {n_closest} closest-hit batches for {n_any} shadow batches")
    print(f"phase 16: {label}: the same seed through the plain traversal: film XYZ agrees on "
          f"{close:.6f} of pixels, mean rel diff {rel:.3g}; the kernel held against plain on "
          f"all {len(checked.sizes)} batches of the wave ({n_closest} closest-hit, "
          f"{n_any * subsurface.N_PROBE} of them subsurface probes, {n_any} any-hit), "
          f"contract met, {checked.ties} tie lanes [{time.perf_counter() - t0:.0f} s]",
          flush=True)

    # the gradient of one wave, Russian roulette off, in chunks of lanes
    gcfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    tsc = scene_mod.to_device(msc, dev)
    lst = lightsamplers.build(tsc, gcfg.light_sampler, dev)
    R = mcam.width * mcam.height
    chunks = torch.arange(R, dtype=torch.int32, device=dev).split(80000)
    mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)

    def grads(isect_):
        value, g = 0.0, torch.zeros_like(mc)
        for pix in chunks:
            L, lam, pdf, fw = integrator.trace_wave(tsc.replace(mat_coeffs=mc), None, mcam,
                                                    scfg, gcfg, pix, 0, lst, isect_)
            loss = film_mod.add_samples(make_film(), pix, L, lam, pdf,
                                        filter_weight=fw).xyz.sum() / R
            g += torch.autograd.grad(loss, mc)[0]
            value += float(loss.detach())
        return value, g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    g_ms, (value, g_k) = event_ms(torch, lambda: grads(isect))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(set(counts) == {"bvh4_traverse"}, f"gradient wave launches {counts}")
    _, g_p = grads(plain)
    check(bool(torch.isfinite(g_k).all()), f"{label}: non-finite gradient rows "
          f"{torch.nonzero(~torch.isfinite(g_k).all(-1)).flatten().tolist()}")
    check(bool(torch.allclose(g_k, g_p, rtol=1e-3, atol=1e-6)),
          f"{label}: kernel gradient differs from plain by {float((g_k - g_p).abs().max()):.3g}")
    rows = [(int(t), f"{float(m):.3g}") for t, m in zip(msc.mat_type, g_k.abs().amax(-1))]
    print(f"phase 16: {label} gradient (one wave, depth 4, RR off, {len(chunks)} chunks of "
          f"{chunks[0].numel()} lanes): loss {value:.6f}; (material tag, max |d/d "
          f"mat_coeffs|) by row {rows}; finite on all {g_k.shape[0]} rows; cuda_bvh4 vs plain "
          f"traversal "
          f"max |diff| {float((g_k - g_p).abs().max()):.3g} (rtol 1e-3, atol 1e-6); forward + "
          f"backward {g_ms:.1f} ms by CUDA events, peak memory {peak / 2**20:.1f} MiB above "
          f"{base_mem / 2**20:.1f} MiB; {counts['bvh4_traverse']} launches "
          f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    phase_fog(torch, dev, "glass", phase=16)
    print(f"phase 16: done in {time.perf_counter() - t0:.0f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch import kernels
    from nn_bvh_tpu_torch.tools import bench_scene


    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    sources = ("bvh4_traverse", "binary_traverse", "bvh8_traverse", "kernel_lab")
    t0 = time.perf_counter()
    kernels.build(*sources)
    for name in sources:
        kernels.load(name)
    print(f"phase 2: built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        log = kernels.ptxas_log(name)
        for line in kernels.ptxas_lines(log):
            print(f"phase 2: {name}: {line}")
        check(kernels.spill_bytes(log) == 0, f"{name} spills: {kernels.ptxas_lines(log)}")

    t0 = time.perf_counter()
    sc, dbvh, cam = bench_scene.build_bench_scene()
    print(f"phase 3: bench scene {sc.n_tris} triangles, {sc.n_lights} lights, "
          f"{dbvh.n_nodes} binary nodes, built in {time.perf_counter() - t0:.2f} s")
    check(sc.n_tris == 52996, f"bench scene has {sc.n_tris} triangles, expected 52996")
    batches = bench_scene.probe_batches(sc, cam, dev)
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
        print(f"phase 9: {name}: incoherent closest {rep['kernel']:.4f} ms device, "
              f"bound {bound:.4f} ms ({by}; {work})")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": row["launches"], "max_abs_err": row["max_err"],
                    "ms": rep["kernel"], "plain_ms": rep["plain"], "bound_ms": bound,
                    "bound_by": by, "library_ms": None})
    lab_launches = phase_lab_main_path(torch)
    lab_rows = phase_lab_variants(torch, sc, dbvh, cam, dev)
    for name, replaces in LAB_REPLACES.items():
        out.append({"name": name, "route": "cuda", "source": LAB_SOURCE, "replaces": replaces,
                    "launches": lab_launches[name], **lab_rows[name], "library_ms": None})
    phase_wave_batches(torch, sc, dbvh, cam, dev)
    phase_gradients(torch, sc, dbvh, cam, dev)
    phase_volpath(torch, sc, dbvh, cam, dev)
    phase_materials(torch, dev)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
