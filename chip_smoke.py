#!/usr/bin/env python3
"""Smoke run of the torch port (nn_bvh_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the bench configuration of bench.py (400x400
Path integrator, MIS + Russian roulette, depth 4, Sobol 16 spp, power light
sampler, the 52,996-triangle sphere-field scene), through its user entry
points, and checks it:

1. environment: a CUDA card is required; prints nvidia-smi's name and power
   limit;
2. build: compiles the BVH4 traversal kernel from csrc/ with nvcc;
3. kernel vs plain: closest-hit and any-hit on 160,000 camera rays and
   160,000 incoherent rays (20% dead lanes), through the CUDA kernel and the
   plain torch traversal; prim / occlusion must agree on >= 99.99% of live
   lanes and every disagreeing lane must be a tie with |dt| <= 1e-4;
   median times of 5 calls;
4. main path: make_wave_fn -> one warm-up wave + 4 timed waves; the image
   must be finite with mean > 0, and the kernel's launch count must equal
   the traversal calls the integrator made (0 < calls <= 9 per wave);
5. the same seed through backend="plain" and the kernel: film XYZ within
   rtol 1e-3 + atol 1e-4 on >= 99.5% of pixels, mean within 0.1%.

Any failure raises (exit code != 0). The last two lines of standard output
are a JSON record of the kernel and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

R_BENCH = 400 * 400
DEPTH = 4


def build_bench_scene():
    """bench.py:45-70 with the port's modules (same RandomState(42) draws)."""
    from nn_bvh_tpu_torch import accel
    from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod

    rs = np.random.RandomState(42)
    b = scene_mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(24):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=24, n_phi=48)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)), fov=50.0,
        width=400, height=400)
    return sc, dbvh, cam


def median_ms(torch, fn, n=5):
    fn()  # warm-up
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_kernel_vs_plain(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

    k_isect = dispatch.make_intersectors(sc, dbvh, dev)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    check(k_isect.backend == "cuda_bvh4", f"CUDA picked {k_isect.backend}")
    print(f"phase 3: {k_isect.nodes.shape[0]} BVH4 nodes, "
          f"{k_isect.tris.shape[0]} triangle slots")

    # camera rays of sample 0 (the integrator's own dimensions)
    pix = torch.arange(R_BENCH, dtype=torch.int32, device=dev)
    sid = torch.zeros(R_BENCH, dtype=torch.int32, device=dev)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    u_pix = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_PIXEL), -1)
    u_lens = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_LENS), -1)
    o_cam, d_cam = camera_mod.generate_rays(cam, pix, u_pix, u_lens)
    # incoherent rays: origins in the scene box, uniform directions
    rs = np.random.RandomState(7)
    lo, hi = np.asarray(sc.bounds)
    o_inc = (lo + rs.rand(R_BENCH, 3) * (hi - lo)).astype(np.float32)
    d_inc = rs.randn(R_BENCH, 3).astype(np.float32)
    d_inc /= np.linalg.norm(d_inc, axis=1, keepdims=True)
    dead = rs.rand(R_BENCH) < 0.2
    t_max = torch.as_tensor(np.where(dead, -1.0, 1e30).astype(np.float32), device=dev)
    live = ~torch.as_tensor(dead, device=dev)
    batches = {
        "camera": (o_cam.contiguous(), d_cam.contiguous()),
        "incoherent": (torch.as_tensor(o_inc, device=dev), torch.as_tensor(d_inc, device=dev)),
    }
    results = {}
    max_err = 0.0
    for name, (o, d) in batches.items():
        hk = k_isect.closest(o, d, t_max)
        hp = p_isect.closest(o, d, t_max)
        torch.cuda.synchronize()
        same = (hk.prim == hp.prim) & live
        agree = same.sum().item() / live.sum().item()
        both = live & (hk.prim >= 0) & (hp.prim >= 0)
        dt = (hk.t - hp.t).abs()
        bad = live & ~same & ~(both & (dt <= 1e-4))
        check(agree >= 0.9999, f"{name} closest: prim agrees on {agree:.6f} of live lanes")
        check(int(bad.sum()) == 0, f"{name} closest: {int(bad.sum())} non-tie disagreements")
        check(bool((hk.prim[~live] == -1).all() and torch.isinf(hk.t[~live]).all()),
              f"{name} closest: dead lanes must miss")
        err = float(dt[live & same & (hk.prim >= 0)].max())
        max_err = max(max_err, err)
        ok_k = k_isect.any_hit(o, d, t_max)
        ok_p = p_isect.any_hit(o, d, t_max)
        occ = ((ok_k == ok_p) & live).sum().item() / live.sum().item()
        check(occ >= 0.9999, f"{name} any-hit: occlusion agrees on {occ:.6f}")
        check(bool(ok_k[~live].all()), f"{name} any-hit: dead lanes must report occluded")
        times = {}
        for mode in ("closest", "any_hit"):
            for backend, isect in (("kernel", k_isect), ("plain", p_isect)):
                fn = getattr(isect, mode)
                times[backend] = median_ms(torch, lambda: fn(o, d, t_max))
            results[(name, mode)] = times.copy()
            print(f"phase 3: {name} {mode}: kernel {times['kernel']:.4f} ms, "
                  f"plain {times['plain']:.2f} ms (median of 5)")
        print(f"phase 3: {name}: prim agree {agree:.6f}, occlusion agree {occ:.6f}, "
              f"hit rate {float(((hk.prim >= 0) & live).sum()) / float(live.sum()):.4f}, "
              f"max |dt| on agreeing hits {err:.3g}")
    return results, max_err


def phase_main_path(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import bvh4_kernel, dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=2)
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
    film = film_mod.make_film(cam.height, cam.width, dev)

    bvh4_kernel.n_launches = 0
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
    launches = bvh4_kernel.n_launches
    calls = isect.n_calls

    check(launches == calls, f"kernel launches {launches} != traversal calls {calls}")
    check(0 < launches <= (2 * DEPTH + 1) * (1 + n_waves),
          f"{launches} traversal calls for {1 + n_waves} waves")
    img = film_mod.develop(film)
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()) and mean > 0, f"bad image, mean {mean}")
    rays_per_s = R_BENCH * (2 * DEPTH + 1) * n_waves / dt
    print(f"phase 4: warm-up wave {warm:.3f} s, {n_waves} waves {dt:.3f} s "
          f"({dt / n_waves * 1e3:.1f} ms/wave), {rays_per_s / 1e6:.3f} Mrays/s "
          f"(R*(2*depth+1)*waves/s), {launches} kernel launches = {calls} "
          f"traversal calls, image mean {mean:.5f}")
    return launches, rays_per_s


def phase_same_seed(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=2)
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    films = {}
    for backend in ("plain", "cuda_bvh4"):
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
        t0 = time.perf_counter()
        films[backend] = wave(film_mod.make_film(cam.height, cam.width, dev), 0).xyz
        torch.cuda.synchronize()
        print(f"phase 5: {backend} wave {time.perf_counter() - t0:.3f} s")
    a, b = films["cuda_bvh4"], films["plain"]
    close = ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all(-1).float().mean().item()
    rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-12)
    check(close >= 0.995, f"film XYZ agrees on {close:.5f} of pixels")
    check(rel <= 1e-3, f"film mean differs by {rel:.3g}")
    print(f"phase 5: film XYZ agrees on {close:.6f} of pixels, mean rel diff {rel:.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    t0 = time.perf_counter()
    kernels.load("bvh4_traverse")
    print(f"phase 2: built bvh4_traverse in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_logs.get("bvh4_traverse", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2: {line.strip()}")

    t0 = time.perf_counter()
    sc, dbvh, cam = build_bench_scene()
    print(f"phase 3: bench scene {sc.n_tris} triangles, {sc.n_lights} lights, "
          f"{dbvh.n_nodes} binary nodes, built in {time.perf_counter() - t0:.2f} s")
    check(sc.n_tris == 52996, f"bench scene has {sc.n_tris} triangles, expected 52996")
    times, max_err = phase_kernel_vs_plain(torch, sc, dbvh, cam, dev)
    launches, _ = phase_main_path(torch, sc, dbvh, cam, dev)
    phase_same_seed(torch, sc, dbvh, cam, dev)

    rep = times[("incoherent", "closest")]
    print(json.dumps({"kernels": [{
        "name": "bvh4_traverse", "route": "cuda",
        "source": "nn_bvh_tpu_torch/csrc/bvh4_traverse.cu",
        "replaces": "nn_bvh_tpu/accel/pallas_bvh4.py:297",
        "launches": launches, "max_abs_err": max_err,
        "ms": rep["kernel"], "plain_ms": rep["plain"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
