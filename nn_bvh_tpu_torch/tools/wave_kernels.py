"""CUDA kernels and copies a wave, by torch.profiler, for the bench Path
wave, `volpath_bench` and (where the tree has them) the material scene and
the lights scene under each sampler kind of bench_scene.SAMPLER_KINDS, on
the default CUDA traversal.

    python3 -m nn_bvh_tpu_torch.tools.wave_kernels
    python3 -m nn_bvh_tpu_torch.tools.wave_kernels --stages

Each wave is counted after a warm-up wave, twice for the bench waves: from
a profile of device activity alone (chip_smoke's count) and from one that
records the host's ops too (chip_smoke's count before the material scene,
whose ~180,000 kernels made such a profile take over a minute to read);
the material and lights scenes from device activity alone. Imports the package it finds
first on sys.path, so one script counts two trees in one call
(`PYTHONPATH=TREE python3 path/to/wave_kernels.py`). Needs a CUDA card.

--stages is the stage ablation of tools/perf/wave_ablate.py: the bench
wave (400x400, Sobol 16 spp) under seven integrator configurations, each
switching a stage off (light sampling, bounces past 0, 1 or 2, MIS, the
power light sampler), with its ms a wave (CUDA events around each of 3
waves after a warm-up, the median) and its CUDA kernels and copies a wave.
"""

from __future__ import annotations

import argparse
import sys

import torch


def count(fn, host: bool) -> int:
    """Device events (kernels, copies, memsets) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


# tools/perf/wave_ablate.py's seven stage runs: label, IntegratorConfig fields
STAGES = [
    ("full path depth4 (baseline)", dict(max_depth=4, mis=True, rr_depth=2)),
    ("no light sampling (no shadow rays)", dict(max_depth=4, mis=True, rr_depth=2,
                                                sample_lights=False)),
    ("depth 0 (camera+emission only)", dict(max_depth=0, mis=True)),
    ("depth 1", dict(max_depth=1, mis=True, rr_depth=2)),
    ("depth 2", dict(max_depth=2, mis=True, rr_depth=2)),
    ("simplepath depth4 (no MIS, uniform lights)", dict(max_depth=4, mis=False)),
    ("light sampler uniform", dict(max_depth=4, mis=True, rr_depth=2, light_sampler="uniform")),
]


def stages(sc, dbvh, cam, dev) -> list:
    """The stage ablation -> [(label, ms a wave, kernels a wave)], printed
    as it goes."""
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    out = []
    for label, kw in STAGES:
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, integrator.IntegratorConfig(**kw),
                                       device=dev)
        film = wave(film_mod.make_film(cam.height, cam.width, dev), 0)  # warm-up
        times = []
        for s in range(1, 4):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            film = wave(film, s)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        n = count(lambda: wave(film, 4), host=False)
        ms = sorted(times)[1]
        out.append((label, ms, n))
        print(f"wave_kernels: stage {label:44s} {ms:8.1f} ms a wave, {n} CUDA kernels and "
              "copies a wave", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", action="store_true",
                    help="the bench wave's stage ablation instead of the scenes' counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wave_kernels: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    dev = torch.device("cuda", 0)
    sc, dbvh, cam = bench_scene.build_bench_scene()
    if args.stages:
        stages(sc, dbvh, cam, dev)
        return 0
    runs = [("bench Path wave", sc, dbvh, cam, bench_scene.bench_config(), True),
            ("volpath_bench", sc, dbvh, cam, bench_scene.volpath_bench_config(), True)]
    if hasattr(bench_scene, "build_material_scene"):
        runs.append(("material scene", *bench_scene.build_material_scene(),
                     bench_scene.bench_config(), False))
    if hasattr(bench_scene, "build_lights_scene"):
        lights = bench_scene.build_lights_scene("image")
        runs += [(f"lights scene, {kind}", *lights,
                  bench_scene.lights_config("image", sampler=kind), False)
                 for kind in bench_scene.SAMPLER_KINDS]
    for label, sc_, dbvh_, cam_, (cfg, scfg), both in runs:
        wave = integrator.make_wave_fn(sc_, dbvh_, cam_, scfg, cfg, device=dev)
        film = wave(film_mod.make_film(cam_.height, cam_.width, dev), 0)  # warm-up
        n_dev = count(lambda: wave(film, 1), host=False)
        n_host = count(lambda: wave(film, 1), host=True) if both else None
        print(f"wave_kernels: {label}: {n_dev} CUDA kernels and copies a wave (device "
              f"activity)" + ("" if n_host is None else f", {n_host} (with host ops)"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
