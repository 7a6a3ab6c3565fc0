"""CUDA kernels and copies a wave, by torch.profiler, for the bench Path
wave, `volpath_bench` and (where the tree has it) the material scene, on
the default CUDA traversal.

    python3 -m nn_bvh_tpu_torch.tools.wave_kernels

Each wave is counted after a warm-up wave, twice for the bench waves: from
a profile of device activity alone (chip_smoke's count) and from one that
records the host's ops too (chip_smoke's count before the material scene,
whose ~180,000 kernels made such a profile take over a minute to read);
the material scene from device activity alone. Imports the package it finds
first on sys.path, so one script counts two trees in one call
(`PYTHONPATH=TREE python3 path/to/wave_kernels.py`). Needs a CUDA card.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("wave_kernels: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    dev = torch.device("cuda", 0)
    sc, dbvh, cam = bench_scene.build_bench_scene()
    runs = [("bench Path wave", sc, dbvh, cam, bench_scene.bench_config(), True),
            ("volpath_bench", sc, dbvh, cam, bench_scene.volpath_bench_config(), True)]
    if hasattr(bench_scene, "build_material_scene"):
        runs.append(("material scene", *bench_scene.build_material_scene(),
                     bench_scene.bench_config(), False))
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
