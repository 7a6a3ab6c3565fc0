"""Same seed, same image: the bench scene rendered twice through two
freshly built wave functions on the default traversal (bvh4_traverse on
the card) must give bit-identical images.

    python -m nn_bvh_tpu_torch.tools.determinism [--res 256] [--device cpu]

The bench configuration at --res x --res (default 256): Path, MIS, Russian
roulette from depth 2, depth 4, Sobol seed 7, 4 spp; each wave adds its
samples to the film sequentially (no scatter). Prints one JSON line
(bit_identical, max_abs_diff, mean, backend, device) and exits 1 when the
two images differ.
"""

from __future__ import annotations

import argparse
import json
import sys


def render_twice(res: int, device=None):
    """The two images (H, W, 3) float32 numpy and the backend name."""
    from ..accel import dispatch
    from ..core import samplers
    from ..devices import resolve_device
    from ..wavefront import film as film_mod, integrator
    from . import bench_scene

    device = resolve_device(device)
    sc, dbvh, cam = bench_scene.build_bench_scene()
    cam = cam._replace(width=res, height=res)
    cfg = integrator.IntegratorConfig(max_depth=bench_scene.BENCH_DEPTH, mis=True, rr_depth=2)
    imgs = []
    for _ in range(2):
        isect = dispatch.make_intersectors(sc, dbvh, device)
        scfg = samplers.make_sampler("sobol", seed=7, spp=4, width=cam.width)
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        film = film_mod.make_film(cam.height, cam.width, device)
        for s in range(4):
            film = wave(film, s)
        imgs.append(film_mod.develop(film).cpu().numpy())
    return imgs, isect.backend


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    (a, b), backend = render_twice(args.res, args.device)
    identical = bool((a == b).all())
    print(json.dumps({"metric": "same_seed_bit_identical", "bit_identical": identical,
                      "max_abs_diff": float(np.abs(a - b).max()), "mean": float(a.mean()),
                      "res": args.res, "backend": backend,
                      "device": args.device or "cuda"}))
    return 0 if identical else 1


if __name__ == "__main__":
    sys.exit(main())
