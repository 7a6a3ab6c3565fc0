"""Crown pixel-gradient check: autograd against finite differences on a
material parameter (port of tools/crown_grad.py).

Renders a small film of the scene at 2 spp, takes d(mean radiance over
the film's lanes and the 2 waves) / d(mat_coeffs[m]) by autograd through
the wavefront renderer, for the most-used material m, and compares it
with central differences (eps 3e-2) with common random numbers (the same
sampler seeds, so the noise cancels and only float rounding and the
step's truncation error remain). Path, MIS, no early exit, the
independent sampler (seed 7), Russian roulette at the integrator's
default unless `rr_depth` is given. Roulette makes the estimator
discontinuous in the coefficients (a lane's survival flips as its
throughput crosses the threshold), and central differences then see the
jumps that autograd does not: on the bench scene at 64x64 the check reads
~6% with roulette, as the JAX package's arithmetic does, and ~0.04%
without (PERF.md).

    python -m nn_bvh_tpu_torch.tools.crown_grad

checks the staged crown (/tmp/crown_golden/crown_golden.pbrt, staged by
`python tools/refbuild/crown_golden.py`) on the card, with the knobs
CROWN_GRAD_RES (film side, 64), CROWN_GRAD_DEPTH (4), CROWN_GRAD_NO_NEE=1
(no light sampling) and CROWN_GRAD_NOSORT=1 (no ray sort). It prints one
JSON line and exits 0 iff the relative error is under 2%. `grad_check`
runs the same check on any .pbrt file.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

STAGED = "/tmp/crown_golden/crown_golden.pbrt"
EPS = 3e-2
GATE = 0.02


def grad_check(scene_file: str, res: int = 64, depth: int = 4, sample_lights: bool = True,
               sort: bool = True, device=None, mat_id: int | None = None,
               rr_depth: int | None = None) -> dict:
    """The AD-vs-FD check on `scene_file` for material `mat_id` (default:
    the one on the most triangles, the crown's gold) -> {"metric", "mat_id",
    "grad_ad", "grad_fd", "value"} (value: max |AD - FD| over the three
    coefficients / max |FD|)."""
    from ..accel import dispatch
    from ..core import samplers
    from ..devices import resolve_device
    from ..geometry import pbrt_parser, scene as scene_mod
    from ..scatter import lightsamplers
    from ..wavefront import integrator

    dev = resolve_device(device)
    sc, dbvh, cam, _ = pbrt_parser.load_scene(scene_file)
    # a small film; the camera's rays still cover the scene
    cam = cam._replace(width=res, height=res)
    cfg = integrator.IntegratorConfig(max_depth=depth, mis=True, kind="path",
                                      early_exit=False, sample_lights=sample_lights)
    if rr_depth is not None:
        cfg = cfg._replace(rr_depth=rr_depth)
    sampler_cfg = samplers.to_device(samplers.make_sampler("independent", seed=7, spp=2), dev)
    ls = lightsamplers.build(sc, cfg.light_sampler, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev, sort=sort)
    scd = scene_mod.to_device(sc, dev)
    pixel_idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)

    if mat_id is None:
        tri_mat = scene_mod.host(sc.tri_mat)[:sc.n_tris]
        mats, counts = np.unique(tri_mat, return_counts=True)
        mat_id = int(mats[np.argmax(counts * (mats >= 0))])

    def crop_mean(coeffs):
        s2 = scd.replace(mat_coeffs=coeffs)
        total = 0.0
        for s in range(2):
            L = integrator.trace_wave(s2, None, cam, sampler_cfg, cfg, pixel_idx, s, ls,
                                      isect)[0]
            total = total + L.mean()
        return total / 2.0

    coeffs0 = scd.mat_coeffs.detach()
    c = coeffs0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(crop_mean(c), c)
    grad = g[mat_id].double().cpu().numpy()

    fd = np.zeros(3, np.float64)
    with torch.no_grad():
        for k in range(3):
            dv = torch.zeros_like(coeffs0)
            dv[mat_id, k] = EPS
            fd[k] = (float(crop_mean(coeffs0 + dv)) - float(crop_mean(coeffs0 - dv))) / (2 * EPS)
    rel = float(np.abs(grad - fd).max() / max(np.abs(fd).max(), 1e-12))
    return {"metric": "crown_grad_vs_fd_rel_err", "mat_id": mat_id,
            "grad_ad": [float(x) for x in grad], "grad_fd": [float(x) for x in fd],
            "value": rel}


def main() -> int:
    if not os.path.exists(STAGED):
        raise SystemExit(f"crown_grad: {STAGED} does not exist; stage the crown first: "
                         "python tools/refbuild/crown_golden.py")
    out = grad_check(STAGED, res=int(os.environ.get("CROWN_GRAD_RES", "64")),
                     depth=int(os.environ.get("CROWN_GRAD_DEPTH", "4")),
                     sample_lights=not os.environ.get("CROWN_GRAD_NO_NEE"),
                     sort=not os.environ.get("CROWN_GRAD_NOSORT"))
    print(json.dumps(out))
    return 0 if out["value"] < GATE else 1


if __name__ == "__main__":
    sys.exit(main())
