"""CLI renderer (port of nn_bvh_tpu/cli/render.py): parse a .pbrt scene,
build it and its BVH on the host, render it and write the image.

Usage:
    python -m nn_bvh_tpu_torch.cli.render scene.pbrt [--spp N] [--outfile f.exr]
        [--integrator path|simplepath|volpath|randomwalk|ao|lightpath|bdpt|mlt]
        [--maxdepth N] [--sampler s] [--seed N] [--res WxH] [--quick] [--stats]
        [--pixelstats PREFIX] [--mse-reference-image ref] [--write-partial-images]
        [--device cuda|cpu]

The flags, the integrator and sampler mapping and the output format by
extension (.png, .pfm, else EXR) are the JAX CLI's: randomwalk and ao
(ambientocclusion) waves without MIS and without light sampling; bdpt,
mlt and lightpath through their render functions (bdpt and lightpath
with the independent sampler, as their render functions default, and no
sensor); sppm and function render as Path (their render functions,
wavefront/sppm.py and lightpath.render_function, are reached through
their modules); zsobol and paddedsobol as sobol. --device defaults to the
CUDA card; without one the render raises. --stats prints the timings, the
per-pixel distributions of one extra 1-spp wave for Path and VolPath
(path length, shadow rays, surface hits, RR terminations) and one JSON
line: parse, texture-atlas packing, scene build and BVH build seconds,
render seconds, rays/s, atlas MiB, dist_avg_path_length and
rays_live_per_s (Path and VolPath) and, on the card, peak device memory.
--pixelstats PREFIX writes PREFIX-<counter>.png per-pixel stats images
(integrator.render_pixel_stats, at most 4 spp) and prints their totals as
a JSON line. Not ported yet, and raising NotImplementedError: --sharded
(ROADMAP queue 1, item 7) and --display-server (item 5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# integrator name -> the JAX CLI's wave kind
_KINDS = {"randomwalk": "randomwalk", "ambientocclusion": "ao", "ao": "ao",
          "volpath": "volpath", "simplevolpath": "volpath"}
_SAMPLERS = {"halton": "halton", "sobol": "sobol", "zsobol": "sobol",
             "paddedsobol": "sobol", "independent": "independent",
             "stratified": "stratified"}


def main(argv=None):
    """Render; returns the (H, W, 3) float32 linear sRGB image it wrote."""
    ap = argparse.ArgumentParser(description="pbrt-class renderer (PyTorch + CUDA)")
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--res", default=None, help="WxH override")
    ap.add_argument("--quick", action="store_true", help="1/4 res, spp/4 (pbrt --quick)")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--pixelstats", default=None, metavar="PREFIX")
    ap.add_argument("--mse-reference-image", default=None)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--display-server", default=None)
    ap.add_argument("--write-partial-images", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.sharded:
        raise NotImplementedError("--sharded is not ported yet (ROADMAP queue 1, item 7: dist/)")
    if args.display_server:
        raise NotImplementedError("--display-server is not ported yet (ROADMAP queue 1, "
                                  "item 5: utils/display.py)")

    import numpy as np
    import torch

    from .. import accel
    from ..devices import resolve_device
    from ..geometry import pbrt_parser
    from ..utils import image as image_mod
    from ..wavefront import camera as camera_mod, film as film_mod, integrator

    device = resolve_device(args.device)
    t0 = time.time()
    res = pbrt_parser.parse_file(args.scene)
    t_parse = time.time()
    sc = res.builder.build()
    t_build = time.time()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(res.cam_to_world, res.fov, res.width, res.height,
                                      res.lens_radius, res.focal_distance)
    for w in res.warnings:
        print(f"warning: {w}", file=sys.stderr)

    spp = args.spp or res.spp
    width, height = res.width, res.height
    if args.res:
        width, height = (int(v) for v in args.res.lower().split("x"))
    if args.quick:
        width, height, spp = width // 4, height // 4, max(spp // 4, 1)
    if (width, height) != (cam.width, cam.height):
        cam = cam._replace(width=width, height=height)

    integ = args.integrator or res.integrator
    mis = integ not in ("simplepath", "randomwalk", "ao")
    kind = _KINDS.get(integ, "path")
    cfg = integrator.IntegratorConfig(max_depth=args.maxdepth or res.max_depth, mis=mis,
                                      kind=kind, rr_depth=2 if mis else 99,
                                      sample_lights=kind not in ("randomwalk", "ao"))
    sampler = args.sampler or _SAMPLERS.get(res.sampler, "sobol")
    print(f"scene: {sc.n_tris} tris, {sc.n_lights} lights; {width}x{height}@{spp}spp "
          f"{integ}/{sampler} on {device}", file=sys.stderr)

    wave_cb = None
    if args.write_partial_images:
        def wave_cb(s, f):
            if (s & (s + 1)) == 0:  # waves 1, 3, 7, ...
                image_mod.write_pfm((args.outfile or res.filename) + ".partial.pfm",
                                    film_mod.develop(f).cpu().numpy())

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t1 = time.time()
    if integ == "bdpt":
        from ..wavefront import bdpt

        img = bdpt.render_bdpt(sc, dbvh, cam, spp=spp, seed=args.seed, cfg=cfg, device=device)
    elif integ == "mlt":
        from ..wavefront import mlt

        img = mlt.render_mlt(sc, dbvh, cam, spp=spp, seed=args.seed, cfg=cfg, device=device)
    elif integ == "lightpath":
        from ..wavefront import lightpath

        img = lightpath.render_lightpath(sc, dbvh, cam, spp=spp, seed=args.seed, cfg=cfg,
                                         device=device)
    else:
        img = integrator.render(sc, dbvh, cam, spp=spp, sampler=sampler, seed=args.seed,
                                cfg=cfg, wave_callback=wave_cb, sensor=res.make_sensor(),
                                device=device)
    arr = img.cpu().numpy()
    t2 = time.time()

    out = args.outfile or res.filename
    if out.endswith(".png"):
        image_mod.write_png(out, arr)
    elif out.endswith(".pfm"):
        image_mod.write_pfm(out, arr)
    else:
        image_mod.write_exr(out, arr)
    print(f"wrote {out}", file=sys.stderr)

    if args.stats:
        rays = width * height * spp * (2 * cfg.max_depth + 1)
        atlas = np.asarray(sc.tex_atlas)
        stats = {
            "scene_build_s": round(t1 - t0, 3),
            "parse_s": round(t_parse - t0, 3),
            "atlas_pack_s": round(res.builder.atlas_seconds, 3),
            "compile_s": round(t_build - t_parse, 3),
            "bvh_s": round(t1 - t_build, 3),
            "render_s": round(t2 - t1, 3),
            "rays_per_s": round(rays / max(t2 - t1, 1e-9), 1),
            "tris": sc.n_tris,
            "lights": sc.n_lights,
            "spp": spp,
            "atlas_mib": round(atlas.nbytes / 2**20, 3),
        }
        if device.type == "cuda":
            stats["peak_mem_mib"] = round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
        if cfg.kind in ("path", "volpath"):
            stats.update(_distributions(sc, dbvh, cam, cfg, sampler, args.seed, spp, t2 - t1,
                                        device))
        print(json.dumps(stats))

    if args.pixelstats:
        imgs, totals = integrator.render_pixel_stats(sc, dbvh, cam, spp=min(spp, 4),
                                                     sampler=sampler, seed=args.seed, cfg=cfg,
                                                     device=device)
        for name, im in imgs.items():
            mx = max(float(im.max()), 1e-9)
            image_mod.write_png(f"{args.pixelstats}-{name}.png",
                                np.repeat((im / mx)[..., None], 3, -1))
        print(json.dumps(totals))

    if args.mse_reference_image:
        ref = (image_mod.read_pfm(args.mse_reference_image)
               if args.mse_reference_image.endswith(".pfm")
               else image_mod.read_exr(args.mse_reference_image))
        print(json.dumps({"mse": image_mod.mse(arr, ref), "mrse": image_mod.mrse(arr, ref)}))
    return arr


def _distributions(sc, dbvh, cam, cfg, sampler, seed, spp, render_s, device) -> dict:
    """The per-pixel distributions of one extra 1-spp wave with the stats
    counters (the JAX CLI's STAT_INT_DISTRIBUTION summary): printed to
    stderr; returns dist_avg_path_length and rays_live_per_s (the counted
    bounces and shadow rays of that wave times spp over the render's
    seconds)."""
    import torch

    from ..core import samplers
    from ..geometry import scene as scene_mod
    from ..wavefront import integrator, volpath

    scfg = samplers.to_device(samplers.make_sampler(sampler, seed=seed, spp=1, width=cam.width),
                              device)
    cfg_s = cfg._replace(collect_stats=True)
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device=device)
    trace = volpath.trace_wave_vol if cfg.kind == "volpath" else integrator.trace_wave
    st = trace(scene_mod.to_device(sc, device), dbvh, cam, scfg, cfg_s, pix, 0)[4].cpu().numpy()
    print("per-pixel distributions (1 spp):", file=sys.stderr)
    for i, nm in enumerate(("path length", "shadow rays", "surface hits", "RR terminations")):
        v = st[:, i]
        print(f"  {nm:18s} avg {v.mean():7.2f}  min {v.min():4.0f}  max {v.max():5.0f}  "
              f"total {v.sum():10.0f}", file=sys.stderr)
    return {"dist_avg_path_length": round(float(st[:, 0].mean()), 3),
            "rays_live_per_s": round(float(st[:, 0].sum() + st[:, 1].sum()) * spp
                                     / max(render_s, 1e-9), 1)}


if __name__ == "__main__":
    main()
