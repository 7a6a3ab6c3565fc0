"""Per-stage traversal profile on the CUDA card (port of
tools/perf/trav_prof.py).

    python -m nn_bvh_tpu_torch.tools.trav_prof [bvh4|binary|hbm|bvh8 ...]

For each backend named (BVH_BACKEND's names; default bvh4), on the bench
scene (tools/bench_scene.py: 52,996 triangles, R = 160,000 rays, one per
pixel of the 400x400 camera), it times, with the ray classes and
RandomState(1) draws of the JAX script:

- camera closest-hit (sorted);
- diffuse-bounce closest-hit from the camera hits, sorted and unsorted;
- shadow any-hit from the camera hits to the area light, sorted and unsorted;
- incoherent closest-hit (origins in the scene box, uniform directions,
  sorted);
- the (dead, octant, Morton) sort + unsort alone;
- one full Path wave (depth 4, MIS, RR from depth 2, Sobol 16 spp) through
  that backend.

"Sorted" is `make_intersectors(..., sort=True)`: sort -> traverse -> unsort
around each call. An unsorted row is device time per call
(`bench_scene.device_ms`: 50 back-to-back calls between two CUDA events, the
stream held busy while the host enqueues them). The sort waits for the
device, so the stream cannot be held around it: the sorted rows and the sort
alone are torch.profiler's device time of every kernel and copy they run
(`bench_scene.profiler_us`). Each row has the host's time per call beside it
(`bench_scene.host_us`). The wave is CUDA events around 3 waves after one
warm-up wave, per wave (host-bound: the events wait on the host).
It needs a CUDA card and exits 1 without one. The last line of standard
output is one JSON object with every number, the card's name and its power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..accel import dispatch
from ..wavefront import camera as camera_mod, film as film_mod, integrator
from .bench_scene import bench_config, build_bench_scene, device_ms, host_us, profiler_us


def ray_batches(sc, cam, closest, device):
    """The ray classes of tools/perf/trav_prof.py, drawn from RandomState(1)
    in its order; `closest` (o, d, t_max) -> Hit gives the camera hits the
    bounce and shadow rays start from. -> ({name: (o, d, t_max)}, share of
    live bounce lanes)."""
    R = cam.width * cam.height
    rs = np.random.RandomState(1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).contiguous()
    pix = torch.arange(R, dtype=torch.int32, device=device)
    o_cam, d_cam = camera_mod.generate_rays(cam, pix, f32(rs.rand(R, 2)),
                                            torch.zeros((R, 2), device=device))
    o_cam, d_cam = o_cam.contiguous(), d_cam.contiguous()
    t_inf = torch.full((R,), 1e30, dtype=torch.float32, device=device)
    hit = closest(o_cam, d_cam, t_inf)

    t = torch.where(torch.isfinite(hit.t), hit.t, 0.0).cpu().numpy()
    p = o_cam.cpu().numpy() + d_cam.cpu().numpy() * t[:, None]
    found = (hit.prim >= 0).cpu().numpy()
    v = rs.randn(R, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    bounce = (f32(np.where(found[:, None], p + 1e-3 * v, 0.0)), f32(v),
              f32(np.where(found, 1e30, -1.0)))
    to_l = (np.array([0, 6, 0.0]) + rs.rand(R, 3) * np.array([4, 0, 4])
            - np.array([2, 0, 2]) - p)
    dist = np.linalg.norm(to_l, axis=1) + 1e-9
    shadow = (f32(p), f32(to_l / dist[:, None]), f32(np.where(found, dist * 0.999, -1.0)))
    o_i = (rs.rand(R, 3) - 0.5) * np.array([12, 4, 12]) + np.array([0, 2, 0])
    v = rs.randn(R, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    incoherent = (f32(o_i), f32(v), t_inf)
    return ({"camera": (o_cam, d_cam, t_inf), "bounce": bounce, "shadow": shadow,
             "incoherent": incoherent}, float(found.mean()))


def profile_backend(name: str, sc, dbvh, cam, device) -> dict:
    """Every measurement of the module docstring for one backend -> {row: ms}."""
    backend = dispatch.ENV_BACKENDS[name]
    srt = dispatch.make_intersectors(sc, dbvh, device, backend=backend, sort=True)
    uns = dispatch.Intersectors(backend, srt.tables, device)
    batches, live = ray_batches(sc, cam, srt.closest, device)
    R = cam.width * cam.height
    rows = {
        "camera closest (sorted)": (srt.closest, "camera"),
        "bounce closest (sorted)": (srt.closest, "bounce"),
        "bounce closest (unsorted)": (uns.closest, "bounce"),
        "shadow any (sorted)": (srt.any_hit, "shadow"),
        "shadow any (unsorted)": (uns.any_hit, "shadow"),
        "incoherent closest (sorted)": (srt.closest, "incoherent"),
    }
    out = {}
    print(f"backend {name} -> {backend}; bounce lanes live {live:.4f}", flush=True)
    def timed(row, call, sorts):
        if sorts:  # the sort waits for the device
            out[row], how = profiler_us(call) / 1e3, "profiler: kernels and copies"
        else:
            out[row], how = device_ms(call), "device"
        out[f"{row} host us"] = host_us(call)
        print(f"{row:30s}{out[row]:9.4f} ms {R / out[row] / 1e3:9.1f} Mray/s ({how}), "
              f"host {out[f'{row} host us']:8.1f} us/call", flush=True)

    for row, (fn, batch) in rows.items():
        args = batches[batch]
        timed(row, lambda: fn(*args), fn.__self__ is srt)

    blo, bext = srt.sort_bounds
    o_b, d_b, t_b = batches["bounce"]

    def sort_only():
        order = torch.argsort(dispatch.ray_sort_key(o_b, d_b, blo, bext, t_b), stable=True)
        return torch.empty_like(o_b).index_copy_(0, order, o_b[order])

    timed("sort+unsort alone", sort_only, True)

    cfg, sampler_cfg = bench_config()
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=uns)
    film = wave(film_mod.make_film(cam.height, cam.width, device), 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(1, 4):
        film = wave(film, s)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    if not bool(torch.isfinite(film.xyz).all()):
        raise RuntimeError(f"{name}: the wave's film is not finite")
    out["full wave (depth 4)"] = ms
    print(f"{'full wave (depth 4)':30s}{ms:9.4f} ms -> {R * 9 / ms / 1e3:.2f} Mray/s "
          "(R*9/wave)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("backends", nargs="*", default=["bvh4"],
                    choices=sorted(dispatch.ENV_BACKENDS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trav_prof: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sc, dbvh, cam = build_bench_scene()
    print(f"tris={sc.n_tris} nodes={dbvh.n_nodes} rays={cam.width * cam.height}", flush=True)
    results = {b: profile_backend(b, sc, dbvh, cam, device) for b in args.backends}
    print(json.dumps({"trav_prof": results, "device": torch.cuda.get_device_name(0),
                      "name_power_limit": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
