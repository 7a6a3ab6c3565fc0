"""What chip_smoke.py and the tools share: the bench scene and its wave's
configuration, the ray batches that one bench wave hands the traversal
(`wave_batches`) and chip_smoke's probe batches, the per-warp work of a
batch (`warp_work`), a traversal call's bound and hit contract, a synthetic
deep tree for the deep-stack traversal, a synthetic widening tree for the
lab's stack check, and timing on the card: `device_ms` (device time per
call, many calls between two CUDA events on a stream held busy while the
host enqueues them; or, with L2 flushed before each call, the median of
single calls), `host_us` (the host's time per call), `profiler_us`
(torch.profiler's device time, also for a call that waits for the device),
`median_ms` (single calls between events; host and device time together,
kept for the packet kernels) and `time_traversals` (traversal kernels held
to the contract and timed side by side on named batches)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import accel
from ..accel import dispatch
from ..accel.traverse import DeviceBVH
from ..core import samplers
from ..geometry import scene as scene_mod, transform as xf
from ..wavefront import camera as camera_mod, film as film_mod, integrator

BENCH_SIZE = 400  # bench.py renders 400x400
BENCH_DEPTH = 4   # bench.py's max depth
WARP = 32

# The bound of a traversal call (chip_smoke phase 9's rule). Work per test,
# counted from csrc/traverse_common.cuh. A box (slab) test: 6 sub + 6 mul,
# 5 min/max for tn, 5 for tf, 1 mul by 1.0000004, 3 compares = 26. A
# Moller-Trumbore test: 6 sub for the edges, 9 for p, 5 for det, 1 compare
# of |det|, 1 div, 3 sub for s, 6 for b1, 9 for q, 6 for b2, 6 for t, 5
# compares + 1 add for the hit = 58 (the edges are counted though the BVH4
# kernel reads them precomputed: the yardstick is the function's). The sort
# of a wide node's children is not counted.
FLOPS_SLAB = 26
FLOPS_TRI = 58
TRI_BYTES = 36        # an (N, 3, 3) float32 triangle, whatever layout a kernel reads
PEAK_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def build_bench_scene():
    """bench.py:45-70 with the port's modules (the same RandomState(42)
    draws): 24 spheres, a floor and an emissive quad, 52,996 triangles, SAH
    BVH, 400x400 camera -> (host scene, DeviceBVH, camera)."""
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
        width=BENCH_SIZE, height=BENCH_SIZE)
    return sc, dbvh, cam


def build_deep_tree(levels: int = 100, seed: int = 0):
    """A "caterpillar" binary BVH of depth `levels`: interior node 2k has the
    leaf 2k+1 (triangle k) and the interior node 2k+2; node 2*levels is the
    leaf of the last triangle. The levels+1 small tilted triangles sit along
    the x axis, 0.1 apart. -> (tri_p (levels+1, 3, 3) f32, DeviceBVH)."""
    rs = np.random.RandomState(seed)
    n = levels + 1
    x = 0.1 * np.arange(n)[:, None] + rs.uniform(-0.02, 0.02, (n, 3))
    y0, z0 = rs.uniform(0.0, 0.2, (2, n))
    tri = np.zeros((n, 3, 3), np.float32)
    tri[:, :, 0] = x
    tri[:, :, 1] = np.stack([y0, y0 + 1.0, y0], 1)
    tri[:, :, 2] = np.stack([z0, z0, z0 + 1.0], 1)
    t_lo, t_hi = tri.min(1), tri.max(1)
    # suffix boxes: triangles k..levels
    s_lo = np.minimum.accumulate(t_lo[::-1], 0)[::-1]
    s_hi = np.maximum.accumulate(t_hi[::-1], 0)[::-1]
    nn = 2 * levels + 1
    lo = np.zeros((nn, 3), np.float32)
    hi = np.zeros((nn, 3), np.float32)
    meta = np.zeros((nn, 3), np.int32)
    k = np.arange(levels)
    lo[2 * k], hi[2 * k] = s_lo[k], s_hi[k]
    meta[2 * k, 0] = 2 * k + 2                      # interior, split on x
    lo[2 * k + 1], hi[2 * k + 1] = t_lo[k], t_hi[k]
    meta[2 * k + 1, 0:2] = np.stack([k, np.ones_like(k)], 1)  # one-triangle leaf
    lo[-1], hi[-1] = t_lo[-1], t_hi[-1]
    meta[-1, 0:2] = (levels, 1)
    return tri, DeviceBVH(node_lo=lo, node_hi=hi, node_meta=meta, n_nodes=nn)


def deep_tree_rays(levels: int, R: int, seed: int = 1):
    """Rays for build_deep_tree(levels): a third come from +x down the whole
    chain (the deepest walks), a third from -x, a third from random points
    in random directions; 20% dead lanes. -> o, d, t_max (numpy f32)."""
    rs = np.random.RandomState(seed)
    span = 0.1 * levels
    o = np.empty((R, 3), np.float32)
    d = np.empty((R, 3), np.float32)
    third = R // 3
    yz = rs.uniform(-0.2, 1.4, (R, 2))
    o[:third] = np.c_[np.full(third, span + 5.0), yz[:third]]
    d[:third] = np.c_[-np.ones(third), rs.uniform(-0.02, 0.02, (third, 2))]
    o[third:2 * third] = np.c_[np.full(third, -5.0), yz[third:2 * third]]
    d[third:2 * third] = np.c_[np.ones(third), rs.uniform(-0.02, 0.02, (third, 2))]
    rest = R - 2 * third
    o[2 * third:] = rs.uniform([-1, -0.5, -0.5], [span + 1, 1.5, 1.5], (rest, 3))
    d[2 * third:] = rs.randn(rest, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.rand(R) < 0.2, -1.0, 1e30).astype(np.float32)
    return o, d, t_max


def build_widening_tree(levels: int = 20):
    """A binary BVH (DFS layout, split axis x, every box [-1, 1]^3) on which
    a packet heading +x visits every node and a walk popping 4 entries per
    iteration keeps 4 more entries per level: the near child of each
    P-node is a P-node, its far child a Q-node; a Q-node has two
    leaf-parents, a leaf-parent two one-triangle leaves; below `levels` a
    P-node is a leaf-parent. Depth levels + 2.
    -> (tri_p (Nn, 3, 3) f32, triangle i in front of leaf i, DeviceBVH)."""
    meta = []

    def node(kind, depth):
        i = len(meta)
        meta.append([i, 1, 0])  # a leaf of triangle i until it gets children
        if kind == "leaf":
            return
        if kind == "P" and depth >= levels:
            kind = "LP"
        near, far = {"P": ("P", "Q"), "Q": ("LP", "LP"), "LP": ("leaf", "leaf")}[kind]
        node(near, depth + 1)  # child i + 1
        meta[i] = [len(meta), 0, 0]
        node(far, depth + 1)

    node("P", 0)
    n = len(meta)
    tri = np.zeros((n, 3, 3), np.float32)
    tri[:, :, 0] = 0.5 + 1e-3 * np.arange(n)[:, None]
    tri[:, 0, 1:] = -0.5
    tri[:, 1, 1] = tri[:, 2, 2] = 1.0
    return tri, DeviceBVH(node_lo=np.full((n, 3), -1.0, np.float32),
                          node_hi=np.full((n, 3), 1.0, np.float32),
                          node_meta=np.array(meta, np.int32), n_nodes=n)


def widening_tree_rays(R: int, seed: int = 0):
    """Rays for build_widening_tree: from near (-0.5, -0.5, -0.5) heading
    +x, all live. -> o, d, t_max (numpy f32)."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(R, 3) * 0.1 - 0.5).astype(np.float32)
    d = np.tile(np.float32([1.0, 0.05, 0.05]), (R, 1))
    return o, d, np.full((R,), 1e30, np.float32)


def median_ms(fn, n: int = 5) -> float:
    """Median of n calls of fn on the current CUDA stream, each between two
    CUDA events, after one warm-up call."""
    fn()
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


def bench_config():
    """bench.py's wave: Path, MIS, Russian roulette from depth 2, depth 4,
    Sobol 16 spp, seed 0 -> (IntegratorConfig, sampler config)."""
    return (integrator.IntegratorConfig(max_depth=BENCH_DEPTH, mis=True, rr_depth=2),
            samplers.make_sampler("sobol", seed=0, spp=16))


def volpath_bench_config():
    """The bench wave with kind="volpath" (the `volpath_bench`
    configuration): depth 4, Russian roulette from depth 2, power light
    sampler, Sobol 16 spp, seed 0 -> (IntegratorConfig, sampler config). On
    the bench scene (no media) its mean equals Path's in expectation."""
    return (integrator.IntegratorConfig(kind="volpath", max_depth=BENCH_DEPTH, rr_depth=2),
            samplers.make_sampler("sobol", seed=0, spp=16))


FOG_DEPTH = 100  # the crown's maxdepth


def build_fog_scene(size: int = BENCH_SIZE, interface=False):
    """The `volpath_fog` scene: tests/test_phased_wave.py:29-38's fog sphere
    (a diffuse sphere filled with a homogeneous scattering medium, a floor,
    an emissive quad) with that test's camera, at the bench's 400x400 ->
    (host scene, DeviceBVH, camera). The diffuse sphere is opaque, so no ray
    reaches its medium; interface=True makes the sphere a pure medium
    boundary (material -1), so rays enter the fog and scatter in it;
    interface="glass" makes it a smooth dielectric (eta 1.33) holding the
    fog, so rays enter the fog by real transmission."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.3, 0.3, 0.3))
    if interface == "glass":
        shell = b.add_material("dielectric", eta=1.33)
    else:
        shell = -1 if interface else m
    b.add_sphere((0, 1, 0), 0.8, shell, n_theta=10, n_phi=20, med_inside=fog)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(xf.look_at((0, 2, -4), (0, 1, 0), (0, 1, 0)), fov=50.0,
                                      width=size, height=size)
    return sc, dbvh, cam


MATERIAL_KINDS = ("dielectric", "rough dielectric", "thin dielectric", "diffuse transmission",
                  "coated diffuse", "coated conductor", "mix", "hair", "measured",
                  "subsurface", "gold", "diffuse")


def ggx_rgb(wo, wi, alpha: float = 0.3, rgb=(0.9, 0.6, 0.3)):
    """A GGX reflection lobe with a constant Fresnel colour, numpy, for
    measured.tabulate: D G rgb / (4 cos_o cos_i) -> (..., 3)."""
    wm = wo + wi
    wm = wm / np.maximum(np.linalg.norm(wm, axis=-1, keepdims=True), 1e-12)
    a2 = alpha * alpha
    d = a2 / (np.pi * (wm[..., 2] ** 2 * (a2 - 1.0) + 1.0) ** 2)

    def lam(w):
        c2 = np.maximum(w[..., 2] ** 2, 1e-12)
        return 0.5 * (np.sqrt(1.0 + a2 * (1.0 - c2) / c2) - 1.0)

    g = 1.0 / (1.0 + lam(wo) + lam(wi))
    f = d * g / np.maximum(4.0 * wo[..., 2] * wi[..., 2], 1e-6)
    return (f[..., None] * np.asarray(rgb, np.float32)).astype(np.float32)


def add_material_kinds(b, coated: bool = True) -> list:
    """The material scene's twelve materials, in MATERIAL_KINDS order, added
    to b (a SceneBuilder of either package: the same calls build the same
    tables) -> their ids. coated=False makes the two coated ones diffuse."""
    from ..scatter import measured

    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    table = b.add_measured_brdf(measured.tabulate(ggx_rgb, (16, 16, 16)))
    coat = (lambda kind, **kw: b.add_material(kind, **kw)) if coated else \
        (lambda kind, **kw: b.add_material("diffuse", reflectance=kw["reflectance"]))
    return [
        b.add_material("dielectric", eta=1.5),
        b.add_material("dielectric", eta=1.5, roughness=0.2),
        b.add_material("thindielectric", eta=1.5),
        b.add_material("diffusetransmission", reflectance=(0.5, 0.6, 0.7)),
        coat("coateddiffuse", reflectance=(0.7, 0.3, 0.2), roughness=0.1),
        coat("coatedconductor", reflectance=(0.9, 0.75, 0.5), roughness=0.1),
        b.add_material("mix", mix_materials=(diffuse, metal), mix_amount=0.5),
        b.add_material("hair", reflectance=(0.4, 0.25, 0.1), roughness=0.3, eta=1.55),
        b.add_material("measured", measured=table),
        b.add_material("subsurface", sigma_a=(0.02, 0.04, 0.07), sigma_s=(2.2, 2.6, 3.0),
                       sss_scale=2.0, eta=1.33),
        b.add_material("conductor", reflectance=(1.0, 1.0, 1.0), roughness=0.1,
                       eta_spectrum="metal-Au-eta", k_spectrum="metal-Au-k"),
        diffuse,
    ]


def sphere_uvs(n_theta: int, n_phi: int) -> np.ndarray:
    """Per-vertex (phi / 2 pi, theta / pi) of SceneBuilder.add_sphere's
    vertex grid: hair reads its fiber offset from v."""
    tt, pp = np.meshgrid(np.linspace(0, np.pi, n_theta + 1),
                         np.linspace(0, 2 * np.pi, n_phi + 1), indexing="ij")
    return np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2).astype(np.float32)


def material_scene(b, n_spheres: int = 24, n_theta: int = 24, n_phi: int = 48,
                   coated: bool = True):
    """Fill b (a SceneBuilder of either package) with the bench geometry
    (bench.py's RandomState(42) spheres, floor and emissive quad) whose
    spheres cycle through add_material_kinds -> b."""
    rs = np.random.RandomState(42)
    mats = add_material_kinds(b, coated)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    uvs = sphere_uvs(n_theta, n_phi)
    for i in range(n_spheres):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, mats[i % len(mats)], n_theta=n_theta, n_phi=n_phi, uvs=uvs)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    return b


def build_material_scene(size: int = BENCH_SIZE, coated: bool = True):
    """The material scene: the bench geometry (52,996 triangles, floor,
    emissive quad) with its 24 spheres cycling through the twelve materials
    of MATERIAL_KINDS (coated=False: the coated spheres diffuse), SAH BVH,
    the bench camera -> (host scene, DeviceBVH, camera)."""
    sc, dbvh, _ = accel.build_scene_bvh(material_scene(scene_mod.SceneBuilder(),
                                                       coated=coated).build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)), fov=50.0, width=size, height=size)
    return sc, dbvh, cam


def volpath_fog_config():
    """The crown's integrator settings (bench.py:122-126): VolPath, MIS,
    depth 100, Russian roulette from depth 2, power light sampler, 64 spp;
    Sobol, seed 0, where the crown uses Halton (not ported) ->
    (IntegratorConfig, sampler config)."""
    return (integrator.IntegratorConfig(kind="volpath", max_depth=FOG_DEPTH, rr_depth=2,
                                        mis=True, light_sampler="power"),
            samplers.make_sampler("sobol", seed=0, spp=64))


def probe_batches(sc, cam, dev):
    """chip_smoke phase 3's batches: camera rays of sample 0 and incoherent
    rays (origins in the scene box, uniform directions), one t_max with 20%
    dead lanes. -> {"camera" | "incoherent": (o, d, t_max)}."""
    R = cam.width * cam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    sid = torch.zeros(R, dtype=torch.int32, device=dev)
    scfg = bench_config()[1]
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


class RecordingIntersectors(dispatch.Intersectors):
    """The Intersectors of `isect`, keeping a copy of every batch they are
    handed, as (o, d, t_max, any_hit), in `batches`."""

    def __init__(self, isect: dispatch.Intersectors):
        super().__init__(isect.backend, isect.tables, isect.device, isect.sort_bounds)
        self.batches = []

    def _call(self, o, d, t_max, any_hit):
        self.batches.append((o.clone(), d.clone(), t_max.clone(), any_hit))
        return super()._call(o, d, t_max, any_hit)


class CheckedIntersectors(dispatch.Intersectors):
    """The Intersectors of `isect`, holding each batch they are handed
    against `plain` on the same batch (check_hits) and returning isect's
    result. `sizes` keeps each batch's lane count and any-hit flag, `ties`
    the sum of tie lanes."""

    def __init__(self, isect: dispatch.Intersectors, plain: dispatch.Intersectors,
                 label: str):
        super().__init__(isect.backend, isect.tables, isect.device, isect.sort_bounds)
        self.plain, self.label = plain, label
        self.sizes, self.ties = [], 0

    def _call(self, o, d, t_max, any_hit):
        out = super()._call(o, d, t_max, any_hit)
        ref = self.plain._call(o, d, t_max, any_hit)
        self.ties += check_hits(out, ref, t_max, any_hit,
                                f"{self.label}, batch {len(self.sizes)} of {o.shape[0]} lanes")
        self.sizes.append((o.shape[0], any_hit))
        return out


def bench_wave(sc, dbvh, cam, isect) -> film_mod.Film:
    """One bench wave (bench_config, sample 0) through `isect` on a new
    film -> the film."""
    cfg, scfg = bench_config()
    wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
    return wave(film_mod.make_film(cam.height, cam.width, isect.device), 0)


def wave_batches(sc, dbvh, cam, device=None) -> list:
    """The traversal batches of one bench wave (sample 0, seed 0) through
    the default intersectors of `device` (cuda_bvh4 on the card):
    [(o, d, t_max, any_hit)], as trace_wave hands them over.
    Depth 4 gives 9: camera closest, then shadow any-hit and bounce closest
    for each depth. On a CUDA backend the lanes are in the integrator's
    order: re-sorted at the start of each bounce (dead, octant, Morton), so
    a bounce's closest-hit batch has its dead lanes last; its shadow batch
    and the trailing closest-hit batch keep that order, with the lanes that
    died since among the live ones."""
    rec = RecordingIntersectors(dispatch.make_intersectors(sc, dbvh, device))
    bench_wave(sc, dbvh, cam, rec)
    return rec.batches


def wave_batch_names(batches) -> list:
    """"camera closest", "shadow d0 any", "bounce d1 closest", ... for the
    batches of wave_batches."""
    names, depth = [], 0
    for i, b in enumerate(batches):
        if b[3]:
            names.append(f"shadow d{depth} any")
            depth += 1
        else:
            names.append("camera closest" if i == 0 else f"bounce d{depth} closest")
    return names


def record_width(nodes: torch.Tensor) -> int:
    """Boxes a record of a plain walk's node table holds, one box test each
    per node visit: a wide record (W, width, 8) its width, a binary pair
    record (N, 16) two."""
    return nodes.shape[1] if nodes.dim() == 3 else 2


def warp_work(counts: dict, width: int = 4) -> dict:
    """A plain walk's per-lane `counts` (traverse.*_plain(counts=)) -> the
    work of its live lanes (those that slab-tested at least one box): node
    visits (box tests / `width`, the record_width of its table) and
    triangle tests per lane, mean, p99 and max, and the mean over live
    32-lane groups (warps, in lane order) of the group's most; a warp runs
    as long as its longest lane."""
    nodes = (counts["slab"] // width).cpu().numpy()
    tris = counts["tri"].cpu().numpy()
    live = nodes > 0
    out = {"lanes": int(nodes.size), "live": int(live.sum())}
    pad = (-nodes.size) % WARP
    for key, x in (("nodes", nodes), ("tris", tris)):
        xl = x[live] if live.any() else np.zeros(1, x.dtype)
        out[f"{key}_mean"] = float(xl.mean())
        out[f"{key}_p99"] = float(np.percentile(xl, 99, method="higher"))
        out[f"{key}_max"] = int(xl.max())
        w = np.pad(x, (0, pad)).reshape(-1, WARP)
        w_live = np.pad(live, (0, pad)).reshape(-1, WARP).any(1)
        out[f"warp_{key}"] = float(w.max(1)[w_live].mean()) if w_live.any() else 0.0
    return out


def bound_of(flops, nbytes):
    """-> (max(FLOPs / peak, bytes / peak) in ms, which of the two sets it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def traversal_bound(counts: dict, t_max: torch.Tensor, any_hit: bool, nodes: torch.Tensor):
    """Least time of one traversal call: the box and triangle tests that the
    plain walk counted on this batch (`counts`), and the bytes: o and d of
    the live lanes (the only ones read), t_max, the outputs (t, prim, b1, b2;
    any-hit writes prim only), and once each the node records of `nodes`
    (the walk's node table) and the triangles (TRI_BYTES each) that the walk
    read on this batch (counts' "node_records" and "tri_records"), not the
    whole tables. -> (ms, "bytes" | "operations", work dict with the ray
    bytes and the table bytes apart)."""
    slab, tri = int(counts["slab"].sum()), int(counts["tri"].sum())
    flops = slab * FLOPS_SLAB + tri * FLOPS_TRI
    R = t_max.numel()
    live = int(((t_max >= 0) if any_hit else (t_max > 0)).sum())
    ray_bytes = live * (12 + 12) + R * 4 + R * (4 if any_hit else 16)
    table_bytes = (counts["node_records"] * nodes[0].numel() * nodes.element_size()
                   + counts["tri_records"] * TRI_BYTES)
    return (*bound_of(flops, ray_bytes + table_bytes),
            dict(slab_tests=slab, tri_tests=tri, flops=flops, ray_bytes=ray_bytes,
                 table_bytes=table_bytes))


def check_hits(out, ref, t_max: torch.Tensor, any_hit: bool, label: str) -> int:
    """A traversal kernel's result against its plain version's on one
    batch, under the kernels' contract: closest-hit t bit-equal on every
    lane; prim, b1 and b2 equal wherever prim is; a lane whose prim differs
    is an exact t tie of two hit triangles; dead lanes miss (t = inf, prim
    = -1, b1 = b2 = 0); any-hit occlusion equal on every lane, dead lanes
    occluded. Raises AssertionError; -> the number of tie lanes."""
    def need(cond, msg):
        if not cond:
            raise AssertionError(f"{label}: {msg}")

    if any_hit:
        need(torch.equal(out, ref), f"occlusion differs on {int((out != ref).sum())} lanes")
        need(bool(out[t_max < 0].all()), "a dead lane is not occluded")
        return 0
    need(torch.equal(out.t, ref.t), f"t differs on {int((out.t != ref.t).sum())} lanes")
    same = out.prim == ref.prim
    need(torch.equal(out.b1[same], ref.b1[same]) and torch.equal(out.b2[same], ref.b2[same]),
         "b1 / b2 differ on lanes of equal prim")
    ties = ~same
    need(bool(((out.prim[ties] >= 0) & (ref.prim[ties] >= 0)).all()),
         "a lane's prim differs without a hit on both sides")
    dead = t_max <= 0
    need(bool((out.prim[dead] == -1).all() and torch.isinf(out.t[dead]).all()
              and (out.b1[dead] == 0).all() and (out.b2[dead] == 0).all()),
         "a dead lane does not miss")
    return int(ties.sum())


def _need_card(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures on a CUDA card; none is present")


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


@functools.cache
def _l2_flush(index: int) -> torch.Tensor:
    """An int32 buffer of twice the L2 of card `index`: writing it evicts
    whatever the last call left in L2."""
    l2 = torch.cuda.get_device_properties(index).L2_cache_size
    return torch.empty(2 * l2 // 4, dtype=torch.int32, device=torch.device("cuda", index))


def device_ms(fn, n: int = 50, cold: bool = False) -> float:
    """Device time of one call of fn (ms) on the current stream: after a
    warm-up call, the stream is held busy by torch.cuda._sleep while the
    host enqueues a start event, n calls and an end event, so the events
    enclose only the device's work (and the gaps between back-to-back
    launches). cold=True: before each call the stream writes a buffer of
    twice the card's L2, so each call finds its tables in device memory,
    each call lies between its own pair of events, and the median of the n
    times is returned. If the (first) start event has already passed when
    the host is done enqueuing, the sleep was too short and the measurement
    is repeated with a longer one; when that keeps happening, fn waits for
    the device and this raises (`profiler_us` measures such a fn). Raises
    without a card."""
    _need_card("device_ms")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    flush = _l2_flush(torch.cuda.current_device()) if cold else None
    hold_ms = 2e3 * n * host_s + 1.0
    for _ in range(5):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n if cold else 1)]
        torch.cuda._sleep(int(hold_ms * _sleep_cycles_per_ms()))
        if cold:
            for start, end in events:
                flush.fill_(0)
                start.record()
                fn()
                end.record()
        else:
            events[0][0].record()
            for _ in range(n):
                fn()
            events[0][1].record()
        held = not events[0][0].query()
        torch.cuda.synchronize()
        if held:
            if cold:
                return float(np.median([start.elapsed_time(end) for start, end in events]))
            return events[0][0].elapsed_time(events[0][1]) / n
        hold_ms *= 4
    raise RuntimeError("device_ms: the start event passed before the host had enqueued the "
                       "calls, however long the stream was held: the function waits for the "
                       "device")


def host_us(fn, n: int = 50) -> float:
    """Host time of one call of fn (microseconds): n calls on the host clock,
    no synchronise between them (the enqueue a host-bound caller pays).
    Raises without a card."""
    _need_card("host_us")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def profiler_us(fn, match: str = "", n: int = 20) -> float:
    """torch.profiler's device time per call of fn (microseconds) over n
    calls: of the kernels whose name contains `match`, or of every kernel
    and copy fn runs (the device's busy time, measurable also for a fn that
    waits for the device: sorts, compactions). 0.0 when the profiler records
    no device time. Raises without a card."""
    from torch.profiler import ProfilerActivity, profile

    _need_card("profiler_us")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if match in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            total += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
    return total / n


PROFILED = ("camera closest", "bounce d1 closest")


def time_traversals(fns: dict, batches: dict, plain: dispatch.Intersectors,
                    timed: bool = True) -> dict:
    """Traversal kernels side by side. fns {label: fn(o, d, t_max, any_hit)},
    batches {name: (o, d, t_max, any_hit)}, `plain` the plain intersectors
    of the same scene. On each batch, the plain walk (one call between two
    CUDA events) gives the reference, its counts, the per-warp work
    (warp_work) and the bound (traversal_bound); every kernel is held to
    check_hits. Then each kernel's device time on every batch is read in
    turns, the labels in order and then in reverse, so each is read twice
    around the others; then its device time with L2 flushed before each
    call (device_ms(cold=True)), its host time per call, and
    torch.profiler's time of its kernels (`match` "traverse") on the batches
    named in PROFILED. timed=False stops after the checks. -> {name:
    {"live", warp_work's keys, "bound_ms", "bound_by", "work", "plain_ms",
    "ties", "device_ms" (two readings), "cold_ms", "host_us",
    "profiler_us"; the last five by label}}."""
    rows = {}
    for name, (o, d, t_max, any_hit) in batches.items():
        counts = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = plain.fn(*plain.tables, o, d, t_max, any_hit, counts=counts)
        end.record()
        torch.cuda.synchronize()
        bound, by, work = traversal_bound(counts, t_max, any_hit, plain.tables[0])
        rows[name] = {**warp_work(counts, record_width(plain.tables[0])),
                      "bound_ms": bound, "bound_by": by, "work": work,
                      "plain_ms": start.elapsed_time(end),
                      "ties": {label: check_hits(fn(o, d, t_max, any_hit), ref, t_max, any_hit,
                                                 f"{label} {name}")
                               for label, fn in fns.items()},
                      "device_ms": {}, "cold_ms": {}, "host_us": {}, "profiler_us": {}}
    if not timed:
        return rows
    for label in [*fns, *reversed(fns)]:
        for name, (o, d, t_max, any_hit) in batches.items():
            rows[name]["device_ms"].setdefault(label, []).append(
                device_ms(lambda: fns[label](o, d, t_max, any_hit)))
    for label, fn in fns.items():
        for name, (o, d, t_max, any_hit) in batches.items():
            call = lambda: fn(o, d, t_max, any_hit)
            rows[name]["cold_ms"][label] = device_ms(call, cold=True)
            rows[name]["host_us"][label] = host_us(call)
            if name in PROFILED:
                rows[name]["profiler_us"][label] = profiler_us(call, "traverse")
    return rows


def mean_ms(row: dict, label: str) -> float:
    """The mean of a time_traversals row's device-time readings of `label`."""
    readings = row["device_ms"][label]
    return sum(readings) / len(readings)
