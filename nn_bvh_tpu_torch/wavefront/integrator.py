"""Wavefront Path integrator (port of the `kind="path"` path of
nn_bvh_tpu/wavefront/integrator.py).

One 1-spp wave traces one path per pixel as a dense batch of lanes; every
stage (camera rays, intersect, emission, material, shadow rays, BSDF
sampling, Russian roulette, film) is a batched torch op. Semantics are the
JAX package's: power-heuristic MIS between light and BSDF sampling
(mis=False gives SimplePath), Russian roulette after `rr_depth`, the same
sampler-dimension schedule, so the same seed draws the same numbers.

Differences of form, not of result:
- the JAX while-loop early exit is a Python loop that checks `active.any()`
  once per bounce and skips the trailing emission segment when every lane
  is dead (it would add nothing);
- lanes that cannot receive escaped radiance (a scene with no infinite
  light) skip that block, and Russian roulette is skipped below `rr_depth`
  (where it keeps every lane and divides beta by 1);
- on every CUDA traversal backend the lane state is re-sorted once per
  bounce (dead, octant, Morton) before the traversals; `perm` scatters the
  radiance back to the caller's lane order, so no pixel value depends on it.

Entry points run on the CUDA card unless the caller asks for the CPU
(`devices.resolve_device`). Traversal runs under no_grad: gradients reach shading only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, spectrum, samplers
from ..geometry import scene as scene_mod, texture
from ..scatter import bxdf, lights, lightsamplers
from ..accel import dispatch
from ..accel.traverse import Hit
from ..devices import resolve_device
from . import camera as camera_mod, film as film_mod

# sampler dimension layout per pixel sample (the JAX package's schedule)
DIM_PIXEL = 0       # 2 dims
DIM_WAVELENGTH = 2  # 1 dim
DIM_LENS = 3        # 2 dims
DIM_PATH_BASE = 5
DIMS_PER_DEPTH = 7  # [bsdf_uc, bsdf_u, bsdf_v, light_select, light_u, light_v, rr]


class IntegratorConfig(NamedTuple):
    max_depth: int = 5
    mis: bool = True              # False = SimplePath semantics
    rr_depth: int = 1             # Russian roulette from this depth on
    light_sampler: str = "power"  # uniform | power
    kind: str = "path"            # the only integrator of this slice


class ShadingPoint(NamedTuple):
    p: torch.Tensor
    ng: torch.Tensor
    ns: torch.Tensor
    uv: torch.Tensor
    mat: torch.Tensor
    prim: torch.Tensor
    light: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    uv_scale: torch.Tensor
    t: torch.Tensor


def _shading_point(scene, hit: Hit, o, d) -> ShadingPoint:
    """Hit shading data from one fused tri_shade gather."""
    rec = scene.tri_shade[torch.clamp(hit.prim, min=0).long()]
    v0, v1, v2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
    b0 = 1.0 - hit.b1 - hit.b2
    t_fin = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    p = o + t_fin[..., None] * d
    ng = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    ns = vm.normalize(b0[..., None] * rec[..., 9:12] + hit.b1[..., None] * rec[..., 12:15]
                      + hit.b2[..., None] * rec[..., 15:18])
    ns = torch.where(vm.length_squared(ns)[..., None] < 0.5, ng, ns)
    uv = (b0[..., None] * rec[..., 18:20] + hit.b1[..., None] * rec[..., 20:22]
          + hit.b2[..., None] * rec[..., 22:24])
    duv1 = rec[..., 20:22] - rec[..., 18:20]
    duv2 = rec[..., 22:24] - rec[..., 18:20]
    uv_area = 0.5 * (duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]).abs()
    w_area = 0.5 * vm.safe_sqrt(vm.length_squared(vm.cross(v1 - v0, v2 - v0)))
    uv_scale = vm.safe_sqrt(uv_area / torch.clamp(w_area, min=1e-20))
    return ShadingPoint(p=p, ng=ng, ns=ns, uv=uv, mat=rec[..., 24].to(torch.int32),
                        prim=hit.prim, light=rec[..., 25].to(torch.int32),
                        v0=v0, v1=v1, v2=v2, uv_scale=uv_scale, t=t_fin)


def _check_cfg(cfg: IntegratorConfig):
    if cfg.kind != "path":
        raise NotImplementedError(f"integrator {cfg.kind!r} is not ported yet "
                                  "(ROADMAP queue 1, items 1 and 9)")


def trace_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, pixel_idx,
               sample_idx, ls_tables=None, isect=None):
    """Trace one path per entry of pixel_idx -> (L, lam, lam_pdf, film_w).
    `scene` holds tensors on pixel_idx's device (geometry.scene.to_device)."""
    _check_cfg(cfg)
    device = pixel_idx.device
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device)
    do_resort = isect.backend in dispatch.CUDA_BACKENDS
    sort_blo = scene.bounds[0]
    sort_bext = torch.clamp(scene.bounds[1] - sort_blo, min=1e-9)

    def isect_closest(o, d, t_max):
        with torch.no_grad():
            return isect.closest(o.detach(), d.detach(), t_max.detach())

    def isect_any(o, d, t_max):
        with torch.no_grad():
            return isect.any_hit(o.detach(), d.detach(), t_max.detach())

    R = pixel_idx.shape[0]
    sidx = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    f32 = dict(dtype=torch.float32, device=device)

    # camera rays and wavelengths
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PIXEL)
    u_pix = torch.stack([upx, upy], -1)
    film_w = torch.ones(R, **f32)
    ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_LENS)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix, torch.stack([ulx, uly], -1))
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)

    S = spectrum.N_SPECTRUM_SAMPLES
    L = torch.zeros(R, S, **f32)
    beta = torch.ones(R, S, **f32)
    active = torch.ones(R, dtype=torch.bool, device=device)
    specular_prev = torch.ones(R, dtype=torch.bool, device=device)
    prev_pdf = torch.ones(R, **f32)
    eta_scale = torch.ones(R, **f32)
    # ray-cone state (texture LOD; textures are not in this slice)
    cone_w = torch.zeros(R, **f32)
    cone_s = torch.full((R,), texture.camera_spread(cam.fov, cam.height), **f32)

    n_lights = scene.n_lights
    mat_all = bxdf.material_records(scene)
    if n_lights > 0:
        light_all = lights.light_records(scene)
        is_inf = scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE
        has_inf = bool(is_inf.any())
        inf_sel_pmf = torch.where(is_inf, ls_tables.pmf, 0.0).sum()

    def add_emission(o, d, L, beta, active, specular_prev, prev_pdf, prev_p, lam):
        """Intersect + escaped-ray + emissive-hit contributions."""
        hit = isect_closest(o, d, torch.where(active, 1e30, -1.0))
        found = active & (hit.prim >= 0)
        if n_lights > 0 and has_inf:
            escaped = active & (hit.prim < 0)
            le_inf = lights.infinite_le(scene, d, lam)
            if cfg.mis:
                pdf_l = (sampling.UNIFORM_SPHERE_PDF * inf_sel_pmf).expand(R)
                w_mis = torch.where(specular_prev, 1.0,
                                    sampling.power_heuristic(1.0, prev_pdf, 1.0, pdf_l))
            else:
                w_mis = torch.where(specular_prev, 1.0, 0.0)
            L = L + torch.where(escaped[..., None], beta * le_inf * w_mis[..., None], 0.0)

        sp = _shading_point(scene, hit, o, d)
        wo = -d
        if n_lights > 0:
            lrec = light_all[torch.clamp(sp.light, min=0).long()]
            has_light = found & (sp.light >= 0)
            le = lights.area_light_l_rec(lrec, has_light, sp.ng, wo, lam)
            if cfg.mis:
                pdf_shape = lights.area_pdf_li_from_verts(sp.v0, sp.v1, sp.v2, prev_p)
                is_sph = lrec[..., 0].to(torch.int32) == scene_mod.LIGHT_SPHERE_AREA
                pdf_shape = torch.where(
                    is_sph, lights.sphere_pdf_li(lrec, prev_p, sp.p, sp.ng), pdf_shape)
                pdf_l = pdf_shape * lightsamplers.pmf_ctx(ls_tables, prev_p, sp.light)
                w_mis = torch.where(specular_prev, 1.0,
                                    sampling.power_heuristic(1.0, prev_pdf, 1.0, pdf_l))
            else:
                w_mis = torch.where(specular_prev, 1.0, 0.0)
            L = L + torch.where(found[..., None], beta * le * w_mis[..., None], 0.0)
        return L, found, sp, wo

    def bounce(depth: int, state):
        if do_resort:
            key = dispatch.ray_sort_key(state[0], state[1], sort_blo, sort_bext,
                                        torch.where(state[4], 1.0, -1.0))
            order = torch.argsort(key, stable=True)
            state = tuple(a[order] for a in state)
        (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
         cone_w, cone_s, pix, lam, perm) = state
        base = DIM_PATH_BASE + depth * DIMS_PER_DEPTH

        L, found, sp, wo = add_emission(o, d, L, beta, active, specular_prev,
                                        prev_pdf, prev_p, lam)
        active = found
        cone_at_hit = cone_w + sp.t * cone_s
        foot = texture.cone_foot_log2(cone_at_hit, vm.absdot(d, sp.ns), sp.uv_scale)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv, foot_log2=foot)
        active = active & (sp.mat >= 0)
        wo_local = vm.to_local(sp.ns, wo)

        # direct lighting
        if n_lights > 0:
            u_sel = samplers.get_1d(sampler_cfg, pix, sidx, base + 3)
            ulu, ulv = samplers.get_2d(sampler_cfg, pix, sidx, base + 4)
            light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, sp.p, u_sel)
            ls = lights.sample_li(scene, light_all, light_id, sp.p, lam,
                                  torch.stack([ulu, ulv], -1))
            f_l, pdf_b = bxdf.evaluate(ctx, wo_local, vm.to_local(sp.ns, ls.wi))
            cos_l = vm.absdot(ls.wi, sp.ns)
            want = active & ls.valid & (cos_l > 0) & (f_l > 0).any(-1)
            so = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ng, ls.wi), ls.wi)
            s_tmax = torch.where(want, torch.clamp(ls.dist * 0.999, max=1e30), -1.0)
            occluded = isect_any(so, ls.wi, s_tmax)
            pdf_light = ls.pdf * sel_pmf
            if cfg.mis:
                w_l = torch.where(ls.is_delta, 1.0,
                                  sampling.power_heuristic(1.0, pdf_light, 1.0, pdf_b))
            else:
                w_l = torch.ones(R, **f32)
            # every factor is masked before the product (masked lanes must
            # not form a possibly-inf product; same as the JAX package)
            take = want & ~occluded
            w_over = torch.where(take, cos_l * w_l / torch.clamp(pdf_light, min=1e-20), 0.0)
            f_l_m = torch.where(take[..., None], f_l, 0.0)
            li_m = torch.where(take[..., None], ls.li, 0.0)
            L = L + beta * f_l_m * w_over[..., None] * li_m

        # BSDF sampling -> next segment
        uc = samplers.get_1d(sampler_cfg, pix, sidx, base + 0)
        ubu, ubv = samplers.get_2d(sampler_cfg, pix, sidx, base + 1)
        bs = bxdf.sample(ctx, wo_local, uc, torch.stack([ubu, ubv], -1))
        wi_world = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_world, sp.ns)
        inv_pdf_b = torch.where(bs.valid, 1.0 / torch.clamp(bs.pdf, min=1e-20), 0.0)
        beta_new = beta * bs.f * (cos_b * inv_pdf_b)[..., None]
        active = active & bs.valid & (beta_new > 0).any(-1)
        beta = torch.where(active[..., None], beta_new, beta)
        specular_prev = torch.where(active, bs.specular, specular_prev)
        prev_pdf = torch.where(active, bs.pdf, prev_pdf)
        prev_p = torch.where(active[..., None], sp.p, prev_p)
        eta_scale = torch.where(active, eta_scale * bs.eta * bs.eta, eta_scale)
        ng_o = vm.face_forward(sp.ng, wi_world)
        o = torch.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_world), o)
        d = torch.where(active[..., None], wi_world, d)
        cone_w = torch.where(active, cone_at_hit, cone_w)
        cone_s = torch.where(active & ~bs.specular, torch.clamp(cone_s, min=0.25), cone_s)

        # Russian roulette on beta * eta_scale (Path only)
        if cfg.mis and depth >= cfg.rr_depth:
            u_rr = samplers.get_1d(sampler_cfg, pix, sidx, base + 6)
            q = torch.clamp(1.0 - beta.amax(-1) * eta_scale, min=0.0)
            active = active & ~(active & (u_rr < q))
            beta = torch.where(active[..., None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)

        return (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
                cone_w, cone_s, pix, lam, perm)

    perm0 = torch.arange(R, dtype=torch.int64, device=device)
    state = (o, d, L, beta, active, specular_prev, prev_pdf, o, eta_scale,
             cone_w, cone_s, pixel_idx, lam, perm0)
    for depth in range(cfg.max_depth):
        if not bool(state[4].any()):
            break
        state = bounce(depth, state)
    (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, _, _, _, _,
     lam_f, perm) = state
    # trailing emission-only segment (the depth == max_depth break)
    if bool(active.any()):
        L, _, _, _ = add_emission(o, d, L, beta, active, specular_prev, prev_pdf,
                                  prev_p, lam_f)
    L_out = torch.zeros_like(L)
    L_out[perm] = L  # back to the caller's lane order
    return L_out, lam, lam_pdf, film_w


def make_wave_fn(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig,
                 isect=None, device=None):
    """Build the 1-spp wave function film, sample_idx -> film. Host-side
    tables (light sampler, BVH4 packing) are built here and uploaded once.
    `isect` overrides the traversal backend (tests / comparisons)."""
    _check_cfg(cfg)
    if isect is not None and device is None:
        device = isect.device
    device = resolve_device(device, scene)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    pixel_idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=device)

    def wave(film: film_mod.Film, sample_idx) -> film_mod.Film:
        L, lam, lam_pdf, fw = trace_wave(scene_d, None, cam, sampler_cfg, cfg,
                                         pixel_idx, sample_idx, ls_tables, isect)
        return film_mod.add_samples(film, pixel_idx, L, lam, lam_pdf,
                                    filter_weight=fw, sequential=True)

    return wave


def render(scene, dbvh, cam, spp: int = 16, sampler: str = "sobol", seed: int = 0,
           cfg: IntegratorConfig = IntegratorConfig(), wave_callback=None,
           sensor=None, device=None) -> torch.Tensor:
    """Progressive render, one 1-spp wave per sample -> (H,W,3) linear sRGB."""
    device = resolve_device(device, scene)
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp, width=cam.width)
    film = film_mod.make_film(cam.height, cam.width, device)
    wave = make_wave_fn(scene, dbvh, cam, sampler_cfg, cfg, device=device)
    for s in range(spp):
        film = wave(film, s)
        if wave_callback is not None:
            wave_callback(s, film)
    return film_mod.develop(film, sensor=sensor)
