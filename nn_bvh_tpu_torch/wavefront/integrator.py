"""Wavefront integrators of one 1-spp wave (port of
nn_bvh_tpu/wavefront/integrator.py): Path (`kind="path"`, mis=False gives
SimplePath), RandomWalk (`kind="randomwalk"`), ambient occlusion
(`kind="ao"`, `trace_ao`), the per-pixel stats counters
(`collect_stats`, `render_pixel_stats`) and the dispatch of `make_wave_fn`
/ `render` to them or to VolPath (`kind="volpath" | "simplevolpath"`,
wavefront/volpath.py). LightPath, BDPT, SPPM and MLT have their own
modules and render functions.

One 1-spp wave traces one path per pixel as a dense batch of lanes; every
stage (camera rays, intersect, emission, material, shadow rays, BSDF
sampling, Russian roulette, film) is a batched torch op. Semantics are the
JAX package's: power-heuristic MIS between light and BSDF sampling
(mis=False gives SimplePath), Russian roulette after `rr_depth`, the same
sampler-dimension schedule, so the same seed draws the same numbers.
`sample_lights=False` drops next-event estimation and weighs every hit
emitter 1 (RandomWalk and AO, as the JAX CLI sets them); `filt` (a
filters.FilterConfig) importance-samples the in-pixel position and hands
the film its weight.

Differences of form, not of result:
- the JAX while-loop early exit is a Python loop that checks `active.any()`
  once per bounce and skips the trailing emission segment when every lane
  is dead (it would add nothing);
- lanes that cannot receive escaped radiance (a scene with no uniform
  infinite light and no env map) skip that block, and Russian roulette is
  skipped below `rr_depth` (where it keeps every lane and divides beta by 1);
- light-sampling branches are computed only for the light tags the scene
  holds (lights.light_types, read once a wave);
- on every CUDA traversal backend the lane state is re-sorted once per
  bounce (dead, octant, Morton) before the traversals; the state carries
  each lane's pixel and sample index (MLT hands every lane its own), and
  `perm` scatters the radiance back to the caller's lane order, so no
  pixel value depends on the sort.

Motion blur, as in the JAX package: a moving camera draws a shutter time
per lane (one sampler dimension, DIM_PATH_BASE, which moves the bounce
dimensions up by one); a scene with moving geometry is rendered one
stratified shutter time per wave (make_wave_fn lerps the vertex tables and
rebuilds the traversal's triangle table, `dispatch.Intersectors.
set_triangles`).

Entry points run on the CUDA card unless the caller asks for the CPU
(`devices.resolve_device`). Traversal runs under no_grad: gradients reach shading only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..geometry import scene as scene_mod, texture
from ..scatter import bxdf, lights, lightsamplers
from ..accel import dispatch
from ..accel.traverse import Hit
from ..devices import resolve_device
from . import camera as camera_mod, film as film_mod, filters

# sampler dimension layout per pixel sample (the JAX package's schedule)
DIM_PIXEL = 0       # 2 dims
DIM_WAVELENGTH = 2  # 1 dim
DIM_LENS = 3        # 2 dims
DIM_PATH_BASE = 5
DIMS_PER_DEPTH = 7  # [bsdf_uc, bsdf_u, bsdf_v, light_select, light_u, light_v, rr]


VOL_KINDS = ("volpath", "simplevolpath")
WAVE_KINDS = ("path", "randomwalk", "ao") + VOL_KINDS
# integrators with a render function of their own, not a wave kind
RENDERERS = {"lightpath": "lightpath.render_lightpath", "bdpt": "bdpt.render_bdpt",
             "sppm": "sppm.render_sppm", "mlt": "mlt.render_mlt",
             "function": "lightpath.render_function"}
STAT_NAMES = ("bounces", "shadow_rays", "hits", "rr_terms")


class IntegratorConfig(NamedTuple):
    max_depth: int = 5
    mis: bool = True              # False = SimplePath semantics
    rr_depth: int = 1             # Russian roulette from this depth on
    light_sampler: str = "power"  # uniform | power | bvh | exhaustive
    kind: str = "path"            # path | randomwalk | ao | volpath | simplevolpath
    max_null_steps: int = 64      # cap on medium events per VolPath segment
    max_shadow_segments: int = 4  # VolPath shadow-ray re-spawns across interfaces
    compact: bool = True          # VolPath on a CUDA backend: the phased wave
    #   (volpath.make_phased_wave), when early_exit is set too
    resort: bool = True           # VolPath on CUDA backends: re-sort the lane
    #   state each bounce and trace unsorted; False traces through the sorted
    #   intersector. Path always re-sorts and refuses False.
    early_exit: bool = True       # the JAX name, for config parity. Every loop
    #   of the port exits once every lane is dead, whatever its value; it only
    #   takes part in the dispatch rule, where False selects the whole-wave
    #   trace as compact=False does. JAX's fixed-depth scan for jax.grad has
    #   no counterpart here.
    sample_lights: bool = True    # next-event estimation (False: RandomWalk, AO)
    ao_max_dist: float = 1e30     # AO's occlusion distance
    filt: object = None           # filters.FilterConfig; None = box(0.5) jitter, weight 1
    collect_stats: bool = False   # trace_wave / trace_wave_vol return an extra
    #   (R, 4) float32 of per-lane counters [bounces, shadow rays, hits, RR
    #   terminations] (STAT_NAMES)


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
    if scene.n_quadrics:
        # analytic quadric hits (prim ids above the padded triangle range):
        # exact position, normal and uv; mat/light/media came through the
        # appended tri_shade rows
        from ..geometry import quadrics

        quad_base = scene.tri_p.shape[0]
        prim = torch.clamp(hit.prim, min=0)
        is_q = prim >= quad_base
        qidx = torch.where(is_q, prim - quad_base, 0)
        pq, nq = quadrics.shading(scene.quad_type, scene.quad_params, qidx, o, d, hit.t,
                                  u=hit.b1, v=hit.b2)
        pq = torch.where(torch.isfinite(pq), pq, 0.0)
        isq1 = is_q[..., None]
        p = torch.where(isq1, pq, p)
        ng = torch.where(isq1, nq, ng)
        ns = torch.where(isq1, nq, ns)
        uv = torch.where(isq1, torch.stack([hit.b1, hit.b2], -1), uv)
        uv_scale = torch.where(is_q, scene.quad_uv_scale[qidx.long()], uv_scale)
    return ShadingPoint(p=p, ng=ng, ns=ns, uv=uv, mat=rec[..., 24].to(torch.int32),
                        prim=hit.prim, light=rec[..., 25].to(torch.int32),
                        v0=v0, v1=v1, v2=v2, uv_scale=uv_scale, t=t_fin)


def _check_cfg(cfg: IntegratorConfig):
    if cfg.kind in RENDERERS:
        # the JAX package's make_wave_fn traces Path for such a kind; the
        # port refuses and names the integrator's own entry point
        raise ValueError(f"{cfg.kind!r} is not a wave kind: render it with "
                         f"wavefront.{RENDERERS[cfg.kind]}")
    if cfg.kind not in WAVE_KINDS:
        raise ValueError(f"unknown integrator kind {cfg.kind!r} (wave kinds: "
                         f"{', '.join(WAVE_KINDS)})")
    if cfg.kind not in VOL_KINDS and not cfg.resort:
        raise NotImplementedError("the Path wave re-sorts its lanes on every CUDA "
                                  "backend; resort=False is VolPath's switch only")


class NoGradIntersectors:
    """Closest-hit and any-hit of `isect` on detached rays under no_grad.
    Traversal sits outside every differentiated path, as in the JAX
    package (which stops gradients there and gives no TPU kernel a backward
    pass): the kernels need no torch.autograd.Function, the hits carry no
    graph."""

    def __init__(self, isect):
        self.isect = isect

    def closest(self, o, d, t_max):
        with torch.no_grad():
            return self.isect.closest(o.detach(), d.detach(), t_max.detach())

    def any_hit(self, o, d, t_max):
        with torch.no_grad():
            return self.isect.any_hit(o.detach(), d.detach(), t_max.detach())


def count(st, col: int, mask):
    """The stats counters st (R, 4) with mask (R,) added to column col."""
    add = torch.zeros_like(st)
    add[:, col] = mask.to(st.dtype)
    return st + add


def filter_jitter(cfg: IntegratorConfig, u2):
    """The in-pixel position of a camera ray and its film weight: u2 and 1
    without a filter, else the filter's importance sample (0.5 + offset,
    f / pdf)."""
    if cfg.filt is None:
        return u2, torch.ones(u2.shape[:-1], dtype=torch.float32, device=u2.device)
    off, w = filters.sample(cfg.filt, u2)
    return 0.5 + off, w


def trace_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, pixel_idx,
               sample_idx, ls_tables=None, isect=None):
    """Trace one path per entry of pixel_idx -> (L, lam, lam_pdf, film_w),
    and the (R, 4) stats counters after them when cfg.collect_stats.
    `sample_idx` is one sample index for the wave or one per lane. `scene`
    holds tensors on pixel_idx's device (geometry.scene.to_device).
    VolPath is volpath.trace_wave_vol, AO trace_ao."""
    _check_cfg(cfg)
    if cfg.kind not in ("path", "randomwalk"):
        raise ValueError(f"trace_wave traces Path and RandomWalk, not {cfg.kind!r}")
    device = pixel_idx.device
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device)
    do_resort = isect.backend in dispatch.CUDA_BACKENDS
    sort_blo = scene.bounds[0]
    sort_bext = torch.clamp(scene.bounds[1] - sort_blo, min=1e-9)

    ng = NoGradIntersectors(isect)
    isect_closest, isect_any = ng.closest, ng.any_hit

    R = pixel_idx.shape[0]
    sidx0 = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    f32 = dict(dtype=torch.float32, device=device)

    # camera rays and wavelengths; a moving camera draws a shutter time
    # (a dimension consumed only then, so static scenes keep their streams)
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx0, DIM_PIXEL)
    u_pix, film_w = filter_jitter(cfg, torch.stack([upx, upy], -1))
    ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx0, DIM_LENS)
    animated_cam = cam.motion_keys is not None
    u_time = (samplers.get_1d(sampler_cfg, pixel_idx, sidx0, DIM_PATH_BASE)
              if animated_cam else None)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix, torch.stack([ulx, uly], -1),
                                    u_time=u_time)
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx0, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)

    S = spectrum.N_SPECTRUM_SAMPLES
    L = torch.zeros(R, S, **f32)
    beta = torch.ones(R, S, **f32)
    active = torch.ones(R, dtype=torch.bool, device=device)
    specular_prev = torch.ones(R, dtype=torch.bool, device=device)
    prev_pdf = torch.ones(R, **f32)
    eta_scale = torch.ones(R, **f32)
    # ray-cone state (the texture LOD of gather_material)
    cone_w = torch.zeros(R, **f32)
    cone_s = torch.full((R,), texture.camera_spread(cam.fov, cam.height), **f32)
    # per-lane stats counters [bounces, shadow rays, hits, RR terminations]
    st = torch.zeros(R, 4, **f32) if cfg.collect_stats else None
    nee = cfg.sample_lights
    # MIS weights of hit emitters: the power heuristic against light
    # sampling, 1 after a specular bounce; without MIS 0 there, and 1
    # everywhere when no light is sampled
    mis_on = cfg.mis and nee

    n_lights = scene.n_lights
    mat_all = bxdf.material_records(scene)
    kinds = bxdf.scene_kinds(scene)
    if n_lights > 0:
        light_all = lights.light_records(scene)
        types = lights.light_types(scene)
        tags = frozenset(types)
        has_env = lights.has_env_map(scene)
        has_escape = scene_mod.LIGHT_UNIFORM_INFINITE in tags or has_env
        sel_pmf_of = lambda tag: torch.where(scene.light_type == tag, ls_tables.pmf, 0.0).sum()
        inf_sel_pmf = sel_pmf_of(scene_mod.LIGHT_UNIFORM_INFINITE)
        env_sel_pmf = sel_pmf_of(scene_mod.LIGHT_IMAGE_INFINITE)
        portal_sel_pmf = sel_pmf_of(scene_mod.LIGHT_PORTAL_ENV)
        portal_ids = lights.portal_ids(types)

    def escape_pdf(prev_p, d):
        """The light-sampling pdf of an escaped ray's direction: uniform
        infinite, env map and portal strategies."""
        pdf_l = sampling.UNIFORM_SPHERE_PDF * inf_sel_pmf
        if has_env:
            pdf_l = pdf_l + env_sel_pmf * lights.env_pdf_dir(scene, d)
        if portal_ids:
            pdf_l = pdf_l + portal_sel_pmf * lights.portal_pdf_dir(scene, light_all, prev_p, d,
                                                                   portal_ids)
        return pdf_l.expand(d.shape[0])

    def no_mis_weight(specular_prev):
        return torch.where(specular_prev, 1.0, 0.0) if nee else \
            torch.ones(specular_prev.shape, **f32)

    def add_emission(o, d, L, beta, active, specular_prev, prev_pdf, prev_p, lam):
        """Intersect + escaped-ray + emissive-hit contributions."""
        hit = isect_closest(o, d, torch.where(active, 1e30, -1.0))
        found = active & (hit.prim >= 0)
        if n_lights > 0 and has_escape:
            escaped = active & (hit.prim < 0)
            le_inf = lights.infinite_le(scene, d, lam)
            if mis_on:
                pdf_l = escape_pdf(prev_p, d)
                w_mis = torch.where(specular_prev, 1.0,
                                    sampling.power_heuristic(1.0, prev_pdf, 1.0, pdf_l))
            else:
                w_mis = no_mis_weight(specular_prev)
            L = L + torch.where(escaped[..., None], beta * le_inf * w_mis[..., None], 0.0)

        sp = _shading_point(scene, hit, o, d)
        wo = -d
        if n_lights > 0:
            lrec = light_all[torch.clamp(sp.light, min=0).long()]
            has_light = found & (sp.light >= 0)
            le = lights.area_light_l_rec(lrec, has_light, sp.ng, wo, lam)
            if mis_on:
                pdf_shape = lights.area_pdf_li_from_verts(sp.v0, sp.v1, sp.v2, prev_p)
                is_sph = lrec[..., 0].to(torch.int32) == scene_mod.LIGHT_SPHERE_AREA
                pdf_shape = torch.where(
                    is_sph, lights.sphere_pdf_li(lrec, prev_p, sp.p, sp.ng), pdf_shape)
                pdf_l = pdf_shape * lightsamplers.pmf_ctx(ls_tables, prev_p, sp.light)
                w_mis = torch.where(specular_prev, 1.0,
                                    sampling.power_heuristic(1.0, prev_pdf, 1.0, pdf_l))
            else:
                w_mis = no_mis_weight(specular_prev)
            L = L + torch.where(found[..., None], beta * le * w_mis[..., None], 0.0)
        return L, found, sp, wo

    def bounce(depth: int, state):
        if do_resort:
            key = dispatch.ray_sort_key(state[0], state[1], sort_blo, sort_bext,
                                        torch.where(state[4], 1.0, -1.0))
            order = torch.argsort(key, stable=True)
            state = tuple(None if a is None else a[order] for a in state)
        (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
         cone_w, cone_s, pix, sidx, lam, perm, st) = state
        base = DIM_PATH_BASE + (1 if animated_cam else 0) + depth * DIMS_PER_DEPTH

        L, found, sp, wo = add_emission(o, d, L, beta, active, specular_prev,
                                        prev_pdf, prev_p, lam)
        if st is not None:
            st = count(count(st, 0, active), 2, found)
        active = found
        cone_at_hit = cone_w + sp.t * cone_s
        foot = texture.cone_foot_log2(cone_at_hit, vm.absdot(d, sp.ns), sp.uv_scale)
        u_mix = (rng.hash_float(pix, sidx, depth, 0x77) if bxdf.has_mix(scene) else None)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv, u_mix,
                                   foot_log2=foot, kinds=kinds)
        active = active & (sp.mat >= 0)
        wo_local = vm.to_local(sp.ns, wo)
        if scene.feat_subsurface:
            # a subsurface lane mirrors at its interface or moves to a
            # sampled exit point (wavefront/subsurface.py)
            from . import subsurface

            sp, ctx, wo_local, beta, active = subsurface.transition(
                scene, isect_closest, _shading_point, sp, wo, wo_local, ctx, lam, beta,
                active, pix, sidx, depth)

        # direct lighting
        if nee and n_lights > 0:
            u_sel = samplers.get_1d(sampler_cfg, pix, sidx, base + 3)
            ulu, ulv = samplers.get_2d(sampler_cfg, pix, sidx, base + 4)
            light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, sp.p, u_sel)
            ls = lights.sample_li(scene, light_all, light_id, sp.p, lam,
                                  torch.stack([ulu, ulv], -1), tags)
            f_l, pdf_b = bxdf.evaluate(ctx, wo_local, vm.to_local(sp.ns, ls.wi))
            cos_l = vm.absdot(ls.wi, sp.ns)
            want = active & ls.valid & (cos_l > 0) & (f_l > 0).any(-1)
            so = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ng, ls.wi), ls.wi)
            s_tmax = torch.where(want, torch.clamp(ls.dist * 0.999, max=1e30), -1.0)
            occluded = isect_any(so, ls.wi, s_tmax)
            if st is not None:
                st = count(st, 1, want)
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
        ubu, ubv = samplers.get_2d(sampler_cfg, pix, sidx, base + 1)
        if cfg.kind == "randomwalk":
            # RandomWalk: a uniform-sphere direction, f evaluated, pdf 1/4pi
            wi_rw = sampling.sample_uniform_sphere(torch.stack([ubu, ubv], -1))
            f_rw, _ = bxdf.evaluate(ctx, wo_local, wi_rw)
            false = torch.zeros(R, dtype=torch.bool, device=device)
            bs = bxdf.BSDFSample(wi=wi_rw, f=f_rw,
                                 pdf=torch.full((R,), sampling.UNIFORM_SPHERE_PDF, **f32),
                                 specular=false, transmission=false, eta=torch.ones(R, **f32),
                                 valid=(f_rw > 0).any(-1))
        else:
            uc = samplers.get_1d(sampler_cfg, pix, sidx, base + 0)
            bs = bxdf.sample(ctx, wo_local, uc, torch.stack([ubu, ubv], -1))
        wi_world = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_world, sp.ns)
        # double-where: an invalid lane's pdf (0, clamped) must not reach the
        # reciprocal, whose gradient there is 0 * inf = NaN once the pdf
        # depends on a material coefficient (hair's does)
        inv_pdf_b = torch.where(bs.valid,
                                1.0 / torch.clamp(torch.where(bs.valid, bs.pdf, 1.0), min=1e-20),
                                0.0)
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
            die = active & (u_rr < q)
            if st is not None:
                st = count(st, 3, die)
            active = active & ~die
            beta = torch.where(active[..., None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)

        return (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
                cone_w, cone_s, pix, sidx, lam, perm, st)

    perm0 = torch.arange(R, dtype=torch.int64, device=device)
    state = (o, d, L, beta, active, specular_prev, prev_pdf, o, eta_scale,
             cone_w, cone_s, pixel_idx, sidx0, lam, perm0, st)
    for depth in range(cfg.max_depth):
        if not bool(state[4].any()):
            break
        state = bounce(depth, state)
    (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, _, _, _, _, _,
     lam_f, perm, st) = state
    # trailing emission-only segment (the depth == max_depth break)
    if bool(active.any()):
        L, _, _, _ = add_emission(o, d, L, beta, active, specular_prev, prev_pdf,
                                  prev_p, lam_f)
    L_out = torch.zeros_like(L)
    L_out[perm] = L  # back to the caller's lane order
    if st is None:
        return L_out, lam, lam_pdf, film_w
    st_out = torch.zeros_like(st)
    st_out[perm] = st
    return L_out, lam, lam_pdf, film_w, st_out


def trace_ao(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, pixel_idx, sample_idx,
             isect=None):
    """Ambient occlusion (AOIntegrator): a cosine-sampled visibility ray
    within cfg.ao_max_dist from the first hit -> (L, lam, lam_pdf, film_w),
    L a flat unit spectrum where the ray escapes, 0 where it is occluded or
    the camera ray misses."""
    device = pixel_idx.device
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device)
    R = pixel_idx.shape[0]
    sidx = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PIXEL)
    u_pix, film_w = filter_jitter(cfg, torch.stack([upx, upy], -1))
    ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_LENS)
    animated_cam = cam.motion_keys is not None
    u_time = (samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_PATH_BASE)
              if animated_cam else None)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix, torch.stack([ulx, uly], -1),
                                    u_time=u_time)
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)
    ng = NoGradIntersectors(isect)
    hit = ng.closest(o, d, torch.full((R,), 1e30, dtype=torch.float32, device=device))
    found = hit.prim >= 0
    sp = _shading_point(scene, hit, o, d)
    ns = vm.face_forward(sp.ns, -d)
    u1, u2 = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PATH_BASE)
    wi = vm.from_local(ns, sampling.sample_cosine_hemisphere(torch.stack([u1, u2], -1)))
    so = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ng, wi), wi)
    occ = ng.any_hit(so, wi, torch.where(found, cfg.ao_max_dist, -1.0))
    vis = found & ~occ
    L = torch.where(vis[..., None], 1.0,
                    torch.zeros(R, spectrum.N_SPECTRUM_SAMPLES, dtype=torch.float32,
                                device=device))
    return L, lam, lam_pdf, film_w


def render_pixel_stats(scene, dbvh, cam, spp: int = 4, sampler: str = "sobol", seed: int = 0,
                       cfg: IntegratorConfig = IntegratorConfig(), device=None):
    """Per-pixel statistics images (--pixelstats): {"bounces",
    "shadow_rays", "hits", "rr_terms"} as (H, W) float32 numpy arrays
    averaged over spp, and {"stats/<name>": total} over all spp. As in the
    JAX package the counters come from the Path wave (RandomWalk's for
    kind="randomwalk") whatever the configured kind."""
    device = resolve_device(device, scene)
    cfg = cfg._replace(collect_stats=True,
                       kind="randomwalk" if cfg.kind == "randomwalk" else "path", resort=True)
    sampler_cfg = samplers.to_device(
        samplers.make_sampler(sampler, seed=seed, spp=spp, width=cam.width), device)
    cfg = cfg._replace(filt=filters.to_device(cfg.filt, device))
    R = cam.width * cam.height
    pixel_idx = torch.arange(R, dtype=torch.int32, device=device)
    ls = lightsamplers.build(scene, cfg.light_sampler, device)
    isect = dispatch.make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    acc = torch.zeros(R, 4, dtype=torch.float32, device=device)
    for s in range(spp):
        acc = acc + trace_wave(scene_d, None, cam, sampler_cfg, cfg, pixel_idx, s, ls, isect)[4]
    a = (acc / spp).cpu().numpy()
    imgs = {n: a[:, i].reshape(cam.height, cam.width) for i, n in enumerate(STAT_NAMES)}
    totals = {f"stats/{n}": float(a[:, i].sum() * spp) for i, n in enumerate(STAT_NAMES)}
    return imgs, totals


def make_wave_fn(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig,
                 isect=None, device=None):
    """Build the 1-spp wave function film, sample_idx -> film. Host-side
    tables (light sampler, BVH4 packing) are built here and uploaded once.
    `isect` overrides the traversal backend (tests / comparisons).

    VolPath takes the phased wave (volpath.make_phased_wave) when
    cfg.compact and cfg.early_exit are set, the traversal is a CUDA
    backend and the scene's geometry does not move, the JAX package's
    rule; otherwise (the CPU's plain traversal among them) it traces the
    whole wave (volpath.trace_wave_vol). A scene with moving geometry
    renders each wave at one stratified shutter time (scene_at_shutter)."""
    from . import volpath

    _check_cfg(cfg)
    if isect is not None and device is None:
        device = isect.device
    device = resolve_device(device, scene)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device, sort=not cfg.resort)
    animated = scene.tri_p_end is not None
    sampler_cfg = samplers.to_device(sampler_cfg, device)
    cfg = cfg._replace(filt=filters.to_device(cfg.filt, device))
    if (cfg.kind in VOL_KINDS and cfg.compact and cfg.early_exit
            and isect.backend in dispatch.CUDA_BACKENDS and not animated):
        return volpath.make_phased_wave(scene, dbvh, cam, sampler_cfg, cfg, isect=isect,
                                        device=device)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    scene_d = scene_mod.to_device(scene, device)
    pixel_idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=device)

    def trace(sc, sample_idx):
        if cfg.kind == "ao":
            return trace_ao(sc, None, cam, sampler_cfg, cfg, pixel_idx, sample_idx, isect)
        tw = volpath.trace_wave_vol if cfg.kind in VOL_KINDS else trace_wave
        return tw(sc, None, cam, sampler_cfg, cfg, pixel_idx, sample_idx, ls_tables,
                  isect)[:4]

    def wave(film: film_mod.Film, sample_idx) -> film_mod.Film:
        sc = scene_d
        if animated:
            sc = scene_at_shutter(scene_d, sample_idx, sampler_cfg.spp)
            isect.set_triangles(sc.tri_p)
        L, lam, lam_pdf, fw = trace(sc, sample_idx)
        return film_mod.add_samples(film, pixel_idx, L, lam, lam_pdf,
                                    filter_weight=fw, sequential=True)

    return wave


def shutter_time(sample_idx, spp: int, device) -> torch.Tensor:
    """A wave's shutter time in [0, 1), a 0-d float32 tensor: the wave's
    stratum of spp, jittered by hash(0, sample_idx, 0x51)."""
    s = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).reshape(1)
    u = rng.hash_float(torch.zeros(1, dtype=torch.int32, device=device), s, 0x51)[0]
    return (s[0].to(torch.float32) + u) / spp


def scene_at_shutter(scene, sample_idx, spp: int):
    """A moving scene's tables (tensors) at the wave's shutter time: the
    vertices, normals and shading records lerped as a + t (b - a), exact
    where b == a."""
    t = shutter_time(sample_idx, spp, scene.tri_p.device)
    lerp = lambda a, b: a + t * (b - a)
    return scene.replace(tri_p=lerp(scene.tri_p, scene.tri_p_end),
                         tri_n=lerp(scene.tri_n, scene.tri_n_end),
                         tri_shade=lerp(scene.tri_shade, scene.tri_shade_end))


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
