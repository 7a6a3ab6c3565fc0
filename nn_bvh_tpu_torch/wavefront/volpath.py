"""Volumetric wavefront path tracing, VolPath (port of
nn_bvh_tpu/wavefront/volpath.py).

The null-scattering path integral with rescaled path probabilities (beta,
r_u, r_l, all spectral (R, 4)) and ratio-tracking shadow transmittance,
term by term as the JAX package writes it:

  null event:    beta *= T_maj sigma_n / pdf, r_u *= T_maj sigma_n / pdf,
                 r_l *= T_maj sigma_maj / pdf,  pdf = T_maj[0] sigma_n[0]
  real scatter:  beta *= T_maj sigma_s / pdf', r_u *= same,
                 pdf' = T_maj[0] sigma_s[0]
  emission:      L += beta T_maj/pdf * sigma_a Le / avg(r_u sigma_maj T_maj/pdf)
  escape/hit Le: L += beta Le / avg(r_u + r_l * p_light)
  NEE:           L += beta f_hat T_ray Li / avg(r_l' + r_u')   (balance MIS)

Each stage is a function of this module over a `VolCtx` (the scene tables
and configuration of one wave) and per-lane tensors: `init_state`,
`medium_events`, `shadow_transmit`, `sample_ld`, `add_emission`, `bounce`.
The JAX while-loops and conds become Python loops over the whole batch with
per-lane masks; a loop stops once no lane is live. A lane that is not live
keeps its state through a step, so no result depends on where a loop stops.
The medium-event loop stops at `max_null_steps` steps exactly as the JAX
loop does, and lanes still running there are treated as absorbed.

Random numbers are counter-based hashes of (pixel, sample, seed, depth,
loop counters, salt) (`_rand`, bit-identical to the JAX package's), so the
lane order never changes a value: on a CUDA backend the lane state is
re-sorted once a bounce (dead, octant, Morton), and `make_phased_wave` cuts
the state to a shrinking ladder of lane counts as lanes die.

Two faults of the JAX package's VolPath are mirrored, so that images
match: it draws no shutter time for a moving camera (`init_state` calls
generate_rays without u_time, so the camera renders at shutter open), and
an escaped ray's light-sampling pdf leaves out the portal strategy
(`add_emission` adds the uniform-infinite and env-map terms only).

Traversal runs under no_grad and on detached rays: gradients reach shading
only, as in the JAX package (which stops gradients there). No TPU kernel has
a backward pass (`custom_vjp` appears only in the split learner), so the
traversal kernels need no `torch.autograd.Function`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel import dispatch
from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..devices import resolve_device
from ..geometry import scene as scene_mod, texture
from ..scatter import bxdf, lights, lightsamplers, media
from . import camera as camera_mod, film as film_mod
from .integrator import (DIM_PIXEL, DIM_WAVELENGTH, DIM_LENS, DIM_PATH_BASE,
                         DIMS_PER_DEPTH, IntegratorConfig, _shading_point, count,
                         filter_jitter)

S = spectrum.N_SPECTRUM_SAMPLES


def _avg(x):
    return x.mean(-1)


def _any_pos(x):
    return (x > 0).any(-1)


class VolState(NamedTuple):
    """Per-lane state of one VolPath wave (the JAX package's carry tuple)."""

    o: torch.Tensor              # (R, 3)
    d: torch.Tensor              # (R, 3)
    L: torch.Tensor              # (R, 4) radiance
    beta: torch.Tensor           # (R, 4) throughput
    r_u: torch.Tensor            # (R, 4) rescaled unidirectional probability
    r_l: torch.Tensor            # (R, 4) rescaled light-sampling probability
    active: torch.Tensor         # (R,) bool
    specular_prev: torch.Tensor  # (R,) bool
    prev_p: torch.Tensor         # (R, 3) last scattering vertex
    cur_med: torch.Tensor        # (R,) i32 medium the ray travels in
    eta_scale: torch.Tensor      # (R,)
    cone_w: torch.Tensor         # (R,) ray-cone width
    cone_s: torch.Tensor         # (R,) ray-cone spread
    pixel_idx: torch.Tensor      # (R,) i32
    lam: torch.Tensor            # (R, 4) wavelengths
    perm: torch.Tensor           # (R,) i64 caller lane of each lane
    sidx: torch.Tensor           # (R,) i32 sample index
    film_w: torch.Tensor         # (R,) filter weight
    lam_pdf: torch.Tensor        # (R, 4)
    st: torch.Tensor | None      # (R, 4) stats counters (cfg.collect_stats), else None


def _take(state: VolState, idx) -> VolState:
    """The lanes idx (an index tensor or a slice) of every field."""
    return VolState(*(None if a is None else a[idx] for a in state))


class VolCtx(NamedTuple):
    """What every stage of one wave reads: the device scene, its fused
    tables, the light sampler, the intersectors and the configuration."""

    scene: object
    cam: camera_mod.Camera
    sampler_cfg: samplers.SamplerConfig
    cfg: IntegratorConfig
    ls_tables: lightsamplers.LightSamplerTables
    isect: dispatch.Intersectors
    mat_all: torch.Tensor
    kinds: frozenset                  # the scene's material tags (bxdf.scene_kinds)
    med_all: torch.Tensor | None
    light_all: torch.Tensor | None
    light_tags: frozenset             # the scene's light tags (lights.scene_tags)
    inf_sel_pmf: torch.Tensor | None  # selection pmf of the uniform infinite lights
    env_sel_pmf: torch.Tensor | None  # selection pmf of the env-map lights
    has_escape: bool                  # a uniform infinite light or an env map
    do_resort: bool
    sort_blo: torch.Tensor
    sort_bext: torch.Tensor


def make_context(scene, cam, sampler_cfg, cfg: IntegratorConfig, ls_tables,
                 isect: dispatch.Intersectors) -> VolCtx:
    """The VolCtx of a scene of tensors (geometry.scene.to_device); the
    light sampler tables are built when ls_tables is None."""
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, scene.tri_p.device)
    light_all = inf_sel_pmf = env_sel_pmf = None
    tags = frozenset()
    has_escape = False
    if scene.n_lights > 0:
        light_all = lights.light_records(scene)
        tags = lights.scene_tags(scene)
        has_escape = scene_mod.LIGHT_UNIFORM_INFINITE in tags or lights.has_env_map(scene)
        sel_pmf_of = lambda tag: torch.where(scene.light_type == tag, ls_tables.pmf, 0.0).sum()
        inf_sel_pmf = sel_pmf_of(scene_mod.LIGHT_UNIFORM_INFINITE)
        env_sel_pmf = sel_pmf_of(scene_mod.LIGHT_IMAGE_INFINITE)
    blo = scene.bounds[0]
    return VolCtx(
        scene=scene, cam=cam, sampler_cfg=sampler_cfg, cfg=cfg, ls_tables=ls_tables,
        isect=isect, mat_all=bxdf.material_records(scene), kinds=bxdf.scene_kinds(scene),
        med_all=media.medium_records(scene) if scene.n_media > 0 else None,
        light_all=light_all, light_tags=tags, inf_sel_pmf=inf_sel_pmf,
        env_sel_pmf=env_sel_pmf, has_escape=has_escape,
        do_resort=cfg.resort and isect.backend in dispatch.CUDA_BACKENDS,
        sort_blo=blo, sort_bext=torch.clamp(scene.bounds[1] - blo, min=1e-9))


def _rand(ctx: VolCtx, pixel_idx, sidx, *salts) -> torch.Tensor:
    """Counter-based uniform per lane, keyed on (pixel, sample, seed,
    salts...) exactly as the JAX package keys it; pixel and sample ride with
    the lane state because it is re-sorted and cut."""
    return rng.hash_float(pixel_idx, sidx, ctx.sampler_cfg.seed, *salts)


def _closest(ctx: VolCtx, o, d, t_max):
    # traversal sits outside every differentiated path (see the module doc)
    with torch.no_grad():
        return ctx.isect.closest(o.detach(), d.detach(), t_max.detach())


def init_state(ctx: VolCtx, pixel_idx, sample_idx) -> VolState:
    """Camera rays, wavelengths and every per-lane carry."""
    scfg, cam = ctx.sampler_cfg, ctx.cam
    R = pixel_idx.shape[0]
    device = pixel_idx.device
    f32 = dict(dtype=torch.float32, device=device)
    sidx = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    upx, upy = samplers.get_2d(scfg, pixel_idx, sidx, DIM_PIXEL)
    u_pix, film_w = filter_jitter(ctx.cfg, torch.stack([upx, upy], -1))
    ulx, uly = samplers.get_2d(scfg, pixel_idx, sidx, DIM_LENS)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix, torch.stack([ulx, uly], -1))
    ul = samplers.get_1d(scfg, pixel_idx, sidx, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)
    ones = torch.ones(R, S, **f32)
    true = torch.ones(R, dtype=torch.bool, device=device)
    return VolState(
        o=o, d=d, L=torch.zeros(R, S, **f32), beta=ones, r_u=ones, r_l=ones,
        active=true, specular_prev=true, prev_p=o,
        cur_med=torch.full((R,), ctx.scene.camera_medium, dtype=torch.int32, device=device),
        eta_scale=torch.ones(R, **f32), cone_w=torch.zeros(R, **f32),
        cone_s=torch.full((R,), texture.camera_spread(cam.fov, cam.height), **f32),
        pixel_idx=pixel_idx, lam=lam, perm=torch.arange(R, device=device), sidx=sidx,
        film_w=film_w, lam_pdf=lam_pdf,
        st=torch.zeros(R, 4, **f32) if ctx.cfg.collect_stats else None)


def medium_events(ctx: VolCtx, depth: int, o, d, t_hit, cur_med, beta, r_u, r_l, L, run0,
                  allow_scatter: bool, pixel_idx, sidx, lam):
    """Delta and ratio tracking along one segment [0, t_hit] through the
    lane's medium, over the majorant DDA: null events, real scattering,
    absorption and medium emission -> (scattered, terminated, p_scat, beta,
    r_u, r_l, L)."""
    scene, cfg = ctx.scene, ctx.cfg
    R = o.shape[0]
    rand = lambda *salts: _rand(ctx, pixel_idx, sidx, *salts)
    mctx = media.gather_medium(scene, cur_med, lam, ctx.med_all)
    t0, t1 = media.segment_bounds(mctx, o, d, torch.where(torch.isfinite(t_hit), t_hit, 1e30))
    # spectral majorant at unit majorant density: per segment sigma_unit *
    # dda.maj_dens (homogeneous lanes: max_density is in sigma_maj)
    is_grid = mctx.med_type == scene_mod.MED_GRID
    sigma_unit = torch.where(is_grid[..., None], mctx.sigma_a + mctx.sigma_s, mctx.sigma_maj)
    run0 = run0 & mctx.valid & (t1 > t0) & (mctx.sigma_maj[..., 0] > 1e-18)
    dda = media.dda_init(scene, mctx, o, d, t0, t1)

    zeros_b = torch.zeros(R, dtype=torch.bool, device=o.device)
    t, running, scattered, terminated, p_scat = t0, run0, zeros_b, zeros_b, o
    T_final = torch.ones(R, S, dtype=torch.float32, device=o.device)
    T_acc = T_final
    for step in range(cfg.max_null_steps):
        if not bool(running.any()):
            break
        run = running
        sigma_maj = sigma_unit * dda.maj_dens[..., None]
        maj0 = sigma_maj[..., 0]
        seg_end = torch.minimum(dda.seg_end, t1)
        u = rand(depth, step, 101)
        dt = torch.where(maj0 > 1e-18, -torch.log1p(-u) / maj0, 2e30)
        t_new = t + dt
        # an event inside this majorant segment, a crossing into the next
        # supervoxel (grid media), or the exit of the medium span
        crossed = run & (t_new >= seg_end) & (seg_end < t1)
        exited = run & (t_new >= seg_end) & ~crossed
        t_stop = torch.minimum(t_new, seg_end)
        T_step = torch.exp(-sigma_maj * (t_stop - t)[..., None])
        # transmittance since the last event: piecewise majorants multiply
        # across supervoxel crossings, an event resets it
        T_ev = T_acc * T_step
        p = o + t_new[..., None] * d
        dens = media.density(scene, mctx, p)
        sig_a = mctx.sigma_a * dens[..., None]
        sig_s = mctx.sigma_s * dens[..., None]
        ev = run & ~exited & ~crossed

        # emission at the event point
        pdf_e = torch.clamp(maj0 * T_ev[..., 0], min=1e-30)[..., None]
        betap = beta * T_ev / pdf_e
        r_e_avg = _avg(r_u * sigma_maj * T_ev / pdf_e)
        le_pt = media.le_at(scene, mctx, p, lam)
        emit_ok = ev & _any_pos(le_pt) & (r_e_avg > 0)
        L = L + torch.where(emit_ok[..., None],
                            betap * sig_a * le_pt / torch.clamp(r_e_avg, min=1e-30)[..., None],
                            0.0)

        # event type
        maj0_safe = torch.clamp(maj0, min=1e-30)
        p_absorb = sig_a[..., 0] / maj0_safe
        p_scatter = sig_s[..., 0] / maj0_safe
        um = rand(depth, step, 202)
        absorb = ev & (um < p_absorb)
        scat = ev & ~absorb & (um < p_absorb + p_scatter)
        null = ev & ~absorb & ~scat
        if not allow_scatter:
            # scatter events past the maximum depth terminate
            absorb = absorb | scat
            scat = zeros_b

        pdf_s = torch.clamp(T_ev[..., 0] * sig_s[..., 0], min=1e-30)
        f_s = T_ev * sig_s / pdf_s[..., None]
        sig_n = torch.clamp(sigma_maj - sig_a - sig_s, min=0.0)
        pdf_n = T_ev[..., 0] * sig_n[..., 0]
        pdf_n_safe = torch.clamp(pdf_n, min=1e-30)[..., None]
        f_n = torch.where((pdf_n > 0)[..., None], T_ev * sig_n / pdf_n_safe, 0.0)
        r_un = T_ev * sig_n / pdf_n_safe
        r_ln = T_ev * sigma_maj / pdf_n_safe

        sc, nu = scat[..., None], null[..., None]
        beta = torch.where(sc, beta * f_s, torch.where(nu, beta * f_n, beta))
        r_u = torch.where(sc, r_u * f_s, torch.where(nu, r_u * r_un, r_u))
        r_l = torch.where(nu, r_l * r_ln, r_l)

        dead_null = null & ~(_any_pos(beta) & _any_pos(r_u))
        T_final = torch.where(exited[..., None], T_ev, T_final)
        T_acc = torch.where(ev[..., None], 1.0, torch.where(crossed[..., None], T_ev, T_acc))
        dda = media.dda_advance(scene, mctx, dda, t1, crossed)
        t = torch.where(run, t_stop, t)
        running = run & ((null & ~dead_null) | crossed)
        scattered = scattered | scat
        terminated = terminated | absorb | dead_null
        p_scat = torch.where(scat[..., None], p, p_scat)

    # lanes still running at the step cap: absorbed (a bounded loss)
    terminated = terminated | running
    # residual segment factor T_maj / T_maj[0] of unscattered survivors
    no_event = (run0 & ~scattered & ~terminated)[..., None]
    tf0 = torch.clamp(T_final[..., 0:1], min=1e-30)
    beta = torch.where(no_event, beta * T_final / tf0, beta)
    r_u = torch.where(no_event, r_u * T_final / tf0, r_u)
    r_l = torch.where(no_event, r_l * T_final / tf0, r_l)
    return scattered, terminated, p_scat, beta, r_u, r_l, L


def shadow_transmit(ctx: VolCtx, depth: int, o0, wi, dist, med0, want, pixel_idx, sidx, lam):
    """Ratio-tracking transmittance of a shadow ray over up to
    max_shadow_segments segments: each segment is traced to the next
    surface, an opaque surface (material >= 0) blocks it, an interface
    changes the medium and the ray re-spawns beyond it -> (T_ray, r_l, r_u)."""
    scene, cfg = ctx.scene, ctx.cfg
    has_media = scene.n_media > 0
    R = o0.shape[0]
    rand = lambda *salts: _rand(ctx, pixel_idx, sidx, *salts)
    f32 = dict(dtype=torch.float32, device=o0.device)
    T_ray = torch.ones(R, S, **f32)
    r_lt = r_ut = T_ray
    seg_o = o0
    t_rem = torch.where(torch.isfinite(dist), dist * 0.999, 1e30)
    med = med0
    alive = want
    for seg in range(cfg.max_shadow_segments if has_media else 1):
        # a later segment only concerns lanes that crossed an interface
        if seg > 0 and not bool(alive.any()):
            break
        hit = _closest(ctx, seg_o, wi, torch.where(alive, t_rem, -1.0))
        hit_found = alive & (hit.prim >= 0)
        rec = scene.tri_shade[torch.clamp(hit.prim, min=0).long()]
        opaque = hit_found & (rec[..., 24].to(torch.int32) >= 0)
        T_ray = torch.where(opaque[..., None], 0.0, T_ray)
        alive = alive & ~opaque
        t_end = torch.where(hit_found & ~opaque, hit.t, t_rem)

        if has_media:
            mctx = media.gather_medium(scene, med, lam, ctx.med_all)
            t0, t1 = media.segment_bounds(mctx, seg_o, wi, t_end)
            is_grid = mctx.med_type == scene_mod.MED_GRID
            sigma_unit = torch.where(is_grid[..., None], mctx.sigma_a + mctx.sigma_s,
                                     mctx.sigma_maj)
            run0 = alive & mctx.valid & (med >= 0) & (t1 > t0) \
                & (mctx.sigma_maj[..., 0] > 1e-18)
            t, running = t0, run0
            T_s, rl_s, ru_s = T_ray, r_lt, r_ut
            T_final = T_acc = torch.ones(R, S, **f32)
            dda = media.dda_init(scene, mctx, seg_o, wi, t0, t1)
            for step in range(cfg.max_null_steps):
                if not bool(running.any()):
                    break
                run = running
                sigma_maj = sigma_unit * dda.maj_dens[..., None]
                maj0 = sigma_maj[..., 0]
                seg_end = torch.minimum(dda.seg_end, t1)
                u = rand(depth, step, 303, seg)
                dt = torch.where(maj0 > 1e-18, -torch.log1p(-u) / maj0, 2e30)
                t_new = t + dt
                crossed = run & (t_new >= seg_end) & (seg_end < t1)
                exited = run & (t_new >= seg_end) & ~crossed
                t_stop = torch.minimum(t_new, seg_end)
                T_ev = T_acc * torch.exp(-sigma_maj * (t_stop - t)[..., None])
                p = seg_o + t_new[..., None] * wi
                dens = media.density(scene, mctx, p)
                sig_n = torch.clamp(sigma_maj - mctx.sigma_a * dens[..., None]
                                    - mctx.sigma_s * dens[..., None], min=0.0)
                ev = run & ~exited & ~crossed
                evm = ev[..., None]
                pdf = torch.clamp(T_ev[..., 0] * maj0, min=1e-30)[..., None]
                T_new = torch.where(evm, T_s * T_ev * sig_n / pdf, T_s)
                rl_s = torch.where(evm, rl_s * T_ev * sigma_maj / pdf, rl_s)
                ru_s = torch.where(evm, ru_s * T_ev * sig_n / pdf, ru_s)
                # Russian roulette on a low transmittance
                tr = T_new / torch.clamp(_avg(rl_s + ru_s), min=1e-30)[..., None]
                low = ev & (tr.amax(-1) < 0.05)
                killed = low & (rand(depth, step, 404, seg) < 0.75)
                T_s = torch.where(killed[..., None], 0.0,
                                  torch.where((low & ~killed)[..., None], T_new / 0.25, T_new))
                T_final = torch.where(exited[..., None], T_ev, T_final)
                T_acc = torch.where(evm, 1.0, torch.where(crossed[..., None], T_ev, T_acc))
                dda = media.dda_advance(scene, mctx, dda, t1, crossed)
                t = torch.where(run, t_stop, t)
                running = run & ((ev & _any_pos(T_s)) | crossed)
            tf0 = torch.clamp(T_final[..., 0:1], min=1e-30)
            ok = run0[..., None]
            T_ray = torch.where(ok, T_s * T_final / tf0, T_ray)
            r_lt = torch.where(ok, rl_s * T_final / tf0, r_lt)
            r_ut = torch.where(ok, ru_s * T_final / tf0, r_ut)
            alive = alive & _any_pos(T_ray)

        # through a boundary that is not opaque: the medium changes and the
        # ray re-spawns beyond it
        cross = hit_found & ~opaque
        if has_media:
            v0, v1, v2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
            ng = vm.normalize(vm.cross(v1 - v0, v2 - v0))
            med_in = rec[..., 26].to(torch.int32)
            med_out = rec[..., 27].to(torch.int32)
            med = torch.where(cross, torch.where(vm.dot(wi, ng) < 0, med_in, med_out), med)
            p_hit = seg_o + hit.t[..., None] * wi
            seg_o = torch.where(cross[..., None],
                                vm.offset_ray_origin(p_hit, vm.face_forward(ng, wi), wi), seg_o)
            t_rem = torch.where(cross, t_rem - hit.t, t_rem)
        alive = alive & cross
    return T_ray, r_lt, r_ut


def sample_ld(ctx: VolCtx, depth: int, p_ref, ns, wo_world, ctx_mat, is_med, g_med, cur_med,
              want, beta, r_p, L, pixel_idx, sidx, lam):
    """Next-event estimation shared by surface lanes (BSDF) and medium
    lanes (HG phase), with transmittance and balance MIS over the rescaled
    probabilities -> L."""
    scene = ctx.scene
    if scene.n_lights == 0:
        return L
    rand = lambda *salts: _rand(ctx, pixel_idx, sidx, *salts)
    u_sel, ulu, ulv = rand(depth, 11), rand(depth, 12), rand(depth, 13)
    light_id, sel_pmf, _ = lightsamplers.sample_ctx(ctx.ls_tables, p_ref, u_sel)
    ls = lights.sample_li(scene, ctx.light_all, light_id, p_ref, lam,
                          torch.stack([ulu, ulv], -1), ctx.light_tags)
    wi_l = ls.wi
    f_b, pdf_b = bxdf.evaluate(ctx_mat, vm.to_local(ns, wo_world), vm.to_local(ns, wi_l))
    f_surf = f_b * vm.absdot(wi_l, ns)[..., None]
    ph = media.phase_p(wo_world, wi_l, g_med)
    f_hat = torch.where(is_med[..., None], ph[..., None].expand_as(f_surf), f_surf)
    scatter_pdf = torch.where(is_med, ph, pdf_b)
    want = want & ls.valid & _any_pos(f_hat)

    so = torch.where(is_med[..., None], p_ref,
                     vm.offset_ray_origin(p_ref, vm.face_forward(ns, wi_l), wi_l))
    T_ray, r_lt, r_ut = shadow_transmit(ctx, depth, so, wi_l, ls.dist, cur_med, want,
                                        pixel_idx, sidx, lam)
    r_l_f = r_lt * r_p * (sel_pmf * ls.pdf)[..., None]
    r_u_f = r_ut * r_p * scatter_pdf[..., None]
    denom = torch.where(ls.is_delta, _avg(r_l_f), _avg(r_l_f + r_u_f))
    ok = (want & (denom > 0) & _any_pos(T_ray))[..., None]
    # every possibly-inf factor is zeroed on rejected lanes before the
    # product, so no gradient meets 0 * inf (as in the JAX package)
    f_m = torch.where(ok, f_hat, 0.0)
    li_m = torch.where(ok, ls.li, 0.0)
    return L + beta * f_m * T_ray * li_m / torch.clamp(denom, min=1e-30)[..., None]


def add_emission(ctx: VolCtx, depth: int, o, d, L, beta, r_u, r_l, active, specular_prev,
                 prev_p, sp, found, lam):
    """Escaped rays and emissive surface hits, each weighted by
    1 / avg(r_u + r_l p_light) (1 / avg(r_u) after a specular bounce)."""
    scene = ctx.scene
    if scene.n_lights == 0:
        return L
    R = o.shape[0]
    if ctx.has_escape:  # without an infinite light an escaped ray adds nothing
        escaped = active & ~found
        le_inf = lights.infinite_le(scene, d, lam)
        # the JAX package leaves the portal strategy out of this pdf (mirrored)
        p_li = sampling.UNIFORM_SPHERE_PDF * ctx.inf_sel_pmf
        if lights.has_env_map(scene):
            p_li = p_li + ctx.env_sel_pmf * lights.env_pdf_dir(scene, d)
        p_li = p_li.expand(R)
        denom = torch.where(specular_prev, _avg(r_u), _avg(r_u + r_l * p_li[..., None]))
        L = L + torch.where((escaped & (denom > 0))[..., None],
                            beta * le_inf / torch.clamp(denom, min=1e-30)[..., None], 0.0)

    lrec = ctx.light_all[torch.clamp(sp.light, min=0).long()]
    has_light = found & (sp.light >= 0)
    le = lights.area_light_l_rec(lrec, has_light, sp.ng, -d, lam)
    p_shape = lights.area_pdf_li_from_verts(sp.v0, sp.v1, sp.v2, prev_p)
    p_shape = torch.where(lrec[..., 0].to(torch.int32) == scene_mod.LIGHT_SPHERE_AREA,
                          lights.sphere_pdf_li(lrec, prev_p, sp.p, sp.ng), p_shape)
    p_le = p_shape * lightsamplers.pmf_ctx(ctx.ls_tables, prev_p, sp.light)
    denom2 = torch.where(specular_prev, _avg(r_u), _avg(r_u + r_l * p_le[..., None]))
    return L + torch.where((has_light & (denom2 > 0))[..., None],
                           beta * le / torch.clamp(denom2, min=1e-30)[..., None], 0.0)


def bounce(ctx: VolCtx, depth: int, state: VolState, allow_scatter: bool = True) -> VolState:
    """One volumetric wavefront bounce: trace, sample the medium segment,
    add emission, then on each lane either the medium interaction (phase
    sampling), an interface passthrough, or the surface interaction (NEE,
    BSDF sampling), and Russian roulette. allow_scatter=False is the
    trailing emission-only segment past the maximum depth."""
    scene, cfg, scfg = ctx.scene, ctx.cfg, ctx.sampler_cfg
    has_media = scene.n_media > 0
    if ctx.do_resort and allow_scatter:
        # one sort of the whole lane state by (dead, octant, Morton) serves
        # every traversal of the bounce; perm tracks the caller's lanes
        key = dispatch.ray_sort_key(state.o.detach(), state.d.detach(), ctx.sort_blo,
                                    ctx.sort_bext, torch.where(state.active, 1.0, -1.0))
        state = _take(state, torch.argsort(key, stable=True))
    (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p, cur_med, eta_scale, cone_w,
     cone_s, pix, lam, perm, sidx, film_w, lam_pdf, st) = state
    R = o.shape[0]

    hit = _closest(ctx, o, d, torch.where(active, 1e30, -1.0))
    found = active & (hit.prim >= 0)
    t_hit = torch.where(found, hit.t, torch.inf)
    if st is not None:
        st = count(count(st, 0, active), 2, found)

    # medium segment sampling
    if has_media:
        scattered, med_term, p_scat, beta, r_u, r_l, L = medium_events(
            ctx, depth, o, d, t_hit, cur_med, beta, r_u, r_l, L, active & (cur_med >= 0),
            allow_scatter, pix, sidx, lam)
        active = active & ~med_term
    else:
        scattered = torch.zeros(R, dtype=torch.bool, device=o.device)
        p_scat = o

    sp = _shading_point(scene, hit, o, d)
    surf_found = found & ~scattered & active
    L = add_emission(ctx, depth, o, d, L, beta, r_u, r_l, active & ~scattered, specular_prev,
                     prev_p, sp, surf_found, lam)
    if not allow_scatter:
        return state._replace(L=L, beta=beta, r_u=r_u, r_l=r_l, active=active, st=st)

    wo = -d
    cone_at_hit = cone_w + sp.t * cone_s
    foot = texture.cone_foot_log2(cone_at_hit, vm.absdot(d, sp.ns), sp.uv_scale)
    u_mix = _rand(ctx, pix, sidx, depth, 31) if bxdf.has_mix(scene) else None
    ctx_mat = bxdf.gather_material(scene, sp.mat, lam, ctx.mat_all, sp.uv, u_mix,
                                   foot_log2=foot, kinds=ctx.kinds)
    is_interface = surf_found & (sp.mat < 0)
    surf_lane = surf_found & (sp.mat >= 0)
    g_med = (media.gather_medium(scene, cur_med, lam, ctx.med_all).g if has_media
             else torch.zeros(R, dtype=torch.float32, device=o.device))

    # NEE (shared surface / medium SampleLd)
    if cfg.sample_lights and scene.n_lights > 0:
        p_ref = torch.where(scattered[..., None], p_scat, sp.p)
        ns_ld = torch.where(scattered[..., None], torch.tensor([0.0, 0.0, 1.0], device=o.device),
                            sp.ns)
        L = sample_ld(ctx, depth, p_ref, ns_ld, wo, ctx_mat, scattered, g_med, cur_med,
                      surf_lane | scattered, beta, r_u, L, pix, sidx, lam)
        if st is not None:
            st = count(st, 1, surf_lane | scattered)

    # surface lanes: BSDF sample
    base = DIM_PATH_BASE + depth * DIMS_PER_DEPTH
    uc = samplers.get_1d(scfg, pix, sidx, base + 0)
    ubu, ubv = samplers.get_2d(scfg, pix, sidx, base + 1)
    bs = bxdf.sample(ctx_mat, vm.to_local(sp.ns, wo), uc, torch.stack([ubu, ubv], -1))
    wi_surf = vm.from_local(sp.ns, bs.wi)
    cos_b = vm.absdot(wi_surf, sp.ns)
    d_new = torch.where(is_interface[..., None], d, wi_surf)
    pdf_fwd = bs.pdf
    if has_media:
        # medium lanes: an HG phase direction (p == pdf, so beta is kept and
        # r_l = r_u / pdf); without media no lane scatters in a medium
        u_ph = torch.stack([_rand(ctx, pix, sidx, depth, 21), _rand(ctx, pix, sidx, depth, 22)],
                           -1)
        wi_ph, pdf_ph = media.phase_sample(wo, u_ph, g_med)
        d_new = torch.where(scattered[..., None], wi_ph, d_new)
        pdf_fwd = torch.where(scattered, pdf_ph, pdf_fwd)

    # throughput (surface only: medium scatter and interfaces keep beta)
    # double-where as in the Path wave (the gradient of an invalid lane's
    # clamped pdf is 0 * inf = NaN)
    f_over = bs.f * (cos_b / torch.clamp(torch.where(bs.valid, bs.pdf, 1.0), min=1e-20))[..., None]
    beta = torch.where((surf_lane & bs.valid)[..., None], beta * f_over, beta)
    took_bounce = scattered | surf_lane
    r_l = torch.where(took_bounce[..., None], r_u / torch.clamp(pdf_fwd, min=1e-20)[..., None],
                      r_l)
    live = scattered | (surf_lane & bs.valid & _any_pos(beta)) | is_interface
    active = active & live

    o_surf = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ng, d_new), d_new)
    o_new = torch.where(scattered[..., None], p_scat, o_surf)
    o = torch.where(active[..., None], o_new, o)
    d = torch.where(active[..., None], d_new, d)

    if has_media:
        # interface passthrough or real transmission changes the medium
        crossing = is_interface | (surf_lane & bs.transmission)
        rec = scene.tri_shade[torch.clamp(hit.prim, min=0).long()]
        new_med = torch.where(vm.dot(d_new, sp.ng) < 0, rec[..., 26].to(torch.int32),
                              rec[..., 27].to(torch.int32))
        cur_med = torch.where(crossing, new_med, cur_med)

    specular_prev = torch.where(scattered, False,
                                torch.where(surf_lane, bs.specular, specular_prev))
    cone_w = torch.where(surf_lane | scattered, cone_at_hit, cone_w)
    cone_s = torch.where((surf_lane & ~bs.specular) | scattered, torch.clamp(cone_s, min=0.25),
                         cone_s)
    prev_p = torch.where(took_bounce[..., None],
                         torch.where(scattered[..., None], p_scat, sp.p), prev_p)
    eta_scale = torch.where(surf_lane & bs.transmission, eta_scale * bs.eta * bs.eta, eta_scale)

    # Russian roulette on beta * eta_scale / avg(r_u) (below rr_depth it
    # keeps every lane and divides beta by 1, so it is skipped there)
    if depth >= cfg.rr_depth:
        u_rr = samplers.get_1d(scfg, pix, sidx, base + 6)
        rr = beta.amax(-1) * eta_scale / torch.clamp(_avg(r_u), min=1e-30)
        q = torch.clamp(1.0 - rr, min=0.0)
        die = active & (u_rr < q)
        if st is not None:
            st = count(st, 3, die)
        active = active & ~die
        beta = torch.where(active[..., None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)

    return VolState(o, d, L, beta, r_u, r_l, active, specular_prev, prev_p, cur_med,
                    eta_scale, cone_w, cone_s, pix, lam, perm, sidx, film_w, lam_pdf, st)


def trace_wave_vol(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, pixel_idx,
                   sample_idx, ls_tables=None, isect=None):
    """VolPath: one volumetric path per entry of pixel_idx -> (L, lam,
    lam_pdf, film_w), and the (R, 4) stats counters after them when
    cfg.collect_stats. `scene` holds tensors on pixel_idx's device."""
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, pixel_idx.device, sort=not cfg.resort)
    ctx = make_context(scene, cam, sampler_cfg, cfg, ls_tables, isect)
    state = init_state(ctx, pixel_idx, sample_idx)
    lam, lam_pdf, film_w = state.lam, state.lam_pdf, state.film_w
    for depth in range(cfg.max_depth):
        if not bool(state.active.any()):
            break
        state = bounce(ctx, depth, state)
    # the trailing emission-only segment (adds nothing once every lane is dead)
    if bool(state.active.any()):
        state = bounce(ctx, cfg.max_depth, state, allow_scatter=False)
    L = torch.zeros_like(state.L)
    L[state.perm] = state.L  # back to the caller's lane order
    if state.st is None:
        return L, lam, lam_pdf, film_w
    st = torch.zeros_like(state.st)
    st[state.perm] = state.st
    return L, lam, lam_pdf, film_w, st


# ---------------------------------------------------------------------------
# the phased wave: compaction of the live lanes on a ladder of lane counts
# ---------------------------------------------------------------------------

def _align(n: int, g: int = 4096) -> int:
    return max(g, -(-n // g) * g)


def ladder(R: int) -> list:
    """The lane counts a phased wave of R lanes may run at: _align(R), then
    halving, each a multiple of 4096."""
    sizes = [_align(R)]
    while sizes[-1] > 4096:
        nxt = _align(sizes[-1] // 2)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


def make_phased_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, isect=None,
                     phase_len: int = 8, device=None):
    """The wavefront with compaction for deep paths (the crown's depth 100).

    The bounce loop runs in phases: bounces 1, 1, 2 and 4, then `phase_len`
    each. After a phase the lane state is partitioned with dead lanes last,
    keeping order; the dead lanes beyond the smallest ladder size that holds
    every live lane (`ladder`, 25% headroom) add their radiance to the film
    and are cut away. In torch a ladder size is only a slice length.
    Returns wave(film, sample_idx) -> film; after a call, `wave.phases`
    lists (depth reached, lanes run, live lanes) per phase, and with
    cfg.collect_stats `wave.stats` holds the wave's (R, 4) counters by
    pixel."""
    if isect is not None and device is None:
        device = isect.device
    device = resolve_device(device, scene)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device, sort=not cfg.resort)
    ctx = make_context(scene_mod.to_device(scene, device), cam,
                       samplers.to_device(sampler_cfg, device), cfg, ls_tables, isect)
    R = cam.width * cam.height
    sizes = ladder(R)

    def film_add(film, st: VolState):
        # pixels are unique within a wave (the padding lanes alias pixel 0
        # with weight 0 and radiance 0), so the order of index_add's float
        # adds cannot change a pixel's sum
        if st.st is not None:  # a padding lane's counters are 0
            wave.stats.index_add_(0, st.pixel_idx.long(), st.st)
        return film_mod.add_samples(film, st.pixel_idx, st.L, st.lam, st.lam_pdf,
                                    filter_weight=st.film_w, sequential=False)

    def wave(film, sample_idx):
        pix = torch.arange(sizes[0], dtype=torch.int32, device=device)
        live_pix = pix < R
        state = init_state(ctx, torch.where(live_pix, pix, 0), sample_idx)
        if cfg.collect_stats:
            wave.stats = torch.zeros(R, 4, dtype=torch.float32, device=device)
        if sizes[0] > R:  # padding lanes: dead, zero film weight
            state = state._replace(active=state.active & live_pix,
                                   film_w=torch.where(live_pix, state.film_w, 0.0))
        depth, k, phases = 0, 0, []
        for n_phase in range(cfg.max_depth + 1):
            d_end = depth + ([1, 1, 2, 4][n_phase] if n_phase < 4 else phase_len)
            while depth < min(d_end, cfg.max_depth) and bool(state.active.any()):
                state = bounce(ctx, depth, state)
                depth += 1
            # dead lanes last, live lanes in their order (stable)
            state = _take(state, torch.argsort((~state.active).to(torch.int32), stable=True))
            live = int(state.active.sum())
            phases.append((depth, sizes[k], live))
            if live == 0 or depth >= cfg.max_depth:
                break
            want = _align(int(live * 1.25))
            k0 = k
            while k + 1 < len(sizes) and sizes[k + 1] >= want:
                k += 1
            if k > k0:
                n = sizes[k]
                film = film_add(film, _take(state, slice(n, None)))
                state = _take(state, slice(None, n))
        if bool(state.active.any()):
            state = bounce(ctx, cfg.max_depth, state, allow_scatter=False)
        wave.phases = phases
        return film_add(film, state)

    wave.phases = []
    wave.stats = None
    return wave
