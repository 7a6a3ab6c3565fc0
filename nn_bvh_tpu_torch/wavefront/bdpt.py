"""Bidirectional path tracing, BDPT (port of nn_bvh_tpu/wavefront/bdpt.py).

One camera and one light subpath per pixel sample, each a static Python
list of vertices over the depth, each vertex a set of (R, ...) tensors.
Every (s, t) strategy is one batched connection: a shadow-ray batch and
the masked MIS weight, MISWeight's walk of remap0(pdf_rev) /
remap0(pdf_fwd) ratios back along both subpaths, with the connection's
own pdfs at the four vertices nearest the edge. The strategies with one
camera vertex (t = 1) splat through the pinhole camera (film.add_splats);
the others add to the pixel's own L.

As in the JAX package, infinite lights start no light subpath; escaped
camera rays and next-event samples of infinite or distant lights are
weighted by the power heuristic of the two strategies that can make them
(BSDF sampling and light sampling).

Random numbers are hash_float(pixel, sample, seed, salt...) counters (the
light walk's seed is seed + 7), the JAX package's streams bit for bit;
the camera ray reads the sampler's pixel and wavelength dimensions. On
the card the traversal calls go through the sorting intersector. rsqrt is
torch's, which may differ from XLA's by an ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..devices import resolve_device
from ..geometry import scene as scene_mod, triangle
from ..scatter import bxdf, lights, lightsamplers
from . import camera as camera_mod, film as film_mod
from .integrator import IntegratorConfig, NoGradIntersectors, _shading_point
from .lightpath import (_camera_screen_area, camera_project, light_tri_verts, make_intersectors,
                        sample_le)


class Vertex(NamedTuple):
    """One subpath vertex over the wave (every field (R, ...))."""

    p: torch.Tensor          # (R, 3)
    ns: torch.Tensor         # shading normal
    ng: torch.Tensor         # geometric normal
    wo: torch.Tensor         # unit direction toward the previous vertex
    ctx: bxdf.MaterialCtx | None  # shading context (None for an emitter)
    beta: torch.Tensor       # (R, 4) throughput arriving at the vertex
    pdf_fwd: torch.Tensor    # (R,) area pdf of sampling the vertex forward
    pdf_rev: torch.Tensor    # (R,) area pdf of sampling it backward
    delta: torch.Tensor      # (R,) bool: reached through a delta bounce
    active: torch.Tensor     # (R,) bool: the lane holds a real vertex
    light: torch.Tensor      # (R,) i32 area-light id of an emissive hit (-1 none)
    tri_area: torch.Tensor   # (R,) area of the hit triangle (light-origin pdf)


def _remap0(x):
    """MISWeight's remap0: a 0 pdf counts as 1, so delta terms cancel."""
    return torch.where(x > 0, x, 1.0)


def _to_area(pdf_sa, p_from, p_to, ng_to):
    """Solid-angle pdf at p_from -> area pdf at p_to (ConvertDensity)."""
    d = p_to - p_from
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    return pdf_sa * vm.absdot(ng_to, d * torch.rsqrt(d2)[..., None]) / d2


def _bsdf_pdf(v: Vertex, wo_w, wi_w):
    """pdf of sampling wi_w at v given wo_w (both world)."""
    return bxdf.evaluate(v.ctx, vm.to_local(v.ns, wo_w), vm.to_local(v.ns, wi_w))[1]


def _bsdf_f(v: Vertex, wo_w, wi_w):
    return bxdf.evaluate(v.ctx, vm.to_local(v.ns, wo_w), vm.to_local(v.ns, wi_w))[0]


def _dirto(a, b):
    d = b - a
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    return d * torch.rsqrt(d2)[..., None], d2


def _light_dir_pdf(lrec, ng_l, w):
    """The emission-direction pdf of sample_le: cosine hemisphere for area
    and sphere lights (halved when two-sided), uniform sphere for points."""
    ltype = lrec[..., 0].to(torch.int32)
    two_sided = lrec[..., 9] > 0
    c = vm.dot(ng_l, w)
    pdf_area = torch.where(two_sided, 0.5 * sampling.cosine_hemisphere_pdf(c.abs()),
                           torch.where(c > 0, sampling.cosine_hemisphere_pdf(c), 0.0))
    is_surf = (ltype == scene_mod.LIGHT_AREA_TRI) | (ltype == scene_mod.LIGHT_SPHERE_AREA)
    return torch.where(is_surf, pdf_area, sampling.UNIFORM_SPHERE_PDF)


def _light_origin_area(lrec, tri_area):
    """The area the light-origin position pdf is uniform over: the emitting
    triangle, or 4 pi r^2 for a sphere light."""
    ltype = lrec[..., 0].to(torch.int32)
    r = lrec[..., 8]
    return torch.where(ltype == scene_mod.LIGHT_SPHERE_AREA,
                       torch.clamp(4.0 * torch.pi * r * r, min=1e-12),
                       torch.clamp(tri_area, min=1e-12))


def _random_walk(scene, isect, mat_all, kinds, o, d, beta, pdf_dir, n_steps, active0, rand,
                 prev_p0, on_env, mode="radiance") -> list:
    """The camera or light subpath walk -> a list of n_steps Vertex.
    on_env(depth, o, d, beta, escaped, pdf_dir) sees the rays that leave the
    scene (the camera walk's escaped radiance); None for the light walk."""
    verts: list[Vertex] = []
    active = active0
    prev_p = prev_p0
    prev_delta = torch.zeros_like(active0)
    R = o.shape[0]
    zeros = torch.zeros(R, dtype=torch.float32, device=o.device)
    for depth in range(n_steps):
        hit = isect.closest(o, d, torch.where(active, 1e30, -1.0))
        found = active & (hit.prim >= 0)
        if on_env is not None:
            on_env(depth, o, d, beta, active & (hit.prim < 0), pdf_dir)
        sp = _shading_point(scene, hit, o, d)
        ctx = bxdf.gather_material(scene, sp.mat, rand.lam, mat_all, sp.uv, rand(20, depth),
                                   kinds=kinds)
        found = found & (sp.mat >= 0)
        _, d2_prev = _dirto(prev_p, sp.p)
        pdf_fwd = torch.where(prev_delta, 0.0, pdf_dir * vm.absdot(sp.ng, d) / d2_prev)
        v = Vertex(p=sp.p, ns=sp.ns, ng=sp.ng, wo=-d, ctx=ctx, beta=beta, pdf_fwd=pdf_fwd,
                   pdf_rev=zeros, delta=prev_delta, active=found, light=sp.light,
                   tri_area=torch.clamp(triangle.area(sp.v0, sp.v1, sp.v2), min=1e-12))
        # bounce
        u2 = torch.stack([rand(22, depth), rand(23, depth)], -1)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, -d), rand(21, depth), u2, mode=mode)
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        nxt = found & bs.valid
        # the previous vertex's reverse pdf: sampling back toward it from
        # here, as an area pdf there
        if depth > 0:
            pv = verts[-1]
            rev = torch.where(bs.specular, 0.0,
                              _to_area(_bsdf_pdf(v, wi_w, -d), sp.p, pv.p, pv.ng))
            verts[-1] = pv._replace(pdf_rev=torch.where(nxt, rev, pv.pdf_rev))
        beta = torch.where(nxt[..., None],
                           beta * bs.f * (cos_b / torch.clamp(bs.pdf, min=1e-20))[..., None],
                           beta)
        active = nxt & (beta > 0).any(-1)
        prev_delta = bs.specular
        pdf_dir = torch.where(bs.specular, 0.0, bs.pdf)
        prev_p = sp.p
        ng_o = vm.face_forward(sp.ng, wi_w)
        o = torch.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_w), o)
        d = torch.where(active[..., None], wi_w, d)
        verts.append(v)
    return verts


def _mis_weight(cam: list, lig: list, t_s: int, s: int, cam_rev: dict, lig_rev: dict,
                light_delta0):
    """MISWeight: 1 / (1 + sum ri) with the connection's pdf_rev overrides.
    t_s = camera surface vertices used (pbrt's t = t_s + 1), s = light
    vertices used."""
    sum_ri = 0.0
    ri = 1.0
    for i in range(t_s - 1, -1, -1):
        ri = ri * _remap0(cam_rev.get(i, cam[i].pdf_rev)) / _remap0(cam[i].pdf_fwd)
        prev_delta = cam[i - 1].delta if i > 0 else torch.zeros_like(cam[0].delta)
        sum_ri = sum_ri + torch.where(~cam[i].delta & ~prev_delta, ri, 0.0)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(lig_rev.get(i, lig[i].pdf_rev)) / _remap0(lig[i].pdf_fwd)
        prev_delta = lig[i - 1].delta if i > 0 else light_delta0
        sum_ri = sum_ri + torch.where(~lig[i].delta & ~prev_delta, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


class _Rand:
    """Counter-based uniforms per (pixel, sample); lam rides along for the
    walk's material gathers."""

    def __init__(self, pixel_idx, sidx, seed, lam):
        self._pi, self._si, self._seed = pixel_idx, sidx, seed
        self.lam = lam

    def __call__(self, *salts):
        return rng.hash_float(self._pi, self._si, self._seed, *salts)


def trace_bdpt_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, pixel_idx,
                    sample_idx, ls_tables=None, isect=None):
    """One BDPT wave -> (L (R, 4), lam, lam_pdf, splat_pix, splat_L,
    splat_lam, splat_lam_pdf); a splat of a lane that is not connected
    goes to pixel 0 with L = 0. `scene` holds tensors on pixel_idx's
    device."""
    device = pixel_idx.device
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    isect = NoGradIntersectors(isect)
    R = pixel_idx.shape[0]
    sidx = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    max_depth = cfg.max_depth
    # pbrt's sizing: maxDepth + 2 camera vertices with the camera itself,
    # maxDepth + 1 light vertices; every strategy keeps t_s + s + 1 <= maxDepth + 2
    T = max_depth + 1        # camera surface vertices
    S = max_depth + 1        # light vertices with the origin
    f32 = dict(dtype=torch.float32, device=device)

    # wavelengths and the camera ray
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, 0)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(
        samplers.get_1d(sampler_cfg, pixel_idx, sidx, 2))
    rand = _Rand(pixel_idx, sidx, sampler_cfg.seed, lam)
    o0, d0 = camera_mod.generate_rays(cam, pixel_idx, torch.stack([upx, upy], -1),
                                      torch.full((R, 2), 0.5, **f32))

    light_all = lights.light_records(scene)
    mat_all = bxdf.material_records(scene)
    kinds = bxdf.scene_kinds(scene)
    tags = lights.scene_tags(scene) if scene.n_lights else frozenset()
    n_lights = scene.n_lights
    SN = spectrum.N_SPECTRUM_SAMPLES
    L = torch.zeros(R, SN, **f32)
    A = _camera_screen_area(cam)
    c2w = torch.as_tensor(cam.cam_to_world, device=device)
    cam_pos = c2w[:3, 3]

    # escaped camera rays: the {BSDF, light sampling} power-heuristic pair
    if n_lights:
        sel_pmf_of = lambda tag: torch.where(scene.light_type == tag, ls_tables.pmf, 0.0).sum()
        inf_pmf = sel_pmf_of(scene_mod.LIGHT_UNIFORM_INFINITE)
        env_pmf = sel_pmf_of(scene_mod.LIGHT_IMAGE_INFINITE)
    env_box = [torch.zeros(R, SN, **f32)]

    def on_env(depth, o, d, beta, escaped, pdf_dir):
        if n_lights == 0:
            return
        le = lights.infinite_le(scene, d, lam)
        pdf_l = sampling.UNIFORM_SPHERE_PDF * inf_pmf
        if lights.has_env_map(scene):
            pdf_l = pdf_l + env_pmf * lights.env_pdf_dir(scene, d)
        if depth == 0:
            w = torch.ones(R, **f32)
        else:
            w = torch.where(pdf_dir <= 0, 1.0,
                            sampling.power_heuristic(1.0, pdf_dir, 1.0, pdf_l.expand(R)))
        env_box[0] = env_box[0] + torch.where(escaped[..., None], beta * le * w[..., None], 0.0)

    # --- camera subpath: the pinhole's direction pdf 1 / (A cos^3)
    cos_cam0 = vm.absdot(d0, c2w[:3, 2])
    pdf_cam_dir0 = 1.0 / (A * torch.clamp(cos_cam0, min=1e-6) ** 3)
    cam_v = _random_walk(scene, isect, mat_all, kinds, o0, d0, torch.ones(R, SN, **f32),
                         pdf_cam_dir0, T, torch.ones(R, dtype=torch.bool, device=device), rand,
                         o0, on_env)
    L = L + env_box[0]

    # --- light subpath
    lig_v: list[Vertex] = []
    light_delta0 = torch.zeros(R, dtype=torch.bool, device=device)
    if n_lights > 0:
        light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, rand(2))
        lrec0 = light_all[torch.clamp(light_id, min=0).long()]
        p0, ng0, dL, beta0, is_area0 = sample_le(scene, light_all, light_id, lam,
                                                 torch.stack([rand(3), rand(4)], -1),
                                                 torch.stack([rand(5), rand(6)], -1))
        sel_pmf = torch.clamp(sel_pmf, min=1e-12)
        beta_l = beta0 / sel_pmf[..., None]
        act0 = (light_id >= 0) & (beta_l > 0).any(-1)
        is_point0 = lrec0[..., 0].to(torch.int32) == scene_mod.LIGHT_POINT
        light_delta0 = is_point0
        tri_a0 = torch.where(is_area0, torch.clamp(
            triangle.area(*light_tri_verts(scene, lrec0)), min=1e-12), 1.0)
        origin_a0 = _light_origin_area(lrec0, tri_a0)
        v0 = Vertex(p=p0, ns=ng0, ng=ng0, wo=ng0, ctx=None,
                    beta=lights.record_spectrum(lrec0, lam) / sel_pmf[..., None],
                    pdf_fwd=torch.where(is_area0, 1.0 / origin_a0, 1.0) * sel_pmf,
                    pdf_rev=torch.zeros(R, **f32), delta=is_point0, active=act0,
                    light=light_id, tri_area=origin_a0)
        oL = vm.offset_ray_origin(p0, vm.face_forward(ng0, dL), dL)
        walk = _random_walk(scene, isect, mat_all, kinds, oL, dL, beta_l,
                            _light_dir_pdf(lrec0, ng0, dL), S - 1, act0,
                            _Rand(pixel_idx, sidx, sampler_cfg.seed + 7, lam), p0, None,
                            mode="importance")
        # the light origin's reverse pdf, from its first walk vertex
        if walk:
            w1 = walk[0]
            to0, _ = _dirto(w1.p, p0)
            v0 = v0._replace(pdf_rev=torch.where(
                w1.active, _to_area(_bsdf_pdf(w1, w1.wo, to0), w1.p, p0, ng0), 0.0))
        lig_v = [v0] + walk

    splat_pix, splat_L = [], []
    pmf_of = lambda p_ref, lid: lightsamplers.pmf_ctx(ls_tables, p_ref, lid)

    # --- strategies
    for t_s in range(1, T + 1):
        pt = cam_v[t_s - 1]
        pt_prev_p = cam_v[t_s - 2].p if t_s >= 2 else cam_pos.expand(R, 3)

        # s = 0: the camera path hits an emitter
        if n_lights > 0:
            lrec = light_all[torch.clamp(pt.light, min=0).long()]
            has_l = pt.active & (pt.light >= 0)
            le = lights.area_light_l_rec(lrec, has_l, pt.ng, pt.wo, lam)
            cam_rev = {t_s - 1: pmf_of(pt_prev_p, pt.light)
                       / _light_origin_area(lrec, pt.tri_area)}
            if t_s >= 2:
                cam_rev[t_s - 2] = _to_area(_light_dir_pdf(lrec, pt.ng, -pt.wo), pt.p,
                                            cam_v[t_s - 2].p, cam_v[t_s - 2].ng)
            # a 2-vertex path has one strategy: weight 1 (MISWeight's early out)
            if t_s == 1:
                w = torch.ones(R, **f32)
            else:
                w = _mis_weight(cam_v, lig_v, t_s, 0, cam_rev, {}, light_delta0)
            L = L + torch.where(has_l[..., None], pt.beta * le * w[..., None], 0.0)

        # s = 1: sample a light at pt (next-event estimation)
        if n_lights > 0 and t_s + 1 <= max_depth + 1:
            u2 = torch.stack([rand(31, t_s), rand(32, t_s)], -1)
            lid, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, pt.p, rand(30, t_s))
            ls = lights.sample_li(scene, light_all, lid, pt.p, lam, u2, tags)
            lrec = light_all[torch.clamp(lid, min=0).long()]
            ltype = lrec[..., 0].to(torch.int32)
            is_inf = ((ltype == scene_mod.LIGHT_UNIFORM_INFINITE)
                      | (ltype == scene_mod.LIGHT_IMAGE_INFINITE)
                      | (ltype == scene_mod.LIGHT_PORTAL_ENV)
                      | (ltype == scene_mod.LIGHT_DISTANT))
            f = _bsdf_f(pt, pt.wo, ls.wi)
            cos_pt = vm.absdot(ls.wi, pt.ns)
            pdf_l = torch.clamp(ls.pdf * sel_pmf, min=1e-20)
            want = pt.active & ls.valid & (cos_pt > 0) & (f > 0).any(-1)
            so = vm.offset_ray_origin(pt.p, vm.face_forward(pt.ng, ls.wi), ls.wi)
            occ = isect.any_hit(so, ls.wi, torch.where(
                want, torch.clamp(ls.dist * 0.999, max=1e30), -1.0))
            # full BDPT weights for finite lights, the PT pair for infinite ones
            pdf_b = _bsdf_pdf(pt, pt.wo, ls.wi)
            q_p = pt.p + ls.wi * torch.where(torch.isfinite(ls.dist), ls.dist, 1.0)[..., None]
            tv = light_tri_verts(scene, lrec)
            ng_q = triangle.geometric_normal(*tv)
            # a sphere light: the surface normal at the sampled point, the
            # origin pdf over 4 pi r^2 (field 8 is its radius, not a triangle)
            is_sph_q = ltype == scene_mod.LIGHT_SPHERE_AREA
            ng_q = torch.where(is_sph_q[..., None], vm.normalize(q_p - lrec[..., 1:4]), ng_q)
            origin_aq = _light_origin_area(lrec, torch.clamp(triangle.area(*tv), min=1e-12))
            is_area_q = (ltype == scene_mod.LIGHT_AREA_TRI) | is_sph_q
            q_delta = ls.is_delta
            q_vert = Vertex(p=q_p, ns=ng_q, ng=ng_q, wo=-ls.wi, ctx=None, beta=ls.li,
                            pdf_fwd=torch.where(is_area_q, sel_pmf / origin_aq, sel_pmf),
                            pdf_rev=torch.zeros(R, **f32), delta=q_delta, active=want,
                            light=lid, tri_area=origin_aq)
            lig_rev = {0: torch.where(q_delta, 0.0, _to_area(pdf_b, pt.p, q_p, ng_q))}
            cam_rev = {t_s - 1: _to_area(_light_dir_pdf(lrec, ng_q, -ls.wi), q_p, pt.p, pt.ng)}
            if t_s >= 2:
                rev_sa = _bsdf_pdf(pt, ls.wi, vm.normalize(pt_prev_p - pt.p))
                cam_rev[t_s - 2] = _to_area(rev_sa, pt.p, cam_v[t_s - 2].p, cam_v[t_s - 2].ng)
            w_bdpt = _mis_weight(cam_v, [q_vert], t_s, 1, cam_rev, lig_rev, q_delta)
            w_pt = torch.where(ls.is_delta, 1.0,
                               sampling.power_heuristic(1.0, pdf_l, 1.0, pdf_b))
            w = torch.where(is_inf, w_pt, w_bdpt)
            contrib = pt.beta * f * (cos_pt / pdf_l * w)[..., None] * ls.li
            L = L + torch.where((want & ~occ)[..., None], contrib, 0.0)

        # s >= 2: connect to a light-subpath vertex
        for s in range(2, S + 1):
            if s > len(lig_v) or t_s + s > max_depth + 1:
                continue
            qs, qs_prev = lig_v[s - 1], lig_v[s - 2]
            wi_c, d2_c = _dirto(pt.p, qs.p)  # pt -> qs
            f_pt = _bsdf_f(pt, pt.wo, wi_c)
            f_qs = _bsdf_f(qs, qs.wo, -wi_c)
            g = vm.absdot(wi_c, pt.ns) * vm.absdot(wi_c, qs.ns) / d2_c
            want = pt.active & qs.active & (f_pt > 0).any(-1) & (f_qs > 0).any(-1)
            so = vm.offset_ray_origin(pt.p, vm.face_forward(pt.ng, wi_c), wi_c)
            occ = isect.any_hit(so, wi_c, torch.where(want, torch.sqrt(d2_c) * 0.998, -1.0))
            # the pdf_rev overrides at the four connection vertices
            cam_rev = {t_s - 1: _to_area(_bsdf_pdf(qs, qs.wo, -wi_c), qs.p, pt.p, pt.ng)}
            if t_s >= 2:
                rev_sa = _bsdf_pdf(pt, wi_c, vm.normalize(pt_prev_p - pt.p))
                cam_rev[t_s - 2] = _to_area(rev_sa, pt.p, cam_v[t_s - 2].p, cam_v[t_s - 2].ng)
            lig_rev = {s - 1: _to_area(_bsdf_pdf(pt, pt.wo, wi_c), pt.p, qs.p, qs.ng)}
            rev_sa_q = (_bsdf_pdf(qs, -wi_c, vm.normalize(qs_prev.p - qs.p))
                        if qs.ctx is not None else torch.zeros(R, **f32))
            lig_rev[s - 2] = _to_area(rev_sa_q, qs.p, qs_prev.p, qs_prev.ng)
            w = _mis_weight(cam_v, lig_v, t_s, s, cam_rev, lig_rev, light_delta0)
            contrib = pt.beta * f_pt * f_qs * qs.beta * (g * w)[..., None]
            L = L + torch.where((want & ~occ)[..., None], contrib, 0.0)

    # t = 1: splat the light vertices to the camera
    for s in range(2, S + 1):
        if s > len(lig_v) or s > max_depth + 1:
            continue
        qs, qs_prev = lig_v[s - 1], lig_v[s - 2]
        to_cam = cam_pos - qs.p
        d2 = torch.clamp(vm.length_squared(to_cam), min=1e-12)
        wi_cam = to_cam * torch.rsqrt(d2)[..., None]
        pix, cos_cam, in_f = camera_project(cam, qs.p)
        f = _bsdf_f(qs, qs.wo, wi_cam)
        cos_q = vm.absdot(wi_cam, qs.ns)
        want = qs.active & in_f & (f > 0).any(-1) & (cos_q > 0)
        so = vm.offset_ray_origin(qs.p, vm.face_forward(qs.ng, wi_cam), wi_cam)
        occ = isect.any_hit(so, wi_cam, torch.where(want, torch.sqrt(d2) * 0.999, -1.0))
        cos_c = torch.clamp(cos_cam, min=1e-6)
        we = 1.0 / (A * cos_c ** 4)
        pdf_wi = d2 / cos_c
        # MIS: the camera's pdf of the connection direction, as area at qs
        lig_rev = {s - 1: _to_area(1.0 / (A * cos_c ** 3), cam_pos, qs.p, qs.ng)}
        rev_sa_q = _bsdf_pdf(qs, wi_cam, vm.normalize(qs_prev.p - qs.p))
        lig_rev[s - 2] = _to_area(rev_sa_q, qs.p, qs_prev.p, qs_prev.ng)
        w = _mis_weight([], lig_v, 0, s, {}, lig_rev, light_delta0)
        ok = want & ~occ
        splat_pix.append(torch.where(ok, pix, 0))
        splat_L.append(torch.where(ok[..., None],
                                   qs.beta * f * (cos_q * we / pdf_wi * w)[..., None], 0.0))

    if splat_pix:
        reps = len(splat_pix)
        return (L, lam, lam_pdf, torch.cat(splat_pix), torch.cat(splat_L),
                lam.repeat(reps, 1), lam_pdf.repeat(reps, 1))
    empty = torch.zeros(0, SN, **f32)
    return (L, lam, lam_pdf, torch.zeros(0, dtype=torch.int64, device=device), empty, empty,
            empty)


def render_bdpt(scene, dbvh, cam, spp: int = 16, sampler: str = "independent", seed: int = 0,
                cfg: IntegratorConfig = IntegratorConfig(), device=None,
                isect=None) -> torch.Tensor:
    """BDPT render: per-pixel strategies into the film, the t = 1 splats
    beside them, developed with splat_scale 1/spp -> (H, W, 3) linear sRGB.
    `isect` overrides the traversal backend."""
    device = resolve_device(device, scene)
    R = cam.width * cam.height
    sampler_cfg = samplers.to_device(
        samplers.make_sampler(sampler, seed=seed, spp=spp, width=cam.width), device)
    film = film_mod.make_film(cam.height, cam.width, device)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    pix = torch.arange(R, dtype=torch.int32, device=device)
    for s in range(spp):
        L, lam, lam_pdf, sp_pix, sp_L, sp_lam, sp_lpdf = trace_bdpt_wave(
            scene_d, None, cam, sampler_cfg, cfg, pix, s, ls_tables, isect)
        film = film_mod.add_samples(film, pix, L, lam, lam_pdf, sequential=True)
        if sp_pix.shape[0]:
            film = film_mod.add_splats(film, sp_pix, sp_L, sp_lam, sp_lpdf)
    return film_mod.develop(film, splat_scale=1.0 / spp)
