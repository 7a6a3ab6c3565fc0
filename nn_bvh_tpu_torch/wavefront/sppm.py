"""Stochastic progressive photon mapping, SPPM (port of
nn_bvh_tpu/wavefront/sppm.py).

One iteration is a camera pass, a photon pass and a density estimate:
- camera pass: per-pixel paths through delta (perfectly specular)
  interactions only; the first non-delta vertex is the pixel's visible
  point. Emission along the specular chain and one light sample at the
  visible point add to the direct term. As in the JAX package every
  non-delta vertex makes a visible point (pbrt makes them at diffuse
  vertices and at glossy ones at the depth limit).
- photon pass: light subpaths from lightpath.sample_le; every vertex after
  the first bounce deposits a photon (position, incoming direction,
  throughput).
- grid: photons are hashed by cell (18-bit keys) and sorted (a stable
  argsort, as jnp.argsort sorts); each visible point gathers from its 27
  neighbor cells, at most k_cap photons a cell in sorted order (the rest
  are counted in `dropped`), a hash-colliding neighbor cell only once.
- statistics: N' = N + alpha M, r'^2 = r^2 N' / (N + M),
  tau' = (tau + XYZ(beta Phi)) r'^2 / r^2 (Knaus-Zwicker / Hachisuka-Jensen).
Both passes of an iteration share one set of wavelengths.

The gather is 27 * k_cap steps, each a bxdf.evaluate over every visible
point: in eager torch that is many small kernels an iteration (see
PERF.md). Random numbers are the JAX package's hash_float counters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm, spectrum, rng
from ..core.colorspace import xyz_to_linear_srgb
from ..devices import resolve_device
from ..geometry import scene as scene_mod
from ..scatter import bxdf, lights, lightsamplers
from . import camera as camera_mod
from .integrator import IntegratorConfig, NoGradIntersectors, _shading_point
from .lightpath import _to_i32, make_intersectors, sample_le

# hash-grid constants (a collision only spends cap budget; the distance test filters)
_HA, _HB, _HC = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
HASH_BITS = 18
_OFFS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _cell_hash(ix, iy, iz) -> torch.Tensor:
    """The 18-bit key of integer cell coordinates (uint32 products, as the
    JAX package wraps them) -> int64."""
    h = (rng.mul32(rng.u32(ix), _HA) ^ rng.mul32(rng.u32(iy), _HB)
         ^ rng.mul32(rng.u32(iz), _HC))
    return h & ((1 << HASH_BITS) - 1)


class SPPMState(NamedTuple):
    r2: torch.Tensor       # (R,) squared search radius per pixel
    n: torch.Tensor        # (R,) accumulated photon statistic N
    tau: torch.Tensor      # (R, 3) XYZ tau (scaled as the radius shrinks)
    ld: torch.Tensor       # (R, 3) XYZ direct-lighting sum over iterations
    dropped: torch.Tensor  # () int64: photons skipped by the per-cell cap


def make_state(n_pixels: int, initial_radius: float, device=None) -> SPPMState:
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return SPPMState(r2=torch.full((n_pixels,), float(initial_radius) ** 2, **f32),
                     n=torch.zeros(n_pixels, **f32), tau=torch.zeros(n_pixels, 3, **f32),
                     ld=torch.zeros(n_pixels, 3, **f32),
                     dropped=torch.zeros((), dtype=torch.int64, device=device))


def _is_delta_only(ctx: bxdf.MaterialCtx) -> torch.Tensor:
    """Lanes whose BSDF has no non-delta lobe (the camera path passes on)."""
    t = ctx.mat_type
    return bxdf.effectively_smooth(ctx.ax, ctx.ay) & (
        (t == scene_mod.MAT_CONDUCTOR) | (t == scene_mod.MAT_DIELECTRIC)
        | (t == scene_mod.MAT_THIN_DIELECTRIC))


def sppm_iteration(scene, dbvh, cam, cfg: IntegratorConfig, state: SPPMState, iteration: int,
                   n_photons: int, ls_tables, seed: int = 0, alpha: float = 2.0 / 3.0,
                   k_cap: int = 16, max_photon_depth: int | None = None,
                   isect=None) -> SPPMState:
    """One SPPM iteration (camera pass, photon pass, density estimate).
    `scene` holds tensors on the state's device."""
    device = state.r2.device
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    isect = NoGradIntersectors(isect)
    R = cam.width * cam.height
    P = n_photons
    D_ph = max_photon_depth or cfg.max_depth  # photon paths as long as Path's
    S = spectrum.N_SPECTRUM_SAMPLES
    f32 = dict(dtype=torch.float32, device=device)
    mat_all = bxdf.material_records(scene)
    kinds = bxdf.scene_kinds(scene)
    light_all = lights.light_records(scene)
    tags = lights.scene_tags(scene) if scene.n_lights else frozenset()

    # the iteration's wavelengths, shared by both passes
    it = torch.full((1,), iteration, dtype=torch.int32, device=device)
    lam1, lam_pdf1 = spectrum.sample_wavelengths_visible(
        rng.hash_float(torch.zeros(1, dtype=torch.int32, device=device), it, seed, 0x51))
    lam, lam_pdf = lam1.expand(R, S), lam_pdf1.expand(R, S)
    lam_p = lam1.expand(P, S)

    cam_idx = torch.arange(R, dtype=torch.int32, device=device)
    ph_idx = torch.arange(P, dtype=torch.int32, device=device)
    rand_cam = lambda *salts: rng.hash_float(cam_idx, it.expand(R), seed, *salts)
    rand_ph = lambda *salts: rng.hash_float(ph_idx, it.expand(P), seed ^ 0xABCD, *salts)

    # ---- camera pass: the visible points
    o, d = camera_mod.generate_rays(cam, cam_idx, torch.stack([rand_cam(1), rand_cam(2)], -1),
                                    torch.stack([rand_cam(3), rand_cam(4)], -1))
    beta = torch.ones(R, S, **f32)
    active = torch.ones(R, dtype=torch.bool, device=device)
    ld_new = torch.zeros(R, S, **f32)
    vp_found = torch.zeros(R, dtype=torch.bool, device=device)
    vp_p, vp_ns, vp_ng, vp_wo = (torch.zeros(R, 3, **f32) for _ in range(4))
    vp_beta = torch.zeros(R, S, **f32)
    vp_ctx = None
    for depth in range(cfg.max_depth):
        hit = isect.closest(o, d, torch.where(active & ~vp_found, 1e30, -1.0))
        found = active & ~vp_found & (hit.prim >= 0)
        escaped = active & ~vp_found & (hit.prim < 0)
        sp = _shading_point(scene, hit, o, d)
        wo = -d
        # emission along the specular chain (weight 1: nothing else samples it)
        if scene.n_lights > 0:
            le_inf = lights.infinite_le(scene, d, lam)
            ld_new = ld_new + torch.where(escaped[..., None], beta * le_inf, 0.0)
            lrec = light_all[torch.clamp(sp.light, min=0).long()]
            le = lights.area_light_l_rec(lrec, found & (sp.light >= 0), sp.ng, wo, lam)
            ld_new = ld_new + torch.where(found[..., None], beta * le, 0.0)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv, rand_cam(5, depth),
                                   kinds=kinds)
        if vp_ctx is None:
            vp_ctx = bxdf.zeros_ctx_like(ctx)
        surf = found & (sp.mat >= 0)
        delta = _is_delta_only(ctx)
        new = surf & ~delta & ~vp_found
        n3 = new[..., None]
        vp_p = torch.where(n3, sp.p, vp_p)
        vp_ns = torch.where(n3, sp.ns, vp_ns)
        vp_ng = torch.where(n3, sp.ng, vp_ng)
        vp_wo = torch.where(n3, wo, vp_wo)
        vp_beta = torch.where(n3, beta, vp_beta)
        vp_ctx = bxdf.select_ctx(new, ctx, vp_ctx)
        vp_found = vp_found | new

        # continue through delta lobes only
        cont = surf & delta & ~vp_found
        u2 = torch.stack([rand_cam(7, depth), rand_cam(8, depth)], -1)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, wo), rand_cam(6, depth), u2)
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        beta = torch.where((cont & bs.valid)[..., None],
                           beta * bs.f * (cos_b / torch.clamp(bs.pdf, min=1e-20))[..., None],
                           beta)
        active = cont & bs.valid & (beta > 0).any(-1)
        ng_o = vm.face_forward(sp.ng, wi_w)
        o = torch.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_w), o)
        d = torch.where(active[..., None], wi_w, d)

    # direct lighting at the visible point: one light sample, no MIS (the
    # photons carry indirect light only)
    if scene.n_lights > 0 and cfg.sample_lights:
        light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, vp_p, rand_cam(9))
        ls = lights.sample_li(scene, light_all, light_id, vp_p, lam,
                              torch.stack([rand_cam(10), rand_cam(11)], -1), tags)
        f_l, _ = bxdf.evaluate(vp_ctx, vm.to_local(vp_ns, vp_wo), vm.to_local(vp_ns, ls.wi))
        cos_l = vm.absdot(ls.wi, vp_ns)
        want = vp_found & ls.valid & (cos_l > 0) & (f_l > 0).any(-1)
        so = vm.offset_ray_origin(vp_p, vm.face_forward(vp_ng, ls.wi), ls.wi)
        occ = isect.any_hit(so, ls.wi, torch.where(want, ls.dist * 0.999, -1.0))
        pdf_l = torch.clamp(ls.pdf * sel_pmf, min=1e-20)
        contrib = vp_beta * f_l * (cos_l / pdf_l)[..., None] * ls.li
        ld_new = ld_new + torch.where((want & ~occ)[..., None], contrib, 0.0)

    # ---- photon pass
    light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, rand_ph(20))
    pp, png, pd, pbeta0, _ = sample_le(scene, light_all, light_id, lam_p,
                                       torch.stack([rand_ph(21), rand_ph(22)], -1),
                                       torch.stack([rand_ph(23), rand_ph(24)], -1))
    pbeta = pbeta0 / torch.clamp(sel_pmf, min=1e-12)[..., None]
    pactive = (light_id >= 0) & (pbeta > 0).any(-1)
    po = vm.offset_ray_origin(pp, png, pd)
    pdir = pd
    dep_valid, dep_p, dep_wi, dep_beta = [], [], [], []
    for depth in range(D_ph):
        hit = isect.closest(po, pdir, torch.where(pactive, 1e30, -1.0))
        found = pactive & (hit.prim >= 0)
        sp = _shading_point(scene, hit, po, pdir)
        surf = found & (sp.mat >= 0)
        if depth >= 1:
            # deposits start after the first bounce: the camera pass samples
            # direct light at the visible point
            dep_valid.append(surf)
            dep_p.append(sp.p)
            dep_wi.append(-pdir)
            dep_beta.append(pbeta)
        ctx = bxdf.gather_material(scene, sp.mat, lam_p, mat_all, sp.uv, rand_ph(25, depth),
                                   kinds=kinds)
        u2 = torch.stack([rand_ph(27, depth), rand_ph(28, depth)], -1)
        # photons carry importance: no 1/eta^2 on dielectric transmission
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, -pdir), rand_ph(26, depth), u2,
                         mode="importance")
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        bnew = pbeta * bs.f * (cos_b / torch.clamp(bs.pdf, min=1e-20))[..., None]
        pactive = surf & bs.valid & (bnew > 0).any(-1)
        # Russian roulette on the throughput ratio, from the second bounce
        q = torch.clamp(1.0 - bnew.amax(-1) / torch.clamp(pbeta.amax(-1), min=1e-12), 0.0, 0.95)
        if depth >= 1:
            pactive = pactive & ~(pactive & (rand_ph(29, depth) < q))
            keep = 1.0 - q
        else:
            keep = torch.ones_like(q)
        pbeta = torch.where(pactive[..., None], bnew / torch.clamp(keep, min=1e-6)[..., None],
                            pbeta)
        ng_o = vm.face_forward(sp.ng, wi_w)
        po = torch.where(pactive[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_w), po)
        pdir = torch.where(pactive[..., None], wi_w, pdir)

    if dep_valid:
        ph_valid, ph_p = torch.cat(dep_valid), torch.cat(dep_p)
        ph_wi, ph_beta = torch.cat(dep_wi), torch.cat(dep_beta)
    else:  # D_ph < 2: no indirect photons
        ph_valid = torch.zeros(P, dtype=torch.bool, device=device)
        ph_p, ph_wi = torch.zeros(P, 3, **f32), torch.zeros(P, 3, **f32)
        ph_beta = torch.zeros(P, S, **f32)

    # ---- grid: photons sorted by cell key (a stable sort, as jnp.argsort)
    lo = scene.bounds[0]
    r_max = torch.sqrt(torch.where(vp_found, state.r2, 0.0).amax())
    cell = torch.clamp(r_max, min=1e-6)
    n_keys = 1 << HASH_BITS
    ci = _to_i32(torch.floor((ph_p - lo) / cell))
    keys = torch.where(ph_valid, _cell_hash(ci[:, 0], ci[:, 1], ci[:, 2]), n_keys)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    sp_p, sp_wi, sp_beta = ph_p[order], ph_wi[order], ph_beta[order]

    vci = _to_i32(torch.floor((vp_p - lo) / cell))
    offs = torch.tensor(_OFFS, dtype=torch.int64, device=device)
    ncells = vci[:, None, :] + offs[None, :, :]                   # (R, 27, 3)
    nh = _cell_hash(ncells[..., 0], ncells[..., 1], ncells[..., 2])
    # a neighbor cell whose key an earlier one shares gathers nothing: two
    # cells of one key would gather the same photon range twice
    lower = torch.tril(torch.ones(27, 27, dtype=torch.bool, device=device), -1)
    dup = ((nh[:, :, None] == nh[:, None, :]) & lower[None]).any(-1)
    flat = nh.reshape(-1)
    starts = torch.searchsorted(skeys, flat, right=False).reshape(R, 27)
    ends = torch.searchsorted(skeys, flat, right=True).reshape(R, 27)
    ends = torch.where(dup, starts, ends)
    n_drop = torch.clamp(ends - starts - k_cap, min=0).sum()

    wo_loc = vm.to_local(vp_ns, vp_wo)
    phi = torch.zeros(R, S, **f32)
    m = torch.zeros(R, **f32)
    last = skeys.shape[0] - 1
    for i in range(27 * k_cap):
        c, k = divmod(i, k_cap)
        s0 = starts[:, c]
        j = torch.clamp(s0 + k, 0, last)
        ok = vp_found & ((s0 + k) < ends[:, c])
        ok = ok & (vm.length_squared(sp_p[j] - vp_p) <= state.r2)
        f, _ = bxdf.evaluate(vp_ctx, wo_loc, vm.to_local(vp_ns, sp_wi[j]))
        phi = phi + torch.where(ok[..., None], f * sp_beta[j], 0.0)
        m = m + ok.to(torch.float32)

    # ---- per-pixel statistics
    has = vp_found & (m > 0)
    n_new = state.n + alpha * m
    r2_new = state.r2 * n_new / torch.clamp(state.n + m, min=1e-6)
    tau_add = spectrum.spectrum_to_xyz(vp_beta * phi, lam, lam_pdf)
    tau_add = torch.where(torch.isfinite(tau_add), tau_add, 0.0)
    ratio = torch.where(has, r2_new / torch.clamp(state.r2, min=1e-20), 1.0)
    tau = torch.where(has[..., None], (state.tau + tau_add) * ratio[..., None], state.tau)
    ld_xyz = spectrum.spectrum_to_xyz(ld_new, lam, lam_pdf)
    ld_xyz = torch.where(torch.isfinite(ld_xyz), ld_xyz, 0.0)
    return SPPMState(r2=torch.where(has, r2_new, state.r2), n=torch.where(has, n_new, state.n),
                     tau=tau, ld=state.ld + ld_xyz, dropped=state.dropped + n_drop)


def develop(state: SPPMState, n_iterations: int, n_photons: int, height: int,
            width: int) -> torch.Tensor:
    """L = Ld / n_it + tau / (n_it Np pi r^2) -> (H, W, 3) linear sRGB."""
    n_it = float(n_iterations)
    indirect = state.tau / (n_it * n_photons * np.pi
                            * torch.clamp(state.r2, min=1e-20))[..., None]
    return xyz_to_linear_srgb(state.ld / n_it + indirect).reshape(height, width, 3)


def run_sppm(scene, dbvh, cam, n_iterations: int = 16, photons_per_iter: int | None = None,
             initial_radius: float | None = None, seed: int = 0,
             cfg: IntegratorConfig = IntegratorConfig(), alpha: float = 2.0 / 3.0,
             k_cap: int = 16, device=None, isect=None) -> SPPMState:
    """n_iterations SPPM iterations -> the final SPPMState (develop makes
    the image; `dropped` counts the photons the per-cell cap skipped).
    The initial radius defaults to 1.5% of the scene's diagonal; `isect`
    overrides the traversal backend."""
    device = resolve_device(device, scene)
    R = cam.width * cam.height
    P = photons_per_iter or R
    if initial_radius is None:
        b = np.asarray(scene_mod.host(scene.bounds), np.float32)
        initial_radius = 0.015 * float(np.linalg.norm(b[1] - b[0]))
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    st = make_state(R, initial_radius, device)
    for i in range(n_iterations):
        st = sppm_iteration(scene_d, None, cam, cfg, st, i, P, ls_tables, seed=seed,
                            alpha=alpha, k_cap=k_cap, isect=isect)
    return st


def render_sppm(scene, dbvh, cam, n_iterations: int = 16, photons_per_iter: int | None = None,
                initial_radius: float | None = None, seed: int = 0,
                cfg: IntegratorConfig = IntegratorConfig(), alpha: float = 2.0 / 3.0,
                k_cap: int = 16, device=None) -> torch.Tensor:
    """SPPMIntegrator::Render -> (H, W, 3) linear sRGB."""
    st = run_sppm(scene, dbvh, cam, n_iterations, photons_per_iter, initial_radius, seed, cfg,
                  alpha, k_cap, device)
    return develop(st, n_iterations, photons_per_iter or cam.width * cam.height, cam.height,
                   cam.width)
