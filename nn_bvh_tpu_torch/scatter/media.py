"""Participating media: point-wise properties, the Henyey-Greenstein phase
function and the per-lane majorant DDA (port of nn_bvh_tpu/scatter/media.py).

Homogeneous and grid media. A grid medium walks its low-res majorant grid
(`dda_init` / `dda_advance`): every lane steps its own supervoxel with
masked selects, so each lane uses a locally tight majorant while the batch
stays one set of tensor ops. Homogeneous media use one conservative
majorant. Every function is a plain function on (R,)-batched tensors, built
from the scene tensors so autograd can reach the medium coefficients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import vecmath as vm, sampling, rgb2spec, spectrum
from ..geometry import scene as scene_mod

INV_4PI = sampling.INV_4PI
_I32_LIMIT = float(2 ** 30)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 by truncation, saturating as XLA's conversion does (a
    lane far outside a grid must clip to its edge, never wrap)."""
    return torch.clamp(x, -_I32_LIMIT, _I32_LIMIT).to(torch.int32)


class MediumCtx(NamedTuple):
    """Per-lane medium record, spectrally expanded at the sampled
    wavelengths. sigma_a / sigma_s are the base coefficients (times the
    local density for point properties); sigma_maj is the majorant
    (sigma_a + sigma_s) * max_density."""

    med_type: torch.Tensor   # (...,) i32
    sigma_a: torch.Tensor    # (..., 4)
    sigma_s: torch.Tensor    # (..., 4)
    le: torch.Tensor         # (..., 4) emitted radiance spectrum (0 if none)
    g: torch.Tensor          # (...,) HG asymmetry
    grid_id: torch.Tensor    # (...,) i32
    blo: torch.Tensor        # (..., 3) grid world bounds
    bhi: torch.Tensor        # (..., 3)
    sigma_maj: torch.Tensor  # (..., 4) spectral majorant
    valid: torch.Tensor      # (...,) med id >= 0
    temp_grid_id: torch.Tensor | None = None  # (...,) i32 blackbody grid (-1 = RGB
    #   Le); None when the scene has no temperature grid


def medium_records(scene) -> torch.Tensor:
    """(K, 23) fused medium table: [0 type | 1:4 sa coeffs | 4:7 ss coeffs |
    7:10 le coeffs | 10:14 scales (sa, ss, le, g) | 14 grid_id |
    15 max_density | 16:19 blo | 19:22 bhi | 22 temp_grid_id]."""
    tg = scene.med_temp_grid_id
    if tg is None or tg.shape[0] != scene.med_type.shape[0]:
        tg = torch.full_like(scene.med_type, -1)
    return torch.cat([
        scene.med_type[:, None].to(torch.float32), scene.med_sa_coeffs,
        scene.med_ss_coeffs, scene.med_le_coeffs, scene.med_scales,
        scene.med_grid_id[:, None].to(torch.float32), scene.med_max_density[:, None],
        scene.med_bounds.reshape(-1, 6), tg[:, None].to(torch.float32)], -1)


def gather_medium(scene, med_id, lam, med_all=None) -> MediumCtx:
    """Per-lane medium parameters at the sampled wavelengths (one gather)."""
    if med_all is None:
        med_all = medium_records(scene)
    rec = med_all[torch.clamp(med_id, min=0).long()]
    sa = rgb2spec.eval_sigmoid_poly(rec[..., 1:4], lam) * rec[..., 10:11]
    ss = rgb2spec.eval_sigmoid_poly(rec[..., 4:7], lam) * rec[..., 11:12]
    le = rgb2spec.eval_sigmoid_poly(rec[..., 7:10], lam) * rec[..., 12:13]
    has_temp = scene.med_temp_grids is not None and scene.med_temp_grids.numel() > 1
    return MediumCtx(
        med_type=rec[..., 0].to(torch.int32), sigma_a=sa, sigma_s=ss, le=le,
        g=rec[..., 13], grid_id=rec[..., 14].to(torch.int32),
        blo=rec[..., 16:19], bhi=rec[..., 19:22],
        sigma_maj=torch.clamp((sa + ss) * rec[..., 15:16], min=1e-20),
        valid=med_id >= 0,
        temp_grid_id=rec[..., 22].to(torch.int32) if has_temp else None)


def _trilerp_grid(grids, gi, ctx: MediumCtx, p):
    """Trilinear lookup of a (G, D, H, W) grid stack at world point p inside
    ctx's bounds (samples at voxel centres) -> (value, in_bounds)."""
    g_, d_, h_, w_ = grids.shape
    ext = torch.clamp(ctx.bhi - ctx.blo, min=1e-20)
    gp = (p - ctx.blo) / ext
    inb = ((gp >= 0.0) & (gp <= 1.0)).all(-1)
    px = gp[..., 0] * w_ - 0.5
    py = gp[..., 1] * h_ - 0.5
    pz = gp[..., 2] * d_ - 0.5
    x0, y0, z0 = (_to_i32(torch.floor(c)) for c in (px, py, pz))
    fx, fy, fz = px - x0, py - y0, pz - z0
    gi = torch.clamp(gi, 0, g_ - 1).long()

    def at(zi, yi, xi):
        return grids[gi, torch.clamp(zi, 0, d_ - 1).long(), torch.clamp(yi, 0, h_ - 1).long(),
                     torch.clamp(xi, 0, w_ - 1).long()]

    d00 = vm.lerp(fx, at(z0, y0, x0), at(z0, y0, x0 + 1))
    d10 = vm.lerp(fx, at(z0, y0 + 1, x0), at(z0, y0 + 1, x0 + 1))
    d01 = vm.lerp(fx, at(z0 + 1, y0, x0), at(z0 + 1, y0, x0 + 1))
    d11 = vm.lerp(fx, at(z0 + 1, y0 + 1, x0), at(z0 + 1, y0 + 1, x0 + 1))
    return vm.lerp(fz, vm.lerp(fy, d00, d10), vm.lerp(fy, d01, d11)), inb


def density(scene, ctx: MediumCtx, p) -> torch.Tensor:
    """Local density at world point p: 1 for homogeneous media, the
    trilinear grid value for grid media (0 outside the grid's bounds)."""
    if scene.n_media == 0:
        return torch.ones(p.shape[:-1], dtype=torch.float32, device=p.device)
    dens, inb = _trilerp_grid(scene.med_grids, ctx.grid_id, ctx, p)
    is_grid = ctx.med_type == scene_mod.MED_GRID
    return torch.where(is_grid, torch.where(inb, dens, 0.0), 1.0)


def blackbody_normalized(lam, T) -> torch.Tensor:
    """Blackbody radiance at per-lane temperatures T (..., 1), scaled so its
    peak is 1 (spectrum.blackbody_normalized for a tensor of temperatures:
    the peak is evaluated in float64, as the scalar version does)."""
    lam_max = 2.8977721e-3 / T.double() * 1e9
    peak = spectrum.blackbody(lam_max, T.double()).to(torch.float32)
    return spectrum.blackbody(lam, T) / peak


def le_at(scene, ctx: MediumCtx, p, lam) -> torch.Tensor:
    """Emitted radiance spectrum at p: the medium's RGB Le, or, with a
    temperature grid, blackbody radiance at the local temperature times the
    Le scale (the builder stores Le = (1, 1, 1) there, so ctx.le is the
    flat scale)."""
    if ctx.temp_grid_id is None:
        return ctx.le
    T, inb = _trilerp_grid(scene.med_temp_grids, ctx.temp_grid_id, ctx, p)
    bb = blackbody_normalized(lam, torch.clamp(T[..., None], min=1.0))
    use_bb = (ctx.temp_grid_id >= 0) & inb & (T > 60.0)
    return torch.where(use_bb[..., None], ctx.le * bb, ctx.le)


def segment_bounds(ctx: MediumCtx, o, d, t_hit):
    """Clip the medium segment [0, t_hit] to the density grid's box for grid
    media (homogeneous media fill their enclosing geometry) -> (t0, t1)."""
    inv_d = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    ta = (ctx.blo - o) * inv_d
    tb = (ctx.bhi - o) * inv_d
    tmin = torch.minimum(ta, tb).amax(-1)
    tmax = torch.maximum(ta, tb).amin(-1)
    is_grid = ctx.med_type == scene_mod.MED_GRID
    clip = lambda t: torch.minimum(torch.clamp(t, min=0.0), t_hit)
    t0 = torch.where(is_grid, clip(tmin), 0.0)
    t1 = torch.where(is_grid, clip(tmax), t_hit)
    return t0, torch.maximum(t1, t0)


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def hg_p(cos_theta, g) -> torch.Tensor:
    g = torch.clamp(g, -0.99, 0.99)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(denom * vm.safe_sqrt(denom), min=1e-12)


def phase_p(wo, wi, g) -> torch.Tensor:
    """p(wo, wi), the HG cosine taken as Dot(wo, wi) (pbrt's convention)."""
    return hg_p(vm.dot(wo, wi), g)


def phase_sample(wo, u2, g):
    """Sample_p -> (wi, pdf), pdf == p (perfect importance sampling)."""
    g = torch.clamp(g, -0.99, 0.99)
    iso = g.abs() < 1e-3
    u0 = u2[..., 0]
    cos_iso = 1.0 - 2.0 * u0
    sq = (1.0 - g * g) / torch.clamp(1.0 + g - 2.0 * g * u0, min=1e-9)
    two_g = torch.where(g.abs() < 1e-9, 1e-9, 2.0 * g)
    cos_hg = -(1.0 + g * g - sq * sq) / two_g
    cos_t = torch.where(iso, cos_iso, torch.clamp(cos_hg, -1.0, 1.0))
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * torch.pi * u2[..., 1]
    t1, t2 = vm.coordinate_system(wo)
    wi = ((sin_t * torch.cos(phi))[..., None] * t1 + (sin_t * torch.sin(phi))[..., None] * t2
          + cos_t[..., None] * wo)
    return wi, hg_p(cos_t, g)


# ---------------------------------------------------------------------------
# per-lane DDA over the low-res majorant grid
# ---------------------------------------------------------------------------

class DDAState(NamedTuple):
    voxel: torch.Tensor       # (..., 3) i32 current supervoxel
    next_cross: torch.Tensor  # (..., 3) t of the next crossing per axis
    step: torch.Tensor        # (..., 3) i32 +-1
    delta: torch.Tensor       # (..., 3) t per voxel step
    seg_end: torch.Tensor     # (...,) end of the current majorant segment
    maj_dens: torch.Tensor    # (...,) local majorant density (supervoxel max)


def _maj_lookup(scene, ctx: MediumCtx, voxel) -> torch.Tensor:
    """Majorant density of a supervoxel; 1 on homogeneous lanes (their
    max_density is folded into sigma_maj)."""
    maj = scene.med_maj_grids
    g_, mz, my, mx = maj.shape
    gi = torch.clamp(ctx.grid_id, 0, g_ - 1).long()
    v = maj[gi, torch.clamp(voxel[..., 2], 0, mz - 1).long(),
            torch.clamp(voxel[..., 1], 0, my - 1).long(),
            torch.clamp(voxel[..., 0], 0, mx - 1).long()]
    return torch.where(ctx.med_type == scene_mod.MED_GRID, v, 1.0)


def dda_init(scene, ctx: MediumCtx, o, d, t0, t1) -> DDAState:
    """The majorant DDA at ray parameter t0. Homogeneous lanes get the one
    segment [t0, t1] with maj_dens 1."""
    res = scene.med_maj_grids.shape[1]
    ext = torch.clamp(ctx.bhi - ctx.blo, min=1e-20)
    og = (o - ctx.blo) / ext
    dg = d / ext
    p_ent = og + t0[..., None] * dg
    voxel = torch.clamp(_to_i32(p_ent * res), 0, res - 1)
    d_safe = torch.where(dg.abs() < 1e-12, 1e-12, dg)
    pos_dir = d_safe >= 0
    step = torch.where(pos_dir, 1, -1).to(torch.int32)
    next_vox_pos = torch.where(pos_dir, (voxel + 1).to(torch.float32),
                               voxel.to(torch.float32)) / res
    next_cross = t0[..., None] + (next_vox_pos - p_ent) / d_safe
    delta = 1.0 / (d_safe.abs() * res)
    is_grid = ctx.med_type == scene_mod.MED_GRID
    next_cross = torch.where(is_grid[..., None], next_cross, 1e30)
    seg_end = torch.where(is_grid, torch.minimum(next_cross.amin(-1), t1), t1)
    return DDAState(voxel=voxel, next_cross=next_cross, step=step, delta=delta,
                    seg_end=seg_end, maj_dens=_maj_lookup(scene, ctx, voxel))


def dda_advance(scene, ctx: MediumCtx, st: DDAState, t1, active) -> DDAState:
    """Advance the active lanes to their next supervoxel; the others keep
    their state."""
    axis = torch.argmin(st.next_cross, -1)
    onehot = F.one_hot(axis, 3).to(torch.int32)
    act = active[..., None]
    voxel = st.voxel + torch.where(act, onehot * st.step, 0)
    next_cross = st.next_cross + torch.where(act, onehot.to(torch.float32) * st.delta, 0.0)
    seg_end = torch.where(active, torch.minimum(next_cross.amin(-1), t1), st.seg_end)
    maj = _maj_lookup(scene, ctx, voxel)
    return DDAState(voxel=voxel, next_cross=next_cross, step=st.step, delta=st.delta,
                    seg_end=seg_end, maj_dens=torch.where(active, maj, st.maj_dens))
