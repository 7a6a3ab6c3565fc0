"""Metropolis light transport, MLT (port of nn_bvh_tpu/wavefront/mlt.py).

Primary-sample-space Metropolis (Kelemen et al.) over the Path wave: C
Markov chains run as dense lanes, each chain's state a u-vector of
D = DIM_PATH_BASE + max_depth * DIMS_PER_DEPTH values that drives
integrator.trace_wave through the TABLE sampler (the pixel position, the
wavelengths and every bounce decision live in u). As in the JAX package
the target is the unidirectional MIS path tracer, not pbrt's BDPT.

A bootstrap of n_bootstrap_batches batches of C fresh u-vectors estimates
b = E[y] (y the luminance) and keeps each lane's brightest start; one
categorical draw per chain, proportional to y, picks the chains' starts
(searchsorted on the left over the normalized cdf, as jnp.searchsorted).
Then K mutation steps, a host loop (JAX's lax.scan): a large step
(probability p_large) or a small exponential perturbation of every
dimension, expected-value splats a / y' and (1 - a) / y of both states
into an XYZ buffer, and acceptance with probability a. The film is b R / (K
C) times the splats. Each chain's index is its lane's sample index, so the
wave's re-sort on the card must carry the per-lane sample index with the
lane (integrator.trace_wave does).
"""

from __future__ import annotations

import math

import torch

from ..accel import dispatch
from ..core import rng, samplers, spectrum
from ..devices import resolve_device
from ..geometry import scene as scene_mod
from ..scatter import lightsamplers
from . import film as film_mod
from .integrator import DIM_PATH_BASE, DIMS_PER_DEPTH, IntegratorConfig, trace_wave


def _n_dims(cfg: IntegratorConfig) -> int:
    return DIM_PATH_BASE + cfg.max_depth * DIMS_PER_DEPTH


def chain_counts(spp: int, n_pixels: int, n_chains: int = 4096,
                 n_bootstrap_batches: int = 4) -> tuple:
    """(chains C, mutation steps K, bootstrap batches) of render_mlt: at
    least 8 steps a chain, K C ~ spp pixels mutations, and a bootstrap of at
    least 32,768 samples."""
    C = min(n_chains, max(256, (spp * n_pixels) // 8))
    K = max(8, (spp * n_pixels) // C)
    return C, K, max(n_bootstrap_batches, 32768 // C + 1)


def trace_table(scene, cam, cfg: IntegratorConfig, u, seed: int, spp: int, ls_tables, isect):
    """One trace of C chains' u-vectors u (C, D) through the Path wave ->
    (pixel (C,) int32, XYZ (C, 3), luminance y (C,)): u[:, 0:2] picks the
    pixel and, less its integer part, the position in it; lane i draws row
    i of the TABLE sampler (its sample index). `scene` holds tensors."""
    W, H = cam.width, cam.height
    lane = torch.arange(u.shape[0], dtype=torch.int32, device=u.device)
    px, py = u[:, 0] * W, u[:, 1] * H
    ix = torch.clamp(px.to(torch.int64), 0, W - 1)
    iy = torch.clamp(py.to(torch.int64), 0, H - 1)
    pix = (iy * W + ix).to(torch.int32)
    table = torch.cat([(px - ix)[:, None], (py - iy)[:, None], u[:, 2:]], 1)
    scfg = samplers.SamplerConfig(samplers.TABLE, seed, spp, W, table=table)
    L, lam, lam_pdf, _ = trace_wave(scene, None, cam, scfg, cfg, pix, lane, ls_tables, isect)
    xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    xyz = torch.where(torch.isfinite(xyz), xyz, 0.0)
    return pix, xyz, torch.clamp(xyz[:, 1], min=0.0)


def render_mlt(scene, dbvh, cam, spp: int = 16, seed: int = 0,
               cfg: IntegratorConfig = IntegratorConfig(), n_chains: int = 4096,
               n_bootstrap_batches: int = 4, p_large: float = 0.3,
               sigma_min: float = 1.0 / 1024.0, sigma_max: float = 1.0 / 64.0, device=None,
               isect=None) -> torch.Tensor:
    """MLT render -> (H, W, 3) linear sRGB. `isect` overrides the traversal
    backend (tests, comparisons)."""
    device = resolve_device(device, scene)
    W, H = cam.width, cam.height
    R = W * H
    C, K, n_boot = chain_counts(spp, R, n_chains, n_bootstrap_batches)
    D = _n_dims(cfg)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    lane = torch.arange(C, dtype=torch.int32, device=device)
    dims = torch.arange(D, dtype=torch.int32, device=device)

    def fresh(step: int, salt: int):
        return rng.hash_float(lane[:, None], dims[None, :], step, seed, salt)

    def chain_rand(step: int, salt: int):
        return rng.hash_float(lane, step, seed, salt)

    def trace_u(u):
        return trace_table(scene_d, cam, cfg, u, seed, spp, ls_tables, isect)

    # bootstrap: b = E[y]; each lane keeps its brightest start
    b_sum = 0.0
    best = None
    for i in range(n_boot):
        u0 = fresh(1000 + i, 11)
        pix0, xyz0, y0 = trace_u(u0)
        b_sum += float(y0.mean())
        if best is None:
            best = [u0, y0, pix0, xyz0]
        else:
            take = y0 > best[1]
            best = [torch.where(take[:, None], u0, best[0]), torch.where(take, y0, best[1]),
                    torch.where(take, pix0, best[2]), torch.where(take[:, None], xyz0, best[3])]
    b = b_sum / n_boot
    # one categorical draw per chain, proportional to y: dead (y = 0)
    # starts are never drawn
    cdf = torch.cumsum(best[1], 0)
    tot = torch.clamp(cdf[-1], min=1e-12)
    pick = torch.clamp(torch.searchsorted(cdf / tot, chain_rand(0, 13)), 0, C - 1)
    u, y, pix, xyz = best[0][pick], torch.clamp(best[1][pick], min=1e-12), best[2][pick], \
        best[3][pick]

    log_ratio = -math.log(sigma_max / sigma_min)
    splat = torch.zeros(R, 3, dtype=torch.float32, device=device)
    for k in range(1, K + 1):
        # proposal: Kelemen's small exponential step, or a large step
        u_l = fresh(k, 17)
        eps = sigma_max * torch.exp(log_ratio * fresh(k, 19))
        u_s = u + torch.where(fresh(k, 23) < 0.5, 1.0, -1.0) * eps
        u_s = u_s - torch.floor(u_s)  # wrap to [0, 1)
        u_p = torch.where((chain_rand(k, 29) < p_large)[:, None], u_l, u_s)
        pix_p, xyz_p, y_p = trace_u(u_p)
        a = torch.clamp(y_p / y, 0.0, 1.0)
        # expected-value splats of the proposal and the current state
        splat = splat.index_put((pix_p.long(),),
                                (a / torch.clamp(y_p, min=1e-12))[:, None] * xyz_p,
                                accumulate=True)
        splat = splat.index_put((pix.long(),), ((1.0 - a) / y)[:, None] * xyz, accumulate=True)
        acc = chain_rand(k, 31) < a
        u = torch.where(acc[:, None], u_p, u)
        y = torch.clamp(torch.where(acc, y_p, y), min=1e-12)
        pix = torch.where(acc, pix_p, pix)
        xyz = torch.where(acc[:, None], xyz_p, xyz)

    # I_p = b R E_pi[C_p(u) / y(u)] over the K C mutations
    film = film_mod.make_film(H, W, device)._replace(splat_xyz=splat)
    return film_mod.develop(film, splat_scale=b * R / (K * C))
