"""Tabulated BSSRDF, photon beam diffusion (port of
nn_bvh_tpu/scatter/bssrdf.py).

- Host (numpy): `compute_beam_diffusion_table` builds, once per (g, eta) at
  scene build, the radial profiles r * Sr(rho, r) on an (N_RHO, N_RADIUS)
  grid at unit sigma_t, the effective albedo rho_eff(rho) and per-row CDFs
  for radius sampling. Same formulas and float64 order as the JAX package.
- Device (torch): `sr_eval`, `sr_sample`, `sr_pdf`, `r_max` per lane and
  wavelength on tables of tensors (a `BSSRDFTable` of the scene's sss_*
  rows, wavefront/subsurface.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

N_RHO = 64
N_RADIUS = 64


def _fresnel_moment1(eta: float) -> float:
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    if eta < 1:
        return (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
                + 2.49277 * e4 - 0.68441 * e5)
    return (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
            - 1.27198 * e4 + 0.12746 * e5)


def _fresnel_moment2(eta: float) -> float:
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    if eta < 1:
        return (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
                + 0.07883 * e4 + 0.04860 * e5)
    return (-547.033 + 45.3087 / e3 - 218.725 / e2 + 458.843 / eta + 404.557 * eta
            - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4 + 0.63942 * e5)


def _fr_dielectric(cos_i: np.ndarray, eta: float) -> np.ndarray:
    cos_i = np.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i ** 2) / eta ** 2
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t + 1e-12)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t + 1e-12)
    return np.where(tir, 1.0, 0.5 * (r_par ** 2 + r_perp ** 2))


def _beam_diffusion_ms_vec(sigma_s, sigma_a, g, eta, radii, n_samples=100):
    """Multiple scattering over all radii; depths importance-sampled with
    pdf sigtp * exp(-sigtp z)."""
    f_m1 = _fresnel_moment1(eta)
    f_m2 = _fresnel_moment2(eta)
    sigsp = sigma_s * (1.0 - g)
    sigtp = sigsp + sigma_a
    if sigtp <= 0:
        return np.zeros_like(radii)
    rhop = sigsp / sigtp
    d_g = (2.0 * sigma_a + sigsp) / (3.0 * sigtp ** 2)
    sigma_tr = np.sqrt(sigma_a / d_g)
    ze = -2.0 * d_g * (1.0 + 3.0 * f_m2) / (1.0 - 2.0 * f_m1)
    c_phi = 0.25 * (1.0 - 2.0 * f_m1)
    c_e = 0.5 * (1.0 - 3.0 * f_m2)
    r = radii[None, :]
    u = (np.arange(n_samples)[:, None] + 0.5) / n_samples
    zr = -np.log(1.0 - u) / sigtp
    zv = -zr + 2.0 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    phi_d = 1.0 / (4.0 * np.pi * d_g) * (
        np.exp(-sigma_tr * dr) / np.maximum(dr, 1e-9)
        - np.exp(-sigma_tr * dv) / np.maximum(dv, 1e-9))
    e_dn = 1.0 / (4.0 * np.pi) * (
        zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / np.maximum(dr, 1e-9) ** 3
        - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / np.maximum(dv, 1e-9) ** 3)
    kappa = 1.0 - np.exp(-2.0 * sigtp * (dr + zr))
    integrand = rhop * kappa * (c_phi * phi_d + c_e * e_dn)
    return integrand.mean(0) * rhop


def _beam_diffusion_ss(sigma_s, sigma_a, g, eta, radii, n_samples=100):
    """Single scattering along the refracted beam (HG phase at the vertex)."""
    sigt = sigma_s + sigma_a
    if sigt <= 0:
        return np.zeros_like(radii)
    rho = sigma_s / sigt
    t_crit = radii * np.sqrt(np.maximum(eta * eta - 1.0, 0.0))
    out = np.zeros_like(radii)
    u = (np.arange(n_samples) + 0.5) / n_samples
    for i, r in enumerate(radii):
        t = t_crit[i] - np.log(1.0 - u) / sigt
        d = np.sqrt(r * r + t * t)
        cos_theta_o = t / np.maximum(d, 1e-9)
        cos_seg = -cos_theta_o
        hg = (1.0 - g * g) / (4.0 * np.pi * (1.0 + g * g + 2.0 * g * cos_seg) ** 1.5)
        fr_exit = 1.0 - _fr_dielectric(cos_theta_o, 1.0 / eta)
        val = (rho * np.exp(-sigt * (d + t_crit[i])) / np.maximum(d * d, 1e-12)
               * hg * fr_exit * cos_theta_o)
        out[i] = val.mean()
    return out


class BSSRDFTable(NamedTuple):
    """Radial profiles over an albedo grid (float32; numpy from the
    builder, tensors on the device)."""
    rho: object       # (N_RHO,) single-scattering albedo grid
    radius: object    # (N_RADIUS,) in mean free paths (sigma_t = 1)
    profile: object   # (N_RHO, N_RADIUS) r * Sr
    cdf: object       # (N_RHO, N_RADIUS) per-row CDF of 2 pi r Sr
    rho_eff: object   # (N_RHO,) effective albedo per rho


def compute_beam_diffusion_table(g: float = 0.0, eta: float = 1.33,
                                 n_samples: int = 100) -> BSSRDFTable:
    """Unit-sigma_t profiles over a warped albedo grid -> BSSRDFTable of
    float32 numpy arrays (Sr scales as sigma_t^2 at eval)."""
    rho = 1.0 - np.exp(-8.0 * (np.arange(N_RHO) / (N_RHO - 1.0)) ** 3)
    radius = np.zeros(N_RADIUS)
    radius[1] = 0.0025
    for i in range(2, N_RADIUS):
        radius[i] = radius[i - 1] * 1.2
    prof = np.zeros((N_RHO, N_RADIUS), np.float64)
    for i, rh in enumerate(rho):
        prof[i] = radius * (_beam_diffusion_ms_vec(rh, 1.0 - rh, g, eta, radius, n_samples)
                            + _beam_diffusion_ss(rh, 1.0 - rh, g, eta, radius, n_samples))
    integ = 2.0 * np.pi * prof
    seg = 0.5 * (integ[:, 1:] + integ[:, :-1]) * np.diff(radius)[None, :]
    cdf = np.concatenate([np.zeros((N_RHO, 1)), np.cumsum(seg, -1)], -1)
    rho_eff = cdf[:, -1].copy()
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-12)
    f32 = lambda a: np.asarray(a, np.float32)
    return BSSRDFTable(rho=f32(rho), radius=f32(radius), profile=f32(prof), cdf=f32(cdf),
                       rho_eff=f32(rho_eff))


def _row_interp(table: BSSRDFTable, rho):
    """rho (...,) -> (row index, weight) along the albedo axis."""
    i = torch.searchsorted(table.rho, rho.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, N_RHO - 2)
    t = (rho - table.rho[i]) / torch.clamp(table.rho[i + 1] - table.rho[i], min=1e-9)
    return i, torch.clamp(t, 0.0, 1.0)


def sr_eval(table: BSSRDFTable, sigma_t, rho, r):
    """Sr(r) per lane and channel; sigma_t, rho and r broadcast together."""
    sigma_t, rho, r = torch.broadcast_tensors(sigma_t, rho, r)
    r_unit = r * sigma_t
    i, ti = _row_interp(table, rho)
    j = torch.searchsorted(table.radius, r_unit.contiguous(), right=True) - 1
    j = torch.clamp(j, 0, N_RADIUS - 2)
    tj = (r_unit - table.radius[j]) / torch.clamp(table.radius[j + 1] - table.radius[j],
                                                  min=1e-9)
    tj = torch.clamp(tj, 0.0, 1.0)
    at = lambda ii, jj: table.profile[ii, jj]
    v = ((1 - ti) * ((1 - tj) * at(i, j) + tj * at(i, j + 1))
         + ti * ((1 - tj) * at(i + 1, j) + tj * at(i + 1, j + 1)))
    # the table holds r * Sr at unit sigma_t: undo r, then Sr ~ sigma_t^2
    sr = torch.where(r_unit > 1e-6, v / torch.clamp(r_unit, min=1e-6), v / 1e-6)
    return torch.clamp(sr * sigma_t * sigma_t, min=0.0)


def sr_sample(table: BSSRDFTable, sigma_t, rho, u):
    """Inverse-CDF radius -> (r, area pdf 2 pi r Sr / rho_eff, rho_eff)."""
    i, ti = _row_interp(table, rho)
    cdf = (1 - ti[..., None]) * table.cdf[i] + ti[..., None] * table.cdf[i + 1]
    j = (cdf <= u[..., None]).to(torch.int64).sum(-1) - 1
    j = torch.clamp(j, 0, N_RADIUS - 2)
    c0 = torch.gather(cdf, -1, j[..., None])[..., 0]
    c1 = torch.gather(cdf, -1, (j + 1)[..., None])[..., 0]
    tt = (u - c0) / torch.clamp(c1 - c0, min=1e-9)
    r_unit = table.radius[j] + tt * (table.radius[j + 1] - table.radius[j])
    r = r_unit / torch.clamp(sigma_t, min=1e-9)
    sr = sr_eval(table, sigma_t, rho, r)
    rho_eff = (1 - ti) * table.rho_eff[i] + ti * table.rho_eff[i + 1]
    pdf = sr * 2.0 * math.pi * r / torch.clamp(rho_eff, min=1e-9)
    return r, torch.clamp(pdf, min=0.0), rho_eff


def sr_pdf(table: BSSRDFTable, sigma_t, rho, r):
    """Area pdf of sr_sample at radius r."""
    i, ti = _row_interp(table, rho)
    rho_eff = (1 - ti) * table.rho_eff[i] + ti * table.rho_eff[i + 1]
    sr = sr_eval(table, sigma_t, rho, r)
    return sr * 2.0 * math.pi * r / torch.clamp(rho_eff, min=1e-9)


def r_max(table: BSSRDFTable, sigma_t, rho):
    """Radius beyond which the profile is negligible."""
    return table.radius[-1] / torch.clamp(sigma_t, min=1e-9)
