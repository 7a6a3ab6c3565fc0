"""Marschner-model hair BSDF (port of nn_bvh_tpu/scatter/hair.py).

Lobes p = 0 (R), 1 (TT), 2 (TRT) and a residual p >= 3 lobe:
  f = sum_p Mp(theta_o, theta_i; v_p) Ap[p] Np(phi; s) / |cos theta_i|
The fiber axis is the local x axis of the shading frame (sin theta = w.x);
`h` in [-1, 1] is the ray's offset across the fiber width. Every function
is torch over lanes and differentiable in sigma_a, beta_m and beta_n.

Float32 as in the JAX package: `_i0` sums its first ten series terms in
float32 (the factorial squares are Python numbers, rounded to float32 where
they meet a tensor), and `_log_i0` switches to the asymptotic form above
x = 12.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import vecmath as vm

P_MAX = 3
SQRT_PI_OVER_8 = float(np.sqrt(np.pi / 8.0))


def _i0(x):
    """Modified Bessel I0 from its first 10 series terms."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (4.0 ** i) / (ifact * ifact)
        x2i = x2i * x * x
    return val


def _log_i0(x):
    big = x > 12.0
    xs = torch.clamp(x, min=1e-6)
    approx = xs + 0.5 * (-math.log(2.0 * math.pi) + torch.log(1.0 / xs) + 1.0 / (8.0 * xs))
    return torch.where(big, approx, torch.log(torch.clamp(_i0(x), min=1e-30)))


def mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering function Mp."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    m_small = torch.exp(_log_i0(a) - b - 1.0 / torch.clamp(v, min=1e-9) + 0.6931
                        + torch.log(1.0 / (2.0 * torch.clamp(v, min=1e-9))))
    sinh = torch.sinh(1.0 / torch.clamp(v, min=1e-4))
    m_big = (torch.exp(-b) * _i0(a)) / (2.0 * v * torch.clamp(sinh, min=1e-30))
    return torch.where(small, m_small, m_big)


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a: float, b: float):
    return _logistic(x, s) / (_logistic_cdf(torch.full_like(x, b), s)
                              - _logistic_cdf(torch.full_like(x, a), s))


def _sample_trimmed_logistic(u, s, a: float, b: float):
    k = _logistic_cdf(torch.full_like(u, b), s) - _logistic_cdf(torch.full_like(u, a), s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(torch.full_like(u, a), s),
                                         min=1e-9) - 1.0)
    return torch.clamp(x, a, b)


def _phi_p(p: int, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * np.pi


def np_(p: int, phi, s, gamma_o, gamma_t):
    """Azimuthal scattering Np: a trimmed logistic around lobe p's
    specular azimuth."""
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + np.pi, 2.0 * np.pi) - np.pi
    return _trimmed_logistic(dphi, s, -np.pi, np.pi)


def _fr_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = vm.safe_sqrt(1.0 - sin2_t)
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-9)
    r_per = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-9)
    return torch.where(tir, 1.0, 0.5 * (r_par ** 2 + r_per ** 2))


def ap(cos_to, eta, h, transmittance):
    """Attenuation per lobe -> (..., P_MAX+1, S)."""
    cos_go = vm.safe_sqrt(1.0 - h * h)
    cos_t = cos_to * cos_go
    f = _fr_dielectric(cos_t, eta)[..., None]
    T = transmittance
    a0 = f.expand(T.shape)
    a1 = (1.0 - f) ** 2 * T
    a2 = a1 * T * f
    a_rest = a2 * f * T / torch.clamp(1.0 - T * f, min=1e-4)
    return torch.stack([a0, a1, a2, a_rest], -2)


def _derived(beta_m, beta_n):
    """(v per lobe (..., P_MAX+1), logistic scale s) from the roughnesses."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    v = torch.clamp(torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], -1), min=1e-5)
    s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2 + 5.372 * beta_n ** 22)
    return v, torch.clamp(s, min=1e-4)


# scale tilt: lobe p is rotated by 2^k alpha (alpha = 2 degrees)
_ALPHA = np.deg2rad(2.0)
_SIN_2K = [np.sin(_ALPHA), None, None]
_SIN_2K[1] = 2 * _SIN_2K[0] * np.cos(_ALPHA)
_COS_2K = [np.cos(_ALPHA), np.cos(_ALPHA) ** 2 - _SIN_2K[0] ** 2, None]
_SIN_2K[2] = 2 * _SIN_2K[1] * _COS_2K[1]
_COS_2K[2] = _COS_2K[1] ** 2 - _SIN_2K[1] ** 2


def _tilted(p: int, sin_to, cos_to):
    if p == 0:
        s, c = _SIN_2K[1], _COS_2K[1]
        return sin_to * c - cos_to * s, cos_to * c + sin_to * s
    if p == 1:
        s, c = _SIN_2K[0], _COS_2K[0]
        return sin_to * c + cos_to * s, cos_to * c - sin_to * s
    if p == 2:
        s, c = _SIN_2K[2], _COS_2K[2]
        return sin_to * c + cos_to * s, cos_to * c - sin_to * s
    return sin_to, cos_to


def _geom(wo, wi, h, eta, sigma_a):
    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = vm.safe_sqrt(1.0 - sin_to ** 2)
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    sin_ti = torch.clamp(wi[..., 0], -1.0, 1.0)
    cos_ti = vm.safe_sqrt(1.0 - sin_ti ** 2)
    phi_i = torch.atan2(wi[..., 2], wi[..., 1])
    sin_tt = sin_to / eta
    cos_tt = vm.safe_sqrt(1.0 - sin_tt ** 2)
    etap = vm.safe_sqrt(eta * eta - sin_to ** 2) / torch.clamp(cos_to, min=1e-6)
    sin_gt = torch.clamp(h / torch.clamp(etap, min=1e-6), -1.0, 1.0)
    cos_gt = vm.safe_sqrt(1.0 - sin_gt ** 2)
    gamma_t = torch.asin(sin_gt)
    gamma_o = torch.asin(torch.clamp(h, -1.0, 1.0))
    T = torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-5))[..., None])
    return sin_to, cos_to, sin_ti, cos_ti, gamma_o, gamma_t, T, phi_i - phi_o


def f(wo, wi, h, eta, sigma_a, beta_m, beta_n):
    """Hair BSDF value (..., S); wo and wi in the fiber frame (x = axis)."""
    sin_to, cos_to, sin_ti, cos_ti, gamma_o, gamma_t, T, phi = _geom(wo, wi, h, eta, sigma_a)
    v, s = _derived(beta_m, beta_n)
    a = ap(cos_to, eta, h, T)
    fsum = torch.zeros_like(T)
    for p in range(P_MAX):
        sin_tp, cos_tp = _tilted(p, sin_to, cos_to)
        m = mp(cos_ti, cos_tp.abs(), sin_ti, sin_tp, v[..., p])
        n = np_(p, phi, s, gamma_o, gamma_t)
        fsum = fsum + (m * n)[..., None] * a[..., p, :]
    m_rest = mp(cos_ti, cos_to, sin_ti, sin_to, v[..., P_MAX])
    fsum = fsum + (m_rest / (2.0 * np.pi))[..., None] * a[..., P_MAX, :]
    abs_ci = vm.abs_cos_theta(wi)
    return torch.where(abs_ci[..., None] > 1e-6,
                       fsum / torch.clamp(abs_ci, min=1e-6)[..., None], 0.0)


def _ap_pdf(cos_to, eta, h, T):
    """Lobe selection pdf from the mean attenuation -> (..., P_MAX+1)."""
    a = ap(cos_to, eta, h, T).mean(-1)
    return a / torch.clamp(a.sum(-1, keepdim=True), min=1e-9)


def pdf(wo, wi, h, eta, sigma_a, beta_m, beta_n):
    sin_to, cos_to, sin_ti, cos_ti, gamma_o, gamma_t, T, phi = _geom(wo, wi, h, eta, sigma_a)
    v, s = _derived(beta_m, beta_n)
    apdf = _ap_pdf(cos_to, eta, h, T)
    out = torch.zeros_like(phi)
    for p in range(P_MAX):
        sin_tp, cos_tp = _tilted(p, sin_to, cos_to)
        out = out + (apdf[..., p] * mp(cos_ti, cos_tp.abs(), sin_ti, sin_tp, v[..., p])
                     * np_(p, phi, s, gamma_o, gamma_t))
    out = out + (apdf[..., P_MAX] * mp(cos_ti, cos_to, sin_ti, sin_to, v[..., P_MAX])
                 / (2.0 * np.pi))
    return out


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def sample_f(wo, h, eta, sigma_a, beta_m, beta_n, uc, u2):
    """Importance-sample the hair BSDF -> (wi, f (..., S), pdf). uc picks
    the lobe and, remapped within the lobe's interval, drives the azimuthal
    sample; u2 the longitudinal one."""
    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = vm.safe_sqrt(1.0 - sin_to ** 2)
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    etap = vm.safe_sqrt(eta * eta - sin_to ** 2) / torch.clamp(cos_to, min=1e-6)
    sin_gt = torch.clamp(h / torch.clamp(etap, min=1e-6), -1.0, 1.0)
    gamma_t = torch.asin(sin_gt)
    gamma_o = torch.asin(torch.clamp(h, -1.0, 1.0))
    sin_tt = sin_to / eta
    cos_tt = vm.safe_sqrt(1.0 - sin_tt ** 2)
    cos_gt = vm.safe_sqrt(1.0 - sin_gt ** 2)
    T = torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-5))[..., None])

    v, s = _derived(beta_m, beta_n)
    apdf = _ap_pdf(cos_to, eta, h, T)

    # lobe by inverting the discrete CDF, uc remapped into the lobe
    c0 = apdf[..., 0]
    c1 = c0 + apdf[..., 1]
    c2 = c1 + apdf[..., 2]
    p_sel = ((uc >= c0).to(torch.int64) + (uc >= c1).to(torch.int64)
             + (uc >= c2).to(torch.int64))
    lo = torch.stack([torch.zeros_like(c0), c0, c1, c2], -1)
    w = _take(apdf, p_sel)
    u_lob = torch.clamp((uc - _take(lo, p_sel)) / torch.clamp(w, min=1e-9), 0.0, 0.9999)

    tilts = [_tilted(p, sin_to, cos_to) for p in range(P_MAX)] + [(sin_to, cos_to)]
    sin_top = _take(torch.stack([t[0] for t in tilts], -1), p_sel)
    cos_top = _take(torch.stack([t[1] for t in tilts], -1).abs(), p_sel)
    vp = _take(v, p_sel)

    # Mp by the d'Eon et al. inversion
    u0 = torch.clamp(u2[..., 0], min=1e-5)
    cos_theta = 1.0 + vp * torch.log(u0 + (1.0 - u0) * torch.exp(-2.0 / vp))
    sin_theta = vm.safe_sqrt(1.0 - cos_theta ** 2)
    cos_phi_m = torch.cos(2.0 * np.pi * u2[..., 1])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_m * cos_top
    cos_ti = vm.safe_sqrt(1.0 - sin_ti ** 2)

    # Np: trimmed logistic for p < P_MAX, uniform for the rest, from u_lob
    dphi_log = _phi_p(0, gamma_o, gamma_t) * 0.0 + _sample_trimmed_logistic(
        u_lob, s, -np.pi, np.pi)
    phi_base = torch.stack([_phi_p(p, gamma_o, gamma_t) for p in range(P_MAX)]
                           + [torch.zeros_like(gamma_o)], -1)
    dphi = torch.where(p_sel < P_MAX, _take(phi_base, p_sel) + dphi_log,
                       2.0 * np.pi * u_lob - np.pi)
    phi_i = phi_o + dphi
    # the sampled direction carries no gradient (the JAX package's does,
    # through u_lob's lobe weight, a function of sigma_a): a direction that
    # depends on a coefficient makes every later bounce's direction math
    # differentiable, and a lane on the z axis there (sqrt(0) in sin_theta)
    # turns 0 * inf into NaN for the coefficients; f and pdf at wi keep theirs
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i), cos_ti * torch.sin(phi_i)], -1).detach()
    return (wi, f(wo, wi, h, eta, sigma_a, beta_m, beta_n),
            pdf(wo, wi, h, eta, sigma_a, beta_m, beta_n))


def sigma_a_from_reflectance(refl, beta_n):
    """Chiang et al. 2016: absorption from the desired albedo."""
    r = torch.clamp(refl, 1e-4, 0.9999)
    denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2 - 10.73 * beta_n ** 3
             + 5.574 * beta_n ** 4 + 0.245 * beta_n ** 5)
    return (torch.log(r) / denom[..., None]) ** 2
