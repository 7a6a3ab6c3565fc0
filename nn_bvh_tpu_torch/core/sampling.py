"""Sampling warps, MIS heuristics and piecewise-constant distributions
(port of the parts of nn_bvh_tpu/core/sampling.py the port's integrators
and filters use)."""

from __future__ import annotations

import math

import torch

from . import vecmath as vm

Tensor = torch.Tensor

INV_PI = 0.31830988618379067154
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
UNIFORM_SPHERE_PDF = INV_4PI


def power_heuristic(nf, f_pdf, ng, g_pdf) -> Tensor:
    f = torch.clamp(nf * f_pdf, max=1e18)
    g = torch.clamp(ng * g_pdf, max=1e18)
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def sample_uniform_disk_concentric(u: Tensor) -> Tensor:
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (oy / torch.where(ox == 0, 1.0, ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / torch.where(oy == 0, 1.0, oy)))
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, p)


def sample_cosine_hemisphere(u: Tensor) -> Tensor:
    d = sample_uniform_disk_concentric(u)
    z = vm.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def cosine_hemisphere_pdf(cos_theta: Tensor) -> Tensor:
    return cos_theta * INV_PI


def sample_uniform_sphere(u: Tensor) -> Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = vm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def sample_uniform_triangle(u: Tensor) -> Tensor:
    flip = u[..., 0] < u[..., 1]
    b0 = torch.where(flip, u[..., 0] / 2.0, u[..., 0] - u[..., 1] / 2.0)
    b1 = torch.where(flip, u[..., 1] - b0, u[..., 1] / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], -1)


def sample_spherical_triangle(v0, v1, v2, p, u):
    """Solid-angle (Arvo) sampling of triangle (v0,v1,v2) from p. Returns
    (barycentrics (...,3), pdf = 1/solid_angle, degenerate)."""
    a = vm.normalize(v0 - p)
    b = vm.normalize(v1 - p)
    c = vm.normalize(v2 - p)
    n_ab = vm.normalize(vm.cross(a, b))
    n_bc = vm.normalize(vm.cross(b, c))
    n_ca = vm.normalize(vm.cross(c, a))
    alpha = vm.safe_acos(vm.dot(n_ab, -n_ca))
    beta = vm.safe_acos(vm.dot(n_bc, -n_ab))
    gamma = vm.safe_acos(vm.dot(n_ca, -n_bc))
    A_full = alpha + beta + gamma - math.pi
    pdf = 1.0 / torch.clamp(A_full, min=1e-12)

    Ap = u[..., 0] * A_full
    cos_alpha = torch.cos(alpha)
    sin_alpha = torch.sin(alpha)
    cosAp = torch.cos(Ap)
    sinAp = torch.sin(Ap)
    s = sinAp * cos_alpha - cosAp * sin_alpha
    t = cosAp * cos_alpha + sinAp * sin_alpha
    cos_c_angle = vm.dot(a, b)
    u_ = t - cos_alpha
    v_ = s + sin_alpha * cos_c_angle
    q = ((v_ * t - u_ * s) * cos_alpha - v_) / torch.clamp(
        (v_ * s + u_ * t) * sin_alpha, min=1e-12)
    q = torch.clamp(q, -1.0, 1.0)
    c_perp = vm.normalize(c - vm.dot(c, a)[..., None] * a)
    c_hat = q[..., None] * a + vm.safe_sqrt(1.0 - q * q)[..., None] * c_perp
    z = 1.0 - u[..., 1] * (1.0 - vm.dot(c_hat, b))
    z = torch.clamp(z, -1.0, 1.0)
    b_perp = vm.normalize(c_hat - vm.dot(c_hat, b)[..., None] * b)
    w = z[..., None] * b + vm.safe_sqrt(1.0 - z * z)[..., None] * b_perp

    # barycentrics of the ray (p, w) against the triangle plane
    e1 = v1 - v0
    e2 = v2 - v0
    ng = vm.cross(e1, e2)
    denom = vm.dot(w, ng)
    t_hit = vm.dot(v0 - p, ng) / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    ph = p + t_hit[..., None] * w
    d = ph - v0
    d11 = vm.dot(e1, e1)
    d12 = vm.dot(e1, e2)
    d22 = vm.dot(e2, e2)
    dx1 = vm.dot(d, e1)
    dx2 = vm.dot(d, e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    b1 = torch.clamp((d22 * dx1 - d12 * dx2) / det, 0.0, 1.0)
    b2 = torch.clamp((d11 * dx2 - d12 * dx1) / det, 0.0, 1.0)
    b0 = torch.clamp(1.0 - b1 - b2, 0.0, 1.0)
    bary = torch.stack([b0, b1, b2], -1)
    degenerate = A_full < 1e-5
    bary = torch.where(degenerate[..., None], sample_uniform_triangle(u), bary)
    return bary, pdf, degenerate


def sample_visible_wavelengths(u: Tensor) -> Tensor:
    return 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)


def visible_wavelengths_pdf(lam: Tensor) -> Tensor:
    ok = (lam >= 360.0) & (lam <= 830.0)
    x = torch.cosh(0.0072 * (lam - 538.0))
    return torch.where(ok, 0.0039398042 / (x * x), 0.0)


# piecewise-constant distributions (sampling.h PiecewiseConstant1D/2D), as
# dicts of tensors like the JAX package's

def make_distribution_1d(f: Tensor) -> dict:
    """A 1D piecewise-constant distribution over [0,1]: 'cdf' (n+1,),
    'func' (n,), 'integral' ()."""
    f = f.abs()
    n = f.shape[-1]
    cdf = torch.cat([torch.zeros(f.shape[:-1] + (1,), dtype=f.dtype, device=f.device),
                     torch.cumsum(f, -1) / n], -1)
    integral = cdf[..., -1]
    cdf = torch.where((integral > 0)[..., None],
                      cdf / torch.clamp(integral[..., None], min=1e-20),
                      torch.linspace(0.0, 1.0, n + 1, device=f.device))
    return {"cdf": cdf, "func": f, "integral": integral}


def sample_distribution_1d(dist: dict, u: Tensor):
    """-> (x in [0,1], pdf, index); the first cdf entry above u
    (searchsorted right), as the JAX package searches."""
    cdf, f = dist["cdf"], dist["func"]
    n = f.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1, 0, n - 1)
    c0, c1 = cdf[idx], cdf[idx + 1]
    du = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0)
    x = (idx.to(torch.float32) + du) / n
    return x, f[idx] / torch.clamp(dist["integral"], min=1e-20), idx


def make_distribution_2d(f: Tensor) -> dict:
    """A 2D distribution over [0,1]^2 from an (h, w) function: conditional
    row cdfs and the marginal over the row integrals."""
    h, w = f.shape
    f = f.abs()
    row_int = f.mean(1)
    cond = torch.cat([torch.zeros(h, 1, dtype=f.dtype, device=f.device),
                      torch.cumsum(f, 1) / w], 1)
    cond = cond / torch.clamp(row_int[:, None], min=1e-20)
    return {"f": f, "cond_cdf": cond, "marg": make_distribution_1d(row_int), "h": h, "w": w}


def distribution_to(dist: dict, device) -> dict:
    """A distribution's tables on `device`."""
    mv = lambda v: (distribution_to(v, device) if isinstance(v, dict)
                    else v.to(device) if isinstance(v, Tensor) else v)
    return {k: mv(v) for k, v in dist.items()}


def sample_distribution_2d(dist: dict, u: Tensor):
    """u (..., 2) -> (point (..., 2) in [0,1]^2, pdf). The row's cdf is
    searched on the left (the first entry at or above u), as jnp.searchsorted's
    default side."""
    w = dist["w"]
    y, _, iy = sample_distribution_1d(dist["marg"], u[..., 1])
    cond = dist["cond_cdf"][iy]  # (..., w+1)
    ux = u[..., 0]
    ix = torch.clamp(torch.searchsorted(cond.reshape(-1, w + 1), ux.reshape(-1, 1).contiguous())
                     .reshape(ux.shape) - 1, 0, w - 1)
    c0 = torch.gather(cond, -1, ix[..., None])[..., 0]
    c1 = torch.gather(cond, -1, ix[..., None] + 1)[..., 0]
    du = torch.where(c1 > c0, (ux - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0)
    x = (ix.to(torch.float32) + du) / w
    pdf = dist["f"][iy, ix] / torch.clamp(dist["marg"]["integral"], min=1e-20)
    return torch.stack([x, y], -1), pdf
