"""Sampling warps and MIS heuristics (port of the parts of
nn_bvh_tpu/core/sampling.py the bench path uses)."""

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
