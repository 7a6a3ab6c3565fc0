"""Vector math over trailing-axis-3 float32 tensors (port of the parts of
nn_bvh_tpu/core/vecmath.py the bench path uses). Same formulas, same
operation order, so results agree with the JAX package to float32 rounding
of the transcendental functions."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def safe_sqrt(x: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(x, min=1e-12))


def safe_acos(x: Tensor) -> Tensor:
    return torch.acos(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def absdot(a: Tensor, b: Tensor) -> Tensor:
    return dot(a, b).abs()


def cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def length_squared(v: Tensor) -> Tensor:
    return dot(v, v)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: Tensor) -> Tensor:
    """Zero vectors stay zero (double-where, as the JAX package)."""
    len2 = length_squared(v)
    ok = len2 > 1e-20
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, len2, 1.0)), 0.0)
    return v * inv[..., None]


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def face_forward(n: Tensor, v: Tensor) -> Tensor:
    return torch.where(dot(n, v)[..., None] < 0, -n, n)


def coordinate_system(n: Tensor) -> tuple[Tensor, Tensor]:
    """Branchless Duff et al. basis around unit n (Frame convention)."""
    nx, ny, z = n.unbind(-1)
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t1, t2


def to_local(n: Tensor, v: Tensor) -> Tensor:
    t, b = coordinate_system(n)
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def from_local(n: Tensor, v: Tensor) -> Tensor:
    t, b = coordinate_system(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def spherical_triangle_area(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    num = dot(a, cross(b, c))
    den = 1.0 + dot(a, b) + dot(a, c) + dot(b, c)
    bad = (num.abs() < 1e-20) & (den.abs() < 1e-12)
    return (2.0 * torch.atan2(torch.where(bad, 0.0, num),
                              torch.where(bad, 1.0, den))).abs()


def cos_theta(w: Tensor) -> Tensor:
    return w[..., 2]


def abs_cos_theta(w: Tensor) -> Tensor:
    return w[..., 2].abs()


def cos2_theta(w: Tensor) -> Tensor:
    return w[..., 2] * w[..., 2]


def sin2_theta(w: Tensor) -> Tensor:
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w: Tensor) -> Tensor:
    return torch.sqrt(sin2_theta(w))


def tan2_theta(w: Tensor) -> Tensor:
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-20)


def cos_phi(w: Tensor) -> Tensor:
    s = sin_theta(w)
    return torch.where(s == 0, 1.0,
                       torch.clamp(w[..., 0] / torch.clamp(s, min=1e-20), -1, 1))


def sin_phi(w: Tensor) -> Tensor:
    s = sin_theta(w)
    return torch.where(s == 0, 0.0,
                       torch.clamp(w[..., 1] / torch.clamp(s, min=1e-20), -1, 1))


def same_hemisphere(w: Tensor, wp: Tensor) -> Tensor:
    return w[..., 2] * wp[..., 2] > 0


def reflect(wo: Tensor, n: Tensor) -> Tensor:
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi: Tensor, n: Tensor, eta: Tensor):
    """Snell refraction -> (valid, eta used, wt). Flips n and eta when wi is
    on the back side, so callers pass the surface's eta as it is."""
    ct_i = dot(n, wi)
    flip = ct_i < 0
    eta = torch.where(flip, 1.0 / eta, eta)
    ct_i = torch.where(flip, -ct_i, ct_i)
    n = torch.where(flip[..., None], -n, n)
    s2_i = torch.clamp(1.0 - ct_i * ct_i, min=0.0)
    s2_t = s2_i / (eta * eta)
    tir = s2_t >= 1.0
    ct_t = safe_sqrt(1.0 - s2_t)
    wt = -wi / eta[..., None] + (ct_i / eta - ct_t)[..., None] * n
    return ~tir, eta, wt


def offset_ray_origin(p: Tensor, n: Tensor, w: Tensor,
                      scale: float = 1e-4) -> Tensor:
    """Scale-relative spawn offset (interaction.h OffsetRayOrigin analog)."""
    mag = torch.clamp(p.abs().amax(-1), min=1.0)
    d = (scale * mag)[..., None]
    off = torch.where(dot(w, n)[..., None] < 0, -d, d)
    return p + off * n
