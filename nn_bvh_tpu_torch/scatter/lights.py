"""Light sampling over the fused light table (port of the area-triangle and
uniform-infinite paths of nn_bvh_tpu/scatter/lights.py).

The (L, 20) light record: [0 type | 1:4 pos | 4:7 coeffs | 7 scale |
8:20 params (tri, two_sided, ...)], built from the scene tensors so autograd
can reach light_coeffs / light_scale. Area triangles are sampled by solid
angle (spherical triangle) with an area-sampling fallback for tiny angles.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, spectrum, rgb2spec
from ..geometry import scene as scene_mod, triangle


class LightLiSample(NamedTuple):
    wi: torch.Tensor        # (..., 3) world
    dist: torch.Tensor      # (...,) distance to the light point (inf if infinite)
    li: torch.Tensor        # (..., 4) spectral radiance
    pdf: torch.Tensor       # (...,) solid-angle pdf
    is_delta: torch.Tensor  # (...,) bool
    valid: torch.Tensor     # (...,) bool


def light_records(scene) -> torch.Tensor:
    return torch.cat([scene.light_type[:, None].to(torch.float32), scene.light_pos,
                      scene.light_coeffs, scene.light_scale[:, None],
                      scene.light_params], -1)


def record_spectrum(rec, lam):
    """Emission spectrum of a gathered record (RGBIlluminantSpectrum)."""
    return (rgb2spec.eval_sigmoid_poly(rec[..., 4:7], lam)
            * spectrum.illuminant_d_normalized(lam) * rec[..., 7:8])


def area_light_l_rec(light_rec, has_light, ng, w_out, lam):
    """Radiance toward w_out from a hit on an emissive triangle."""
    two_sided = light_rec[..., 9] > 0
    front = vm.dot(ng, w_out) > 0
    emit = has_light & (front | two_sided)
    return torch.where(emit[..., None], record_spectrum(light_rec, lam), 0.0)


def sample_li(scene, light_all, light_id, p, lam, u2) -> LightLiSample:
    """SampleLi for a per-lane chosen light id. p (...,3), u2 (...,2)."""
    rec = light_all[torch.clamp(light_id, min=0).long()]
    ltype = rec[..., 0].to(torch.int32)
    emit = record_spectrum(rec, lam)

    # uniform infinite
    wi_inf = sampling.sample_uniform_sphere(u2)
    pdf_inf = torch.full(p.shape[:-1], sampling.UNIFORM_SPHERE_PDF,
                         dtype=torch.float32, device=p.device)

    # area triangle (vertices from one tri_shade gather)
    tri_idx = rec[..., 8].to(torch.int64)
    tv = scene.tri_shade[torch.clamp(tri_idx, min=0)][..., 0:9]
    v0, v1, v2 = tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]
    bary, pdf_sa, degen = sampling.sample_spherical_triangle(v0, v1, v2, p, u2)
    lp = bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2
    to_lp = lp - p
    d2a = torch.clamp(vm.length_squared(to_lp), min=1e-12)
    dist_a = torch.sqrt(d2a)
    wi_area = to_lp / dist_a[..., None]
    ng = triangle.geometric_normal(v0, v1, v2)
    cos_l = vm.dot(ng, -wi_area)
    front_ok = (rec[..., 9] > 0) | (cos_l > 0)
    area_t = triangle.area(v0, v1, v2)
    pdf_area_fallback = d2a / torch.clamp(cos_l.abs() * area_t, min=1e-12)
    pdf_a = torch.where(degen, pdf_area_fallback, pdf_sa)
    li_area = torch.where(front_ok[..., None], emit, 0.0)

    is_inf = ltype == scene_mod.LIGHT_UNIFORM_INFINITE
    is_area = ltype == scene_mod.LIGHT_AREA_TRI
    wi = torch.where(is_inf[..., None], wi_inf, wi_area)
    li = torch.where(is_inf[..., None], emit, torch.where(is_area[..., None], li_area, 0.0))
    dist = torch.where(is_area, dist_a, torch.inf)
    pdf = torch.where(is_inf, pdf_inf, torch.where(is_area, pdf_a, 1.0))
    valid = (light_id >= 0) & (pdf > 0) & (li > 0).any(-1)
    valid = valid & torch.where(is_area, front_ok, True)
    return LightLiSample(wi=wi, dist=dist, li=li, pdf=pdf,
                         is_delta=torch.zeros_like(valid), valid=valid)


def sphere_pdf_li(lrec, ref_p, hit_p, hit_ng):
    """Solid-angle pdf sphere-light sampling gives a direction from ref_p
    that hits the sphere (Sphere::PDF): uniform cone outside, area pdf
    converted at the actual hit inside."""
    center = lrec[..., 1:4]
    radius = lrec[..., 8]
    dc2 = torch.clamp(vm.length_squared(center - ref_p), min=1e-12)
    sin2_max = torch.clamp(radius * radius / dc2, 0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2_max)
    outside = dc2 > radius * radius * 1.0001
    pdf_out = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-9)
    area_sph = 4.0 * math.pi * radius * radius
    to_h = hit_p - ref_p
    d2h = torch.clamp(vm.length_squared(to_h), min=1e-12)
    wi_h = to_h * torch.rsqrt(d2h)[..., None]
    cos_h = vm.absdot(hit_ng, wi_h)
    pdf_in = d2h / torch.clamp(cos_h * area_sph, min=1e-12)
    return torch.where(outside, pdf_out, pdf_in)


def area_pdf_li_from_verts(v0, v1, v2, ref_p):
    """Solid-angle pdf of triangle solid-angle sampling toward a hit."""
    omega = triangle.solid_angle(v0, v1, v2, ref_p)
    return torch.where(omega > 1e-5, 1.0 / torch.clamp(omega, min=1e-12), 0.0)


def infinite_le(scene, d, lam):
    """Radiance of the uniform infinite lights for escaped rays (zero when
    the scene has none)."""
    is_inf = scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE
    spec_all = rgb2spec.eval_sigmoid_poly(
        scene.light_coeffs.view((-1,) + (1,) * (lam.dim() - 1) + (3,)), lam[None])
    w = torch.where(is_inf, scene.light_scale, 0.0)
    out = torch.tensordot(w, spec_all, dims=([0], [0]))
    return out * spectrum.illuminant_d_normalized(lam)
