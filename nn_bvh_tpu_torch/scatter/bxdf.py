"""BxDF evaluation/sampling over ray batches (port of the diffuse and
conductor paths of nn_bvh_tpu/scatter/bxdf.py).

Local shading frame (+z = shading normal); per-lane material tags select
between lobes with masked selects. Conductors are GGX (Trowbridge-Reitz)
with visible-normal sampling, or a perfect mirror when effectively smooth,
with the scalar complex Fresnel `fr_complex`. Other material tags give
f = 0, pdf = 0 and an invalid sample; scenes holding them are refused when
they are loaded (geometry.scene.check_slice).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, rgb2spec
from ..geometry import scene as scene_mod

INV_PI = sampling.INV_PI


class BSDFSample(NamedTuple):
    wi: torch.Tensor            # (..., 3) local
    f: torch.Tensor             # (..., 4)
    pdf: torch.Tensor           # (...,)
    specular: torch.Tensor      # (...,) bool
    transmission: torch.Tensor  # (...,) bool
    eta: torch.Tensor           # (...,)
    valid: torch.Tensor         # (...,) bool


class MaterialCtx(NamedTuple):
    mat_type: torch.Tensor  # (...,) i32
    refl: torch.Tensor      # (..., 4) base color at the sampled wavelengths
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor


def fr_complex(cos_i, eta, k):
    """Conductor Fresnel with complex IOR eta - i k (scalar)."""
    cos_i = torch.clamp(cos_i.abs(), 0.0, 1.0)
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * cos_i
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return torch.clamp(0.5 * (rp + rs), 0.0, 1.0)


def tr_d(wm, ax, ay):
    t2 = vm.tan2_theta(wm)
    c4 = vm.cos2_theta(wm) ** 2
    e = (vm.cos_phi(wm) ** 2 / torch.clamp(ax * ax, min=1e-12)
         + vm.sin_phi(wm) ** 2 / torch.clamp(ay * ay, min=1e-12)) * t2
    d = 1.0 / torch.clamp(math.pi * ax * ay * c4 * (1.0 + e) ** 2, min=1e-20)
    # a normal within ~1e-19 of the horizon gives c4 = 0 and e = inf, so
    # d = NaN: no density there, as for an infinite tan^2 (a NaN that the
    # forward pass would discard still turns 0 * NaN into a NaN gradient)
    return torch.where(torch.isfinite(t2) & torch.isfinite(d), d, 0.0)


def tr_lambda(w, ax, ay):
    t2 = vm.tan2_theta(w)
    a2 = vm.cos_phi(w) ** 2 * ax * ax + vm.sin_phi(w) ** 2 * ay * ay
    lam = 0.5 * (torch.sqrt(1.0 + a2 * t2) - 1.0)
    return torch.where(torch.isfinite(t2), lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_pdf(wo, wm, ax, ay):
    """Visible-normal pdf D_wo(wm)."""
    return (tr_g1(wo, ax, ay) / torch.clamp(vm.abs_cos_theta(wo), min=1e-9)
            * tr_d(wm, ax, ay) * vm.absdot(wo, wm))


def tr_sample_wm(w, u, ax, ay):
    """Sample visible normals (Heitz 2018)."""
    wh = vm.normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    wh = torch.where(wh[..., 2:3] < 0, -wh, wh)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=w.device).expand_as(wh)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=w.device).expand_as(wh)
    t1 = torch.where((wh[..., 2].abs() < 0.999)[..., None],
                     vm.normalize(vm.cross(z_axis, wh)), x_axis)
    t2 = vm.cross(wh, t1)
    p = sampling.sample_uniform_disk_concentric(u)
    h = vm.safe_sqrt(1.0 - p[..., 0] ** 2)
    py = vm.lerp((1.0 + wh[..., 2]) / 2.0, h, p[..., 1])
    pz = vm.safe_sqrt(1.0 - p[..., 0] ** 2 - py ** 2)
    nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
    return vm.normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], -1))


def roughness_to_alpha(r):
    return torch.sqrt(torch.clamp(r, min=0.0))


def effectively_smooth(ax, ay):
    return torch.maximum(ax, ay) < 1e-3


def material_records(scene) -> torch.Tensor:
    """(M, 17) fused material table [0 type | 1:4 coeffs | 4 scale |
    5:17 params], built from the scene tensors so autograd can reach
    mat_coeffs / mat_scale."""
    return torch.cat([scene.mat_type[:, None].to(torch.float32), scene.mat_coeffs,
                      scene.mat_scale[:, None], scene.mat_params], -1)


def gather_material(scene, mat_id, lam, mat_all=None, uv=None,
                    foot_log2=None) -> MaterialCtx:
    """Per-lane material parameters with the base color expanded at the
    sampled wavelengths (one gather). Textures and mix materials are not in
    this slice (the scene check refuses them), so the texture inputs uv and
    foot_log2 have no effect yet (ROADMAP queue 1, item 3)."""
    if mat_all is None:
        mat_all = material_records(scene)
    rec = mat_all[torch.clamp(mat_id, min=0).long()]
    refl = rgb2spec.eval_sigmoid_poly(rec[..., 1:4], lam) * rec[..., 4:5]
    return MaterialCtx(
        mat_type=rec[..., 0].to(torch.int32),
        refl=torch.clamp(refl, min=0.0),
        ax=roughness_to_alpha(rec[..., 5]),
        ay=roughness_to_alpha(rec[..., 6]),
        eta=rec[..., 7],
        k=rec[..., 8])


def evaluate(ctx: MaterialCtx, wo, wi):
    """f(wo, wi) (..., 4) and pdf (...,) of the non-delta components."""
    t = ctx.mat_type
    refl_side = vm.same_hemisphere(wo, wi)
    abs_ci = vm.abs_cos_theta(wi)

    f_diff = torch.where(refl_side[..., None], ctx.refl * INV_PI, 0.0)
    pdf_diff = torch.where(refl_side, sampling.cosine_hemisphere_pdf(abs_ci), 0.0)

    smooth = effectively_smooth(ctx.ax, ctx.ay)
    wm = wi + wo
    wm_len2 = vm.length_squared(wm)
    wm_n = vm.normalize(wm)
    wm_n = torch.where(wm_n[..., 2:3] < 0, -wm_n, wm_n)
    valid_m = (wm_len2 > 1e-12) & refl_side & ~smooth
    fr_s = fr_complex(vm.absdot(wo, wm_n), ctx.eta, ctx.k)[..., None]
    d_ggx = tr_d(wm_n, ctx.ax, ctx.ay)
    g_ggx = tr_g(wo, wi, ctx.ax, ctx.ay)
    denom = torch.clamp(4.0 * vm.abs_cos_theta(wo) * abs_ci, min=1e-9)
    f_cond = torch.where(valid_m[..., None],
                         ctx.refl * fr_s * (d_ggx * g_ggx / denom)[..., None], 0.0)
    pdf_cond = torch.where(
        valid_m,
        tr_pdf(wo, wm_n, ctx.ax, ctx.ay) / torch.clamp(4.0 * vm.absdot(wo, wm_n), min=1e-9),
        0.0)

    is_d = t == scene_mod.MAT_DIFFUSE
    is_c = t == scene_mod.MAT_CONDUCTOR
    f = torch.where(is_d[..., None], f_diff, torch.where(is_c[..., None], f_cond, 0.0))
    pdf = torch.where(is_d, pdf_diff, torch.where(is_c, pdf_cond, 0.0))
    return f, pdf


def sample(ctx: MaterialCtx, wo, uc, u2) -> BSDFSample:
    """Sample_f over lane-tagged materials. uc (...,), u2 (..., 2)."""
    t = ctx.mat_type
    smooth = effectively_smooth(ctx.ax, ctx.ay)
    flip_z = torch.tensor([1.0, 1.0, -1.0], device=wo.device)

    # diffuse: cosine hemisphere on wo's side
    wi_diff = sampling.sample_cosine_hemisphere(u2)
    wi_diff = torch.where(wo[..., 2:3] < 0, wi_diff * flip_z, wi_diff)
    pdf_diff = sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi_diff))
    f_diff = ctx.refl * INV_PI

    # conductor: mirror when smooth, else a sampled visible normal
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    fr_smooth = fr_complex(vm.abs_cos_theta(wo), ctx.eta, ctx.k)[..., None]
    f_mirror = ctx.refl * fr_smooth / torch.clamp(
        vm.abs_cos_theta(wi_mirror), min=1e-9)[..., None]
    wo_up = torch.where(wo[..., 2:3] < 0, -wo, wo)
    wm = tr_sample_wm(wo_up, u2, ctx.ax, ctx.ay)
    wm = torch.where(wo[..., 2:3] < 0, -wm, wm)
    wi_rough = vm.reflect(wo, wm)
    refl_ok = vm.same_hemisphere(wo, wi_rough)
    f_rough, pdf_rough = evaluate(
        ctx._replace(mat_type=torch.full_like(t, scene_mod.MAT_CONDUCTOR)), wo, wi_rough)
    wi_cond = torch.where(smooth[..., None], wi_mirror, wi_rough)
    f_cond = torch.where(smooth[..., None], f_mirror, f_rough)
    pdf_cond = torch.where(smooth, 1.0, pdf_rough)
    valid_cond = smooth | refl_ok

    is_d = t == scene_mod.MAT_DIFFUSE
    is_c = t == scene_mod.MAT_CONDUCTOR
    wi = torch.where(is_c[..., None], wi_cond, wi_diff)
    f = torch.where(is_d[..., None], f_diff, torch.where(is_c[..., None], f_cond, 0.0))
    pdf = torch.where(is_d, pdf_diff, torch.where(is_c, pdf_cond, 0.0))
    specular = is_c & smooth
    valid = (is_d | (is_c & valid_cond)) & (pdf > 0) & (t >= 0)
    zeros_b = torch.zeros_like(smooth)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=specular, transmission=zeros_b,
                      eta=torch.ones_like(pdf), valid=valid)
