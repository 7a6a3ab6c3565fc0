"""BxDF evaluation and sampling over ray batches (port of
nn_bvh_tpu/scatter/bxdf.py).

Local shading frame (+z = shading normal); per-lane material tags select
between lobes with masked selects. The lobes are the JAX package's:
diffuse, conductor (GGX with visible-normal sampling, or a mirror when
effectively smooth; scalar or per-wavelength complex Fresnel), dielectric
(smooth and rough), thin dielectric, diffuse transmission, coated diffuse
and coated conductor (the stochastic walk of scatter/layered.py), hair
(scatter/hair.py), measured (scatter/measured.py) and the subsurface exit
lobe. Mix materials are resolved per lane in `gather_material`, which also
reads textured base colors and texture-driven mix amounts from the atlas
(geometry/texture.py) in scenes that hold them.

A lobe is computed only when the scene has its material: `MaterialCtx.kinds`
holds the scene's material tags (`scene_kinds`, read once a wave), and the
coated, hair, measured and spectral inputs are gathered only when the
scene's static feature flags say so, as in the JAX package. Where the JAX
package computes its dielectric, thin and diffuse-transmission lobes on
every lane, the port computes them only in scenes that hold them; the
select over lobes gives the same values.

As in the JAX package, `evaluate` has no diffuse-transmission or thin
dielectric branch (f = 0 there, so NEE adds nothing on such surfaces),
diffuse transmission uses one reflectance for both lobes, and `sample` has
no subsurface branch (a subsurface lane that wavefront/subsurface.py did not
turn into an exit or a mirror samples nothing).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, rgb2spec, spectrum
from ..geometry import scene as scene_mod, texture
from . import material_grad

INV_PI = sampling.INV_PI


class BSDFSample(NamedTuple):
    wi: torch.Tensor            # (..., 3) local
    f: torch.Tensor             # (..., 4)
    pdf: torch.Tensor           # (...,)
    specular: torch.Tensor      # (...,) bool: a delta component was sampled
    transmission: torch.Tensor  # (...,) bool: crossed the surface
    eta: torch.Tensor           # (...,) relative IOR of the crossing (eta_scale)
    valid: torch.Tensor         # (...,) bool


class MaterialCtx(NamedTuple):
    """Per-lane shading inputs gathered from the material table."""

    mat_type: torch.Tensor  # (...,) i32
    refl: torch.Tensor      # (..., 4) base color at the sampled wavelengths
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor
    coat_ax: torch.Tensor = None     # coat GGX alpha; None: no coated material
    h: torch.Tensor = None           # hair fiber offset in [-1, 1]; None: no hair
    meas_tab: torch.Tensor = None    # (T, No, Ni, Np, 4) measured tables; None: none
    meas_id: torch.Tensor = None     # (...,) i32 table id
    meas_alpha: torch.Tensor = None  # (...,) GGX proxy-sampler roughness
    lam: torch.Tensor = None         # (..., S) wavelengths (measured uplift)
    eta_s: torch.Tensor = None       # (..., S) spectral eta; None: no named spectra
    k_s: torch.Tensor = None         # (..., S) spectral k
    kinds: frozenset = None          # the scene's material tags (static); None: all


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fr_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance of a dielectric (real eta)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    flip = cos_i < 0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_i = cos_i.abs()
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = vm.safe_sqrt(1.0 - sin2_t)
    r_parl = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-9)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-9)
    return torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def fr_complex(cos_i, eta, k):
    """Conductor Fresnel with complex IOR eta - i k (scalar or per
    wavelength)."""
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


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance (polynomial fits)."""
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


def sss_exit_f(eta, abs_cos_i):
    """The normalized Fresnel exit lobe of a subsurface path:
    (1 - Fr(cos, eta)) / (c pi)."""
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return (1.0 - fr_dielectric(abs_cos_i, eta)) / torch.clamp(c * math.pi, min=1e-6)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX)
# ---------------------------------------------------------------------------

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


def tr_d_visible(w, wm, ax, ay):
    """Visible-normal density D_w(wm)."""
    return (tr_g1(w, ax, ay) / torch.clamp(vm.abs_cos_theta(w), min=1e-9)
            * tr_d(wm, ax, ay) * vm.absdot(w, wm))


def tr_pdf(wo, wm, ax, ay):
    return tr_d_visible(wo, wm, ax, ay)


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


# ---------------------------------------------------------------------------
# the material table
# ---------------------------------------------------------------------------

def material_records(scene) -> torch.Tensor:
    """(M, 17) fused material table [0 type | 1:4 coeffs | 4 scale |
    5:17 params], built from the scene tensors so autograd can reach
    mat_coeffs / mat_scale."""
    return torch.cat([scene.mat_type[:, None].to(torch.float32), scene.mat_coeffs,
                      scene.mat_scale[:, None], scene.mat_params], -1)


# markers scene_kinds adds beside the material tags: the texture lookups a
# wave of the scene makes
TEXTURED = "textured"        # a material reads its base color from the atlas
MIX_TEXTURE = "mix_texture"  # a mix reads its amount from the atlas


def scene_kinds(scene) -> frozenset:
    """The material tags a wave of `scene` shades (one host read of
    mat_type, and of mat_params when the scene has textures): those of its
    materials, with subsurface the exit lobe and the mirror its lanes
    become, and the markers TEXTURED and MIX_TEXTURE."""
    mat_type = scene_mod.host(scene.mat_type)
    kinds = set(mat_type.tolist())
    if scene_mod.MAT_SUBSURFACE in kinds:
        kinds |= {scene_mod.MAT_SSS_EXIT, scene_mod.MAT_CONDUCTOR}
    if texture.has_textures(scene):
        params = scene_mod.host(scene.mat_params)
        if (params[:, 5] >= 0).any():
            kinds.add(TEXTURED)
        if ((mat_type == scene_mod.MAT_MIX) & (params[:, 8] < 0)).any():
            kinds.add(MIX_TEXTURE)
    return frozenset(kinds)


def has_mix(scene) -> bool:
    return bool(scene.feat_mix)


def has_hair(scene) -> bool:
    return bool(scene.feat_hair)


def has_measured(scene) -> bool:
    return bool(scene.feat_measured)


def has_coated(scene) -> bool:
    return bool(scene.feat_coated)


def has_spectral(scene) -> bool:
    return bool(scene.feat_spectral) and scene.spec_tables is not None


def sample_spec_table(tables, tab_idx, lam):
    """Dense 1-nm spectra at the sampled wavelengths (gather + lerp).
    tables (S, 471), tab_idx (...,) i32, lam (..., 4) nm -> (..., 4)."""
    x = torch.clamp(lam - spectrum.LAMBDA_MIN, 0.0, tables.shape[1] - 1.001)
    lo = x.to(torch.int64)
    frac = x - lo.to(torch.float32)
    ti = torch.clamp(tab_idx.to(torch.int64), min=0)[..., None]
    return tables[ti, lo] * (1.0 - frac) + tables[ti, lo + 1] * frac


def select_ctx(mask, ctx_new: MaterialCtx, ctx_old: MaterialCtx) -> MaterialCtx:
    """Per-lane select between two MaterialCtx (mask (...,) picks ctx_new).
    Fields that are not per-lane (shared tables, the static tags) pass
    through from ctx_new."""
    def sel(new, old):
        if new is None or old is None:
            return new if old is None else old
        if not isinstance(new, torch.Tensor):
            return new
        if new.ndim == mask.ndim + 1 and new.shape[:-1] == mask.shape:
            return torch.where(mask[..., None], new, old)
        if new.shape == mask.shape:
            return torch.where(mask, new, old)
        return new
    return MaterialCtx(*(sel(n, o) for n, o in zip(ctx_new, ctx_old)))


def zeros_ctx_like(ctx: MaterialCtx) -> MaterialCtx:
    """A neutral ctx of the same fields (mat_type -1, eta 1, the rest 0)."""
    z = MaterialCtx(*(torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
                      for v in ctx))
    return z._replace(mat_type=torch.full_like(ctx.mat_type, -1), eta=torch.ones_like(ctx.eta),
                      meas_tab=ctx.meas_tab, lam=ctx.lam)


def gather_material(scene, mat_id, lam, mat_all=None, uv=None, u_mix=None,
                    foot_log2=None, kinds=None) -> MaterialCtx:
    """Per-lane material parameters with the base color expanded at the
    sampled wavelengths (one gather). A mix material is resolved here, as
    the wavefront reference resolves it before shading: u_mix < amount picks
    mix_materials[1], else [0]; an amount below 0 is -(texture id + 1), the
    texture's value at 550 nm there. A material with a texture id
    (mat_params[5]) takes its base color from the atlas. Both lookups are
    trilinear at the footprint foot_log2 (level 0 without it), and are made
    only when `kinds` holds their marker (MIX_TEXTURE, TEXTURED). Hair takes
    its fiber offset from uv's v. `kinds`: the scene's tags (scene_kinds),
    read from the scene when not given. The table's rows are read by
    material_grad.gather, whose backward on CUDA is a segment-sum kernel."""
    if mat_all is None:
        mat_all = material_records(scene)
    if kinds is None:
        kinds = scene_kinds(scene)
    rec = material_grad.gather(mat_all, mat_id)
    if has_mix(scene) and u_mix is not None:
        is_mix = rec[..., 0].to(torch.int32) == scene_mod.MAT_MIX
        amount = rec[..., 13]
        if MIX_TEXTURE in kinds and uv is not None:
            texel = texture.lookup(scene.tex_atlas, scene.tex_desc,
                                   (-amount - 1.0).to(torch.int32), uv, foot_log2=foot_log2)
            lam550 = torch.full_like(uv[..., :1], 550.0)
            tval = torch.clamp(rgb2spec.eval_sigmoid_poly(texel[..., 0:3], lam550)[..., 0]
                               * texel[..., 3], 0.0, 1.0)
            amount = torch.where(amount < 0, tval, amount)
        resolved = torch.where(is_mix, torch.where(u_mix < amount,
                                                   rec[..., 12].to(torch.int32),
                                                   rec[..., 11].to(torch.int32)), mat_id)
        rec = torch.where(is_mix[..., None], material_grad.gather(mat_all, resolved), rec)
    coeffs, scale = rec[..., 1:4], rec[..., 4:5]
    if TEXTURED in kinds and uv is not None:
        tex_id = rec[..., 10].to(torch.int32)
        texel = texture.lookup(scene.tex_atlas, scene.tex_desc, tex_id, uv, foot_log2=foot_log2)
        use = (tex_id >= 0)[..., None]
        coeffs = torch.where(use, texel[..., 0:3], coeffs)
        scale = torch.where(use, texel[..., 3:4], scale)
    refl = rgb2spec.eval_sigmoid_poly(coeffs, lam) * scale
    mat_type = rec[..., 0].to(torch.int32)
    ax = roughness_to_alpha(rec[..., 5])
    ay = roughness_to_alpha(rec[..., 6])
    h = None
    if has_hair(scene):
        # hair keeps beta_m / beta_n raw in the roughness slots
        is_hair = mat_type == scene_mod.MAT_HAIR
        ax = torch.where(is_hair, torch.clamp(rec[..., 5], 0.02, 1.0), ax)
        ay = torch.where(is_hair, torch.clamp(rec[..., 6], 0.02, 1.0), ay)
        if uv is not None:
            hv = 2.0 * (uv[..., 1] - torch.floor(uv[..., 1])) - 1.0
        else:
            hv = torch.zeros(rec.shape[:-1], dtype=torch.float32, device=rec.device)
        h = torch.clamp(hv, -0.9995, 0.9995)
    meas_tab = meas_id = meas_alpha = lam_ctx = None
    if has_measured(scene):
        meas_tab = scene.measured_coeffs
        meas_id = rec[..., 8].to(torch.int32)  # the k slot holds the table id
        if scene.measured_alpha is not None:
            meas_alpha = scene.measured_alpha[
                torch.clamp(meas_id, 0, scene.measured_alpha.shape[0] - 1).long()]
        lam_ctx = lam
    eta_s = k_s = None
    if has_spectral(scene) and lam is not None:
        eta_tab = rec[..., 15].to(torch.int32)
        k_tab = rec[..., 16].to(torch.int32)
        eta_s = torch.where((eta_tab >= 0)[..., None],
                            sample_spec_table(scene.spec_tables, eta_tab, lam), rec[..., 7:8])
        k_s = torch.where((k_tab >= 0)[..., None],
                          sample_spec_table(scene.spec_tables, k_tab, lam), rec[..., 8:9])
    return MaterialCtx(
        mat_type=mat_type, refl=torch.clamp(refl, min=0.0), ax=ax, ay=ay,
        eta=rec[..., 7], k=rec[..., 8],
        coat_ax=roughness_to_alpha(rec[..., 14]) if has_coated(scene) else None,
        h=h, meas_tab=meas_tab, meas_id=meas_id, meas_alpha=meas_alpha, lam=lam_ctx,
        eta_s=eta_s, k_s=k_s, kinds=kinds)


# ---------------------------------------------------------------------------
# evaluate / sample
# ---------------------------------------------------------------------------

def _has(ctx: MaterialCtx, *tags) -> bool:
    return ctx.kinds is None or any(t in ctx.kinds for t in tags)


def _select(conds, vals, default):
    """vals[i] where conds[i] (the conditions are disjoint), else default;
    an entry that is `default` itself costs nothing."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        if v is not default:
            out = torch.where(c, v, out)
    return out


def _conductor_fresnel(ctx: MaterialCtx, cos):
    """(..., 4): per wavelength where the scene has named spectra."""
    if ctx.eta_s is not None:
        return fr_complex(cos[..., None], ctx.eta_s, ctx.k_s)
    return fr_complex(cos, ctx.eta, ctx.k)[..., None]


def _coat_ctx(ctx: MaterialCtx):
    """(ctx for the walk, coated-conductor mask): lanes that are not coated
    get benign parameters, since the walk runs on every lane (a smooth
    conductor's eta as a coat IOR makes infinities whose gradient is
    0 * inf = NaN)."""
    t = ctx.mat_type
    cc = t == scene_mod.MAT_COATED_CONDUCTOR
    is_coat = cc | (t == scene_mod.MAT_COATED_DIFFUSE)
    return ctx._replace(eta=torch.where(is_coat | cc, ctx.eta, 1.5),
                        ax=torch.where(is_coat, ctx.ax, 0.3),
                        ay=torch.where(is_coat, ctx.ay, 0.3),
                        coat_ax=torch.where(is_coat, ctx.coat_ax, 0.1)), cc


def _has_coated(ctx: MaterialCtx) -> bool:
    return ctx.coat_ax is not None and _has(ctx, scene_mod.MAT_COATED_DIFFUSE,
                                            scene_mod.MAT_COATED_CONDUCTOR)


def evaluate(ctx: MaterialCtx, wo, wi):
    """f(wo, wi) (..., 4) and pdf (...,) of the non-delta components
    (smooth conductors and dielectrics are deltas: 0 here)."""
    t = ctx.mat_type
    refl_side = vm.same_hemisphere(wo, wi)
    abs_ci = vm.abs_cos_theta(wi)
    conds, fs, pdfs = [], [], []
    pdf_diff = None
    if _has(ctx, scene_mod.MAT_DIFFUSE, scene_mod.MAT_SSS_EXIT):
        pdf_diff = torch.where(refl_side, sampling.cosine_hemisphere_pdf(abs_ci), 0.0)
    if _has(ctx, scene_mod.MAT_DIFFUSE):
        conds.append(t == scene_mod.MAT_DIFFUSE)
        fs.append(torch.where(refl_side[..., None], ctx.refl * INV_PI, 0.0))
        pdfs.append(pdf_diff)
    smooth = effectively_smooth(ctx.ax, ctx.ay)
    if _has(ctx, scene_mod.MAT_CONDUCTOR):
        wm = wi + wo
        wm_len2 = vm.length_squared(wm)
        wm_n = vm.normalize(wm)
        wm_n = torch.where(wm_n[..., 2:3] < 0, -wm_n, wm_n)
        valid_m = (wm_len2 > 1e-12) & refl_side & ~smooth
        fr_s = _conductor_fresnel(ctx, vm.absdot(wo, wm_n))
        d_ggx = tr_d(wm_n, ctx.ax, ctx.ay)
        g_ggx = tr_g(wo, wi, ctx.ax, ctx.ay)
        denom = torch.clamp(4.0 * vm.abs_cos_theta(wo) * abs_ci, min=1e-9)
        conds.append(t == scene_mod.MAT_CONDUCTOR)
        fs.append(torch.where(valid_m[..., None],
                              ctx.refl * fr_s * (d_ggx * g_ggx / denom)[..., None], 0.0))
        pdfs.append(torch.where(valid_m, tr_pdf(wo, wm_n, ctx.ax, ctx.ay)
                                / torch.clamp(4.0 * vm.absdot(wo, wm_n), min=1e-9), 0.0))
    if _has(ctx, scene_mod.MAT_DIELECTRIC):
        # rough dielectric reflection and transmission
        f_dr, pdf_dr = _rough_dielectric_eval(ctx, wo, wi, smooth)
        conds.append(t == scene_mod.MAT_DIELECTRIC)
        fs.append(f_dr[..., None].expand(ctx.refl.shape))
        pdfs.append(pdf_dr)
    if _has_coated(ctx):
        from . import layered

        lctx, cc = _coat_ctx(ctx)
        f_lay = layered.coated_f(lctx, wo, wi, cc)
        pdf_lay = layered.coated_pdf(lctx, wo, wi, cc)
        conds += [t == scene_mod.MAT_COATED_DIFFUSE, t == scene_mod.MAT_COATED_CONDUCTOR]
        fs += [f_lay, f_lay]
        pdfs += [pdf_lay, pdf_lay]
    if _has(ctx, scene_mod.MAT_SSS_EXIT):
        conds.append(t == scene_mod.MAT_SSS_EXIT)
        fs.append(torch.where(refl_side[..., None],
                              sss_exit_f(ctx.eta, abs_ci)[..., None].expand(ctx.refl.shape),
                              0.0))
        pdfs.append(pdf_diff)
    if ctx.h is not None and _has(ctx, scene_mod.MAT_HAIR):
        from . import hair as hair_mod

        sigma_a = hair_mod.sigma_a_from_reflectance(ctx.refl, ctx.ay)
        conds.append(t == scene_mod.MAT_HAIR)
        fs.append(hair_mod.f(wo, wi, ctx.h, ctx.eta, sigma_a, ctx.ax, ctx.ay))
        pdfs.append(hair_mod.pdf(wo, wi, ctx.h, ctx.eta, sigma_a, ctx.ax, ctx.ay))
    if ctx.meas_tab is not None and _has(ctx, scene_mod.MAT_MEASURED):
        from . import measured as meas_mod

        conds.append(t == scene_mod.MAT_MEASURED)
        fs.append(meas_mod.f(ctx.meas_tab, ctx.meas_id, wo, wi, ctx.lam))
        pdfs.append(meas_mod.pdf(wo, wi, ctx.meas_alpha))
    f = _select([c[..., None] for c in conds], fs, 0.0)
    pdf = _select(conds, pdfs, 0.0)
    if not isinstance(f, torch.Tensor):  # no lobe at all
        f = torch.zeros_like(ctx.refl)
        pdf = torch.zeros_like(abs_ci)
    return f, pdf


def _rough_dielectric_eval(ctx: MaterialCtx, wo, wi, smooth, mode: str = "radiance"):
    """f (...,) and pdf (...,) of the rough dielectric for any (wo, wi):
    reflection or transmission by the hemispheres; zero on smooth lanes.
    mode "radiance" divides transmission by etap^2, "importance" does not."""
    cos_o = vm.cos_theta(wo)
    cos_i = vm.cos_theta(wi)
    is_refl = cos_i * cos_o > 0
    etap = torch.where(is_refl, 1.0, torch.where(cos_o > 0, ctx.eta, 1.0 / ctx.eta))
    wm = wi * etap[..., None] + wo
    wm_len2 = vm.length_squared(wm)
    degenerate = (cos_i == 0) | (cos_o == 0) | (wm_len2 < 1e-16)
    wm = vm.normalize(torch.where(degenerate[..., None], wo, wm))
    wm = torch.where(wm[..., 2:3] < 0, -wm, wm)
    back = (vm.dot(wm, wi) * cos_i < 0) | (vm.dot(wm, wo) * cos_o < 0)
    fr = fr_dielectric(vm.dot(wo, wm), ctx.eta)
    d = tr_d(wm, ctx.ax, ctx.ay)
    g = tr_g(wo, wi, ctx.ax, ctx.ay)
    pdf_wm = tr_pdf(wo, wm, ctx.ax, ctx.ay)
    f_r = d * fr * g / torch.clamp(4.0 * (cos_i * cos_o).abs(), min=1e-12)
    pdf_r = pdf_wm / torch.clamp(4.0 * vm.absdot(wo, wm), min=1e-9) * fr
    denom = (vm.dot(wi, wm) + vm.dot(wo, wm) / etap) ** 2
    f_t = (d * (1.0 - fr) * g * (vm.dot(wi, wm) * vm.dot(wo, wm)).abs()
           / torch.clamp((cos_i * cos_o).abs() * denom, min=1e-12))
    if mode == "radiance":
        f_t = f_t / (etap * etap)
    dwm_dwi = vm.absdot(wi, wm) / torch.clamp(denom, min=1e-12)
    pdf_t = pdf_wm * dwm_dwi * (1.0 - fr)
    ok = ~degenerate & ~back & ~smooth
    f = torch.where(ok, torch.where(is_refl, f_r, f_t), 0.0)
    pdf = torch.where(ok, torch.where(is_refl, pdf_r, pdf_t), 0.0)
    return f, pdf


def sample(ctx: MaterialCtx, wo, uc, u2, mode: str = "radiance") -> BSDFSample:
    """Sample_f over lane-tagged materials. uc (...,), u2 (..., 2). mode
    "radiance" for camera paths, "importance" for light transport (no
    1/eta^2 on dielectric transmission)."""
    t = ctx.mat_type
    smooth = effectively_smooth(ctx.ax, ctx.ay)
    flip_z = torch.tensor([1.0, 1.0, -1.0], device=wo.device)
    zeros_b = torch.zeros_like(smooth)
    ones_b = torch.ones_like(smooth)
    conds, wis, fss, pdfs, specs, transs, valids = [], [], [], [], [], [], []

    def lobe(tag, wi, f, pdf, spec, trans, valid):
        conds.append(t == tag)
        wis.append(wi)
        fss.append(f)
        pdfs.append(pdf)
        specs.append(spec)
        transs.append(trans)
        valids.append(valid)

    # cosine hemisphere on wo's side (diffuse, and the default direction)
    wi_diff = sampling.sample_cosine_hemisphere(u2)
    wi_diff = torch.where(wo[..., 2:3] < 0, wi_diff * flip_z, wi_diff)
    pdf_diff = sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi_diff))
    if _has(ctx, scene_mod.MAT_DIFFUSE):
        lobe(scene_mod.MAT_DIFFUSE, wi_diff, ctx.refl * INV_PI, pdf_diff, zeros_b, zeros_b,
             ones_b)
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    wo_up = torch.where(wo[..., 2:3] < 0, -wo, wo)

    if _has(ctx, scene_mod.MAT_CONDUCTOR):
        # a mirror when smooth, else a sampled visible normal
        f_mirror = ctx.refl * _conductor_fresnel(ctx, vm.abs_cos_theta(wo)) / torch.clamp(
            vm.abs_cos_theta(wi_mirror), min=1e-9)[..., None]
        wm = tr_sample_wm(wo_up, u2, ctx.ax, ctx.ay)
        wm = torch.where(wo[..., 2:3] < 0, -wm, wm)
        wi_rough = vm.reflect(wo, wm)
        f_rough, pdf_rough = evaluate(
            ctx._replace(mat_type=torch.full_like(t, scene_mod.MAT_CONDUCTOR),
                         kinds=frozenset({scene_mod.MAT_CONDUCTOR})), wo, wi_rough)
        lobe(scene_mod.MAT_CONDUCTOR, torch.where(smooth[..., None], wi_mirror, wi_rough),
             torch.where(smooth[..., None], f_mirror, f_rough),
             torch.where(smooth, 1.0, pdf_rough), smooth, zeros_b,
             smooth | vm.same_hemisphere(wo, wi_rough))

    eta_out = None
    if _has(ctx, scene_mod.MAT_DIELECTRIC):
        # smooth: Fresnel-weighted reflection or refraction
        frd = fr_dielectric(vm.cos_theta(wo), ctx.eta)
        reflect_choice = uc < frd
        n_local = torch.tensor([0.0, 0.0, 1.0], device=wo.device).expand(wo.shape)
        ok_t, eta_used, wt = vm.refract(wo, n_local, ctx.eta)
        f_refl = (frd / torch.clamp(vm.abs_cos_theta(wi_mirror), min=1e-9))[..., None]
        f_tran = ((1.0 - frd) / torch.clamp(vm.abs_cos_theta(wt), min=1e-9))[..., None]
        if mode == "radiance":
            f_tran = f_tran / (eta_used * eta_used)[..., None]
        wi_s = torch.where(reflect_choice[..., None], wi_mirror, wt)
        f_s = torch.where(reflect_choice[..., None], f_refl, f_tran)
        pdf_s = torch.where(reflect_choice, frd, 1.0 - frd)
        valid_s = reflect_choice | ok_t
        # rough: reflection or refraction at a sampled visible normal
        wm_d = tr_sample_wm(wo_up, u2, ctx.ax, ctx.ay)
        fr_m = fr_dielectric(vm.dot(wo, wm_d), ctx.eta)
        r_choice = uc < fr_m  # total internal reflection: fr_m = 1
        wi_dr = vm.reflect(wo, wm_d)
        ok_rt, eta_rough, wi_dt2 = vm.refract(wo, wm_d, ctx.eta)
        wi_r = torch.where(r_choice[..., None], wi_dr, wi_dt2)
        f_rd, pdf_rd = _rough_dielectric_eval(ctx, wo, wi_r, zeros_b, mode=mode)
        valid_r = torch.where(r_choice, vm.same_hemisphere(wo, wi_dr),
                              ok_rt & ~vm.same_hemisphere(wo, wi_dt2))
        sm1 = smooth[..., None]
        valid_diel = torch.where(smooth, valid_s, valid_r)
        trans_diel = torch.where(smooth, ~reflect_choice, ~r_choice & valid_r)
        lobe(scene_mod.MAT_DIELECTRIC, torch.where(sm1, wi_s, wi_r),
             torch.where(sm1, f_s, f_rd[..., None]).expand(ctx.refl.shape),
             torch.where(smooth, pdf_s, pdf_rd), smooth, trans_diel, valid_diel)
        eta_out = torch.where((t == scene_mod.MAT_DIELECTRIC) & trans_diel,
                              torch.where(smooth, eta_used, eta_rough), 1.0)

    if _has(ctx, scene_mod.MAT_THIN_DIELECTRIC):
        frt = fr_dielectric(vm.cos_theta(wo).abs(), ctx.eta)
        # the slab's inner reflections
        frt = torch.where(frt < 1.0, frt + (1.0 - frt) ** 2 * frt
                          / torch.clamp(1.0 - frt * frt, min=1e-9), frt)
        thin_refl = uc < frt
        f_thin_r = (frt / torch.clamp(vm.abs_cos_theta(wi_mirror), min=1e-9))[..., None]
        f_thin_t = ((1.0 - frt) / torch.clamp(vm.abs_cos_theta(wo), min=1e-9))[..., None]
        lobe(scene_mod.MAT_THIN_DIELECTRIC, torch.where(thin_refl[..., None], wi_mirror, -wo),
             torch.where(thin_refl[..., None], f_thin_r, f_thin_t).expand(ctx.refl.shape),
             torch.where(thin_refl, frt, 1.0 - frt), ones_b, ~thin_refl, ones_b)

    if _has(ctx, scene_mod.MAT_DIFFUSE_TRANSMISSION):
        # one reflectance for both lobes, as the JAX package ("first cut")
        wi_dt = torch.where((uc < 0.5)[..., None], wi_diff, wi_diff * flip_z)
        lobe(scene_mod.MAT_DIFFUSE_TRANSMISSION, wi_dt, ctx.refl * INV_PI,
             0.5 * sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi_dt)), zeros_b,
             ~vm.same_hemisphere(wo, wi_dt), ones_b)

    if _has_coated(ctx):
        # the walk's pdf is only proportional: f is rescaled by the pdf
        # estimate, so f/pdf is kept and the pdf is MIS-consistent; fully
        # specular walks keep the walk's f and pdf
        from . import layered

        lctx, cc = _coat_ctx(ctx)
        wi_lay, f_walk, pdf_walk, valid_lay, spec_lay = layered.coated_sample(
            lctx, wo, uc, u2, cc, mode=mode)
        pdf_lay = layered.coated_pdf(lctx, wo, wi_lay, cc, mode=mode)
        f_lay = f_walk * (pdf_lay / torch.clamp(pdf_walk, min=1e-12))[..., None]
        f_lay = torch.where(spec_lay[..., None], f_walk, f_lay)
        pdf_lay = torch.where(spec_lay, pdf_walk, pdf_lay)
        for tag in (scene_mod.MAT_COATED_DIFFUSE, scene_mod.MAT_COATED_CONDUCTOR):
            lobe(tag, wi_lay, f_lay, pdf_lay, spec_lay, zeros_b, valid_lay)

    if _has(ctx, scene_mod.MAT_SSS_EXIT):
        lobe(scene_mod.MAT_SSS_EXIT, wi_diff,
             sss_exit_f(ctx.eta, vm.abs_cos_theta(wi_diff))[..., None].expand(ctx.refl.shape),
             pdf_diff, zeros_b, zeros_b, ones_b)

    if ctx.h is not None and _has(ctx, scene_mod.MAT_HAIR):
        from . import hair as hair_mod

        sigma_a = hair_mod.sigma_a_from_reflectance(ctx.refl, ctx.ay)
        wi_h, f_h, pdf_h = hair_mod.sample_f(wo, ctx.h, ctx.eta, sigma_a, ctx.ax, ctx.ay, uc, u2)
        lobe(scene_mod.MAT_HAIR, wi_h, f_h, pdf_h, zeros_b, zeros_b, pdf_h > 0)

    if ctx.meas_tab is not None and _has(ctx, scene_mod.MAT_MEASURED):
        from . import measured as meas_mod

        wi_m, f_m, pdf_m = meas_mod.sample_f(ctx.meas_tab, ctx.meas_id, wo, ctx.lam, u2,
                                             uc=uc, alpha=ctx.meas_alpha)
        lobe(scene_mod.MAT_MEASURED, wi_m, f_m, pdf_m, zeros_b, zeros_b, pdf_m > 0)

    conds1 = [c[..., None] for c in conds]
    pdf = _select(conds, pdfs, 0.0)
    if not isinstance(pdf, torch.Tensor):  # no lobe at all
        pdf = torch.zeros_like(uc)
    f = _select(conds1, fss, 0.0)
    if not isinstance(f, torch.Tensor):
        f = torch.zeros_like(ctx.refl)
    valid = _select(conds, valids, zeros_b) & (pdf > 0) & (t >= 0)
    return BSDFSample(
        wi=_select(conds1, wis, wi_diff), f=f, pdf=pdf,
        specular=_select(conds, specs, zeros_b),
        transmission=_select(conds, transs, zeros_b),
        eta=torch.ones_like(pdf) if eta_out is None else eta_out, valid=valid)
