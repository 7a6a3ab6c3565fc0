"""Stochastic layered BSDF: coated diffuse and coated conductor (port of
nn_bvh_tpu/scatter/layered.py).

A dielectric coat over a diffuse or conductor base, evaluated by a random
walk between the two interfaces, vectorized over lanes with a fixed
unrolled depth and a stateless hash RNG seeded from the query directions.
Scope as in the JAX package: no medium between the interfaces (albedo 0)
and the coat thickness fixed at 0.01. Both coated materials are two-sided:
a query with wo.z < 0 flips the frame.

- `coated_f`: stochastic estimate of f(wo, wi): the coat's reflection plus
  a random walk with NEE through the exit interface.
- `coated_pdf`: stochastic pdf estimate, lerped 0.9 against the uniform
  sphere.
- `coated_sample`: the walk's Sample_f; its pdf is only proportional, and
  bxdf.sample rescales f by coated_pdf / pdf.

The hashes are the JAX package's bit for bit: uint32 arithmetic runs in
int64 masked to 32 bits (`core/rng.py`), float bits are read through an
int32 view of the float32 tensor, and the walk's draws, and so its
estimates, equal JAX's for the same direction bits.
"""

from __future__ import annotations

import torch

from ..core import sampling, rng
from ..core import vecmath as vm

THICKNESS = 0.01
_SMOOTH_EPS = 1e-3
INV_4PI = sampling.INV_4PI
M32 = rng.M32


def _mix(h):
    """murmur3-style 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = rng.mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = rng.mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _bits(x):
    """The float32 bits of x as uint32 values in int64."""
    return x.detach().to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32


def _hash_vec(v, salt: int):
    """(..., 3) float32 -> (...,) uint32 lane hash."""
    b = _bits(v)
    h = rng.u32(salt, v.device)
    for i in range(3):
        h = _mix(h ^ rng.mul32(b[..., i], 0x9E3779B9))
    return h


def _u01(h1, h2, j: int):
    """The j-th uniform draw of the lane keys (h1, h2)."""
    h = _mix(h1 ^ _mix((h2 + ((j * 0x632BE59B + 0x1B873593) & M32)) & M32))
    return torch.clamp((h >> 8).to(torch.float32) * (2.0 ** -24), max=1.0 - 2.0 ** -24)


class _Rng:
    """Static-counter draws (each next() is a new hash)."""

    def __init__(self, h1, h2):
        self.h1, self.h2 = h1, h2
        self.j = 0

    def next(self):
        u = _u01(self.h1, self.h2, self.j)
        self.j += 1
        return u

    def next2(self):
        return torch.stack([self.next(), self.next()], -1)


def _tr(dz: float, w):
    """Transmittance through the gap."""
    az = torch.clamp(w[..., 2].abs(), min=1e-7)
    return torch.exp(-abs(dz) / az)


def _dielectric_ctx(eta, alpha):
    from . import bxdf as bx

    return bx.MaterialCtx(mat_type=None, refl=None, ax=alpha, ay=alpha, eta=eta, k=None)


def _diel_sample(wo, eta, alpha, rng_: _Rng, flags: str, mode: str, uc=None, u2=None):
    """DielectricBxDF::Sample_f, smooth or rough per lane. flags 'all' |
    'refl' | 'trans'; a restricted pdf is renormalized by its choice. uc and
    u2 override the walk's RNG (the entrance uses the caller's sampler).
    -> (wi, f (...,), pdf, valid, is_trans, is_spec)."""
    from . import bxdf as bx

    if uc is None:
        uc = rng_.next()
    if u2 is None:
        u2 = rng_.next2()
    smooth = alpha < _SMOOTH_EPS
    lane = wo.shape[:-1]
    dev = wo.device

    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    frd = bx.fr_dielectric(vm.cos_theta(wo), eta)
    n_local = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(wo.shape)
    ok_t, etap_s, wt = vm.refract(wo, n_local, eta)
    if flags == "refl":
        choose_r_s = torch.ones(lane, dtype=torch.bool, device=dev)
        pdf_s = torch.ones_like(frd)
        f_s = frd / torch.clamp(vm.abs_cos_theta(wi_mirror), min=1e-9)
    elif flags == "trans":
        choose_r_s = torch.zeros(lane, dtype=torch.bool, device=dev)
        pdf_s = torch.ones_like(frd)
        f_s = (1.0 - frd) / torch.clamp(vm.abs_cos_theta(wt), min=1e-9)
        if mode == "radiance":
            f_s = f_s / torch.clamp(etap_s * etap_s, min=1e-9)
    else:
        choose_r_s = uc < frd
        pdf_s = torch.where(choose_r_s, frd, 1.0 - frd)
        f_r = frd / torch.clamp(vm.abs_cos_theta(wi_mirror), min=1e-9)
        f_t = (1.0 - frd) / torch.clamp(vm.abs_cos_theta(wt), min=1e-9)
        if mode == "radiance":
            f_t = f_t / torch.clamp(etap_s * etap_s, min=1e-9)
        f_s = torch.where(choose_r_s, f_r, f_t)
    wi_s = torch.where(choose_r_s[..., None], wi_mirror, wt)
    valid_s = torch.where(choose_r_s, frd > 0, ok_t & (frd < 1))

    wo_up = torch.where(wo[..., 2:3] < 0, -wo, wo)
    wm = bx.tr_sample_wm(wo_up, u2, alpha, alpha)
    fr_m = bx.fr_dielectric(vm.dot(wo, wm), eta)
    if flags == "refl":
        choose_r = torch.ones(lane, dtype=torch.bool, device=dev)
    elif flags == "trans":
        choose_r = torch.zeros(lane, dtype=torch.bool, device=dev)
    else:
        choose_r = uc < fr_m
    wi_r = vm.reflect(wo, wm)
    ok_rt, _, wi_t = vm.refract(wo, wm, eta)
    wi_rough = torch.where(choose_r[..., None], wi_r, wi_t)
    f_full, pdf_full = bx._rough_dielectric_eval(
        _dielectric_ctx(eta, alpha), wo, wi_rough,
        torch.zeros(lane, dtype=torch.bool, device=dev), mode=mode)
    if flags == "refl":
        pdf_r_ = pdf_full / torch.clamp(fr_m, min=1e-9)
        valid_r = vm.same_hemisphere(wo, wi_rough) & (fr_m > 0)
    elif flags == "trans":
        pdf_r_ = pdf_full / torch.clamp(1.0 - fr_m, min=1e-9)
        valid_r = ok_rt & ~vm.same_hemisphere(wo, wi_rough) & (fr_m < 1)
    else:
        pdf_r_ = pdf_full
        valid_r = torch.where(choose_r, vm.same_hemisphere(wo, wi_rough),
                              ok_rt & ~vm.same_hemisphere(wo, wi_rough))

    wi = torch.where(smooth[..., None], wi_s, wi_rough)
    f = torch.where(smooth, f_s, f_full)
    pdf = torch.where(smooth, pdf_s, pdf_r_)
    valid = torch.where(smooth, valid_s, valid_r) & (wi[..., 2].abs() > 1e-7)
    return wi, f, pdf, valid, ~vm.same_hemisphere(wo, wi), smooth


def _diel_f_pdf(wo, wi, eta, alpha, mode: str, flags: str = "all"):
    """DielectricBxDF::f / ::PDF, zero on smooth (delta) lanes; flags
    restricts the reported component (renormalized)."""
    from . import bxdf as bx

    smooth = alpha < _SMOOTH_EPS
    f, pdf = bx._rough_dielectric_eval(_dielectric_ctx(eta, alpha), wo, wi, smooth, mode=mode)
    if flags != "all":
        is_refl = vm.same_hemisphere(wo, wi)
        cos_o = vm.cos_theta(wo)
        etap = torch.where(is_refl, 1.0,
                           torch.where(cos_o > 0, eta, 1.0 / torch.clamp(eta, min=1e-9)))
        wm = wi * etap[..., None] + wo
        wm = vm.normalize(torch.where((vm.length_squared(wm) < 1e-16)[..., None], wo, wm))
        wm = torch.where(wm[..., 2:3] < 0, -wm, wm)
        fr = bx.fr_dielectric(vm.dot(wo, wm), eta)
        if flags == "refl":
            pdf = torch.where(is_refl, pdf / torch.clamp(fr, min=1e-9), 0.0)
            f = torch.where(is_refl, f, 0.0)
        else:
            pdf = torch.where(is_refl, 0.0, pdf / torch.clamp(1.0 - fr, min=1e-9))
            f = torch.where(is_refl, 0.0, f)
    return f, pdf


def _base_f_pdf(ctx, cc, wo, wi):
    """Base f and pdf: diffuse for coated diffuse, conductor for coated
    conductor (cc), the lobes' own math (not bxdf.evaluate, which would
    price every lobe each step)."""
    from . import bxdf as bx

    refl_side = vm.same_hemisphere(wo, wi)
    abs_ci = vm.abs_cos_theta(wi)
    f_d = torch.where(refl_side[..., None], ctx.refl * sampling.INV_PI, 0.0)
    pdf_d = torch.where(refl_side, sampling.cosine_hemisphere_pdf(abs_ci), 0.0)
    smooth = bx.effectively_smooth(ctx.ax, ctx.ay)
    wm = wi + wo
    wm_len2 = vm.length_squared(wm)
    wm_n = vm.normalize(torch.where((wm_len2 < 1e-12)[..., None], wo, wm))
    wm_n = torch.where(wm_n[..., 2:3] < 0, -wm_n, wm_n)
    valid_m = (wm_len2 > 1e-12) & refl_side & ~smooth
    fr_s = bx._conductor_fresnel(ctx, vm.absdot(wo, wm_n))
    d_ggx = bx.tr_d(wm_n, ctx.ax, ctx.ay)
    g_ggx = bx.tr_g(wo, wi, ctx.ax, ctx.ay)
    denom = torch.clamp(4.0 * vm.abs_cos_theta(wo) * abs_ci, min=1e-9)
    f_c = torch.where(valid_m[..., None],
                      ctx.refl * fr_s * (d_ggx * g_ggx / denom)[..., None], 0.0)
    pdf_c = torch.where(valid_m, bx.tr_pdf(wo, wm_n, ctx.ax, ctx.ay)
                        / torch.clamp(4.0 * vm.absdot(wo, wm_n), min=1e-9), 0.0)
    return torch.where(cc[..., None], f_c, f_d), torch.where(cc, pdf_c, pdf_d)


def _base_sample(ctx, cc, wo, rng_: _Rng):
    """Base Sample_f (reflection only) -> (wi, f (..., 4), pdf, valid,
    is_spec)."""
    from . import bxdf as bx

    rng_.next()  # the draw order of the reference (uc is unused here)
    u2 = rng_.next2()
    flip_z = torch.tensor([1.0, 1.0, -1.0], device=wo.device)
    wi_d = sampling.sample_cosine_hemisphere(u2)
    wi_d = torch.where(wo[..., 2:3] < 0, wi_d * flip_z, wi_d)
    pdf_d = sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi_d))
    f_d = ctx.refl * sampling.INV_PI
    smooth_c = bx.effectively_smooth(ctx.ax, ctx.ay)
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    f_mirror = ctx.refl * bx._conductor_fresnel(ctx, vm.abs_cos_theta(wo)) / torch.clamp(
        vm.abs_cos_theta(wi_mirror), min=1e-9)[..., None]
    wo_up = torch.where(wo[..., 2:3] < 0, -wo, wo)
    wm = bx.tr_sample_wm(wo_up, u2, ctx.ax, ctx.ay)
    wm = torch.where(wo[..., 2:3] < 0, -wm, wm)
    wi_r = vm.reflect(wo, wm)
    f_r, pdf_r = _base_f_pdf(ctx, cc, wo, wi_r)
    wi_c = torch.where(smooth_c[..., None], wi_mirror, wi_r)
    f_c = torch.where(smooth_c[..., None], f_mirror, f_r)
    pdf_c = torch.where(smooth_c, 1.0, pdf_r)
    valid_c = smooth_c | vm.same_hemisphere(wo, wi_r)
    wi = torch.where(cc[..., None], wi_c, wi_d)
    f = torch.where(cc[..., None], f_c, f_d)
    pdf = torch.where(cc, pdf_c, pdf_d)
    valid = torch.where(cc, valid_c, pdf_d > 0)
    return wi, f, pdf, valid & (wi[..., 2].abs() > 1e-7), cc & smooth_c


def _coat_params(ctx, cc):
    """(coat eta, coat alpha): ctx.eta for coated diffuse, 1.5 for coated
    conductor (whose ctx.eta is the conductor's)."""
    coat_eta = torch.where(cc, 1.5, ctx.eta)
    c = ctx.coat_ax if ctx.coat_ax is not None else torch.zeros_like(ctx.eta)
    return coat_eta, c


def _sign(wo):
    """The two-sided frame's sign (..., 1): -1 where wo.z < 0."""
    return torch.where(wo[..., 2:3] < 0, -1.0, 1.0)


def _lane_rng(h1, h2, s: int) -> _Rng:
    return _Rng(h1, _mix((h2 + ((s * 0x68BC21EB) & M32)) & M32))


def coated_f(ctx, wo, wi, cc, mode: str = "radiance", max_depth: int = 10,
             n_samples: int = 1, seed: int = 0):
    """Stochastic estimate of the layered f(wo, wi) -> (..., 4); cc per
    lane: True for a conductor base. Only reflection is nonzero."""
    sgn = _sign(wo)
    wo = wo * sgn
    wi = wi * sgn
    refl_case = wi[..., 2] > 0
    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wo, 0x51AB0F00 + seed)
    h2 = _hash_vec(wi, 0x2C1B3C6D)

    f_top, _ = _diel_f_pdf(wo, wi, coat_eta, coat_ax, mode)
    f = (n_samples * f_top)[..., None] * torch.ones(4, device=wo.device)
    imode = "importance" if mode == "radiance" else "radiance"
    for s in range(n_samples):
        rng_ = _lane_rng(h1, h2, s)
        wos_wi, wos_f, wos_pdf, wos_ok, _, _ = _diel_sample(wo, coat_eta, coat_ax, rng_,
                                                            "trans", mode)
        wis_wi, wis_f, wis_pdf, wis_ok, _, top_spec = _diel_sample(
            wi, coat_eta, coat_ax, rng_, "trans", imode)
        ok = wos_ok & wis_ok & (wos_f > 0) & (wis_f > 0)
        beta = (wos_f * vm.abs_cos_theta(wos_wi) / torch.clamp(wos_pdf, min=1e-12))[..., None]
        beta = torch.where(ok[..., None], beta, 0.0)
        w = wos_wi
        wis_fac = wis_f * vm.abs_cos_theta(wis_wi) / torch.clamp(wis_pdf, min=1e-12)
        contrib = torch.zeros_like(f)
        for depth in range(max_depth):
            beta = beta * _tr(THICKNESS, w)[..., None]
            if depth % 2 == 0:
                # at the base: NEE through the exit interface along wis
                f_b, pdf_b = _base_f_pdf(ctx, cc, -w, -wis_wi)
                wt = torch.where(top_spec, 1.0,
                                 sampling.power_heuristic(1.0, wis_pdf, 1.0, pdf_b))
                contrib = contrib + beta * f_b * (wt * _tr(THICKNESS, wis_wi)
                                                  * wis_fac)[..., None]
                bs_wi, bs_f, bs_pdf, bs_ok, base_spec = _base_sample(ctx, cc, -w, rng_)
                beta = beta * bs_f * (vm.abs_cos_theta(bs_wi)
                                      / torch.clamp(bs_pdf, min=1e-12))[..., None]
                beta = torch.where(bs_ok[..., None], beta, 0.0)
                w = bs_wi
                # NEE exit along the sampled direction (rough coat only)
                fx, _ = _diel_f_pdf(-w, wi, coat_eta, coat_ax, mode)
                _, x_pdf = _diel_f_pdf(-w, wi, coat_eta, coat_ax, mode, flags="trans")
                wt2 = torch.where(base_spec, 1.0,
                                  sampling.power_heuristic(1.0, bs_pdf, 1.0, x_pdf))
                contrib = contrib + beta * torch.where(
                    top_spec, 0.0, _tr(THICKNESS, w) * fx * wt2)[..., None]
            else:
                # back down off the coat
                bs_wi, bs_f, bs_pdf, bs_ok, _, _ = _diel_sample(-w, coat_eta, coat_ax, rng_,
                                                                "refl", mode)
                beta = beta * (bs_f * vm.abs_cos_theta(bs_wi)
                               / torch.clamp(bs_pdf, min=1e-12))[..., None]
                beta = torch.where(bs_ok[..., None], beta, 0.0)
                w = bs_wi
        f = f + contrib
    f = f / n_samples
    return torch.where(refl_case[..., None], f, 0.0)


def coated_pdf(ctx, wo, wi, cc, mode: str = "radiance", n_samples: int = 1, seed: int = 0):
    """Stochastic pdf estimate: the coat's reflection pdf plus an
    MIS-weighted TRT estimate, lerped 0.9 toward the uniform sphere."""
    sgn = _sign(wo)
    wo = wo * sgn
    wi = wi * sgn
    refl_case = wi[..., 2] > 0
    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wi, 0x7F4A7C15 + seed)
    h2 = _hash_vec(wo, 0x94D049BB)

    _, pdf_top = _diel_f_pdf(wo, wi, coat_eta, coat_ax, mode, flags="refl")
    top_smooth = coat_ax < _SMOOTH_EPS
    pdf_sum = n_samples * torch.where(top_smooth, 0.0, pdf_top)
    imode = "importance" if mode == "radiance" else "radiance"
    for s in range(n_samples):
        rng_ = _lane_rng(h1, h2, s)
        wos_wi, wos_f, wos_pdf, wos_ok, _, _ = _diel_sample(wo, coat_eta, coat_ax, rng_,
                                                            "trans", mode)
        wis_wi, wis_f, wis_pdf, wis_ok, _, _ = _diel_sample(wi, coat_eta, coat_ax, rng_,
                                                            "trans", imode)
        ok = wos_ok & wis_ok & (wos_f > 0) & (wis_f > 0)
        # smooth coat: the walk's density is the base reflection's
        _, r_pdf_spec = _base_f_pdf(ctx, cc, -wos_wi, -wis_wi)
        # rough coat: the MIS combination of the TRT estimate
        rs_wi, rs_f, rs_pdf, rs_ok, rs_spec = _base_sample(ctx, cc, -wos_wi, rng_)
        _, r_pdf = _base_f_pdf(ctx, cc, -wos_wi, -wis_wi)
        wt_r = sampling.power_heuristic(1.0, wis_pdf, 1.0, r_pdf)
        _, t_pdf = _diel_f_pdf(-rs_wi, wi, coat_eta, coat_ax, mode)
        wt_t = sampling.power_heuristic(1.0, rs_pdf, 1.0, t_pdf)
        mis_est = torch.where(rs_ok, wt_r * r_pdf + wt_t * t_pdf, 0.0)
        mis_est = torch.where(rs_spec, torch.where(rs_ok, t_pdf, 0.0), mis_est)
        pdf_sum = pdf_sum + torch.where(ok, torch.where(top_smooth, r_pdf_spec, mis_est), 0.0)
    pdf = 0.1 * INV_4PI + 0.9 * pdf_sum / n_samples
    return torch.where(refl_case, pdf, INV_4PI * 0.1)


def coated_sample(ctx, wo, uc, u2, cc, mode: str = "radiance", max_depth: int = 10,
                  seed: int = 0):
    """The random walk's Sample_f -> (wi, f (..., 4), pdf proportional to
    the density, valid, is_specular)."""
    sgn = _sign(wo)
    wo_f = wo * sgn
    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wo_f, 0x2545F491 + seed)
    h2 = _mix(_bits(uc) ^ _hash_vec(torch.cat([u2, uc[..., None]], -1), 0x63D83595))
    rng_ = _Rng(h1, h2)

    # the entrance samples the whole coat with the caller's dimensions;
    # a reflection exits at once
    e_wi, e_f, e_pdf, e_ok, e_trans, e_spec = _diel_sample(wo_f, coat_eta, coat_ax, rng_,
                                                           "all", mode, uc=uc, u2=u2)
    # the cosine is folded in only for directions inside the layers
    f_w = (e_f * torch.where(e_trans, vm.abs_cos_theta(e_wi), 1.0))[..., None] * torch.ones(
        4, device=wo.device)
    pdf_w = e_pdf
    w = e_wi
    ok = e_ok
    spec_path = e_spec
    out_wi = e_wi
    out_done = ~e_trans
    for depth in range(max_depth):
        f_w = torch.where(out_done[..., None], f_w, f_w * _tr(THICKNESS, w)[..., None])
        upd = ~out_done
        if depth % 2 == 0:
            bs_wi, bs_f, bs_pdf, bs_ok, bs_spec = _base_sample(ctx, cc, -w, rng_)
            ok = ok & torch.where(upd, bs_ok, True)
            f_w = torch.where(upd[..., None], f_w * bs_f * vm.abs_cos_theta(bs_wi)[..., None],
                              f_w)
            pdf_w = torch.where(upd, pdf_w * bs_pdf, pdf_w)
            spec_path = spec_path & torch.where(upd, bs_spec, True)
            w = torch.where(upd[..., None], bs_wi, w)
        else:
            bs_wi, bs_f, bs_pdf, bs_ok, bs_trans, bs_spec = _diel_sample(
                -w, coat_eta, coat_ax, rng_, "all", mode)
            ok = ok & torch.where(upd, bs_ok, True)
            pdf_w = torch.where(upd, pdf_w * bs_pdf, pdf_w)
            spec_path = spec_path & torch.where(upd, bs_spec, True)
            exiting = upd & bs_trans
            # an exit has no cosine (the integrator applies |cos wi|)
            f_w = torch.where(upd[..., None], f_w * bs_f[..., None], f_w)
            f_w = torch.where((upd & ~bs_trans)[..., None],
                              f_w * vm.abs_cos_theta(bs_wi)[..., None], f_w)
            out_wi = torch.where(exiting[..., None], bs_wi, out_wi)
            out_done = out_done | bs_trans
            w = torch.where(upd[..., None], bs_wi, w)
    valid = ok & out_done & (pdf_w > 0)
    wi_out = torch.where(out_done[..., None], out_wi, w) * sgn
    return wi_out, f_w, pdf_w, valid, spec_path
