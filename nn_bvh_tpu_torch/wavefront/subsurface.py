"""The subsurface stage of the Path wave (port of
nn_bvh_tpu/wavefront/subsurface.py).

A MAT_SUBSURFACE lane either reflects at the material's smooth dielectric
interface (probability Fr(wo)) or enters it. An entering lane picks a probe
axis (normal .5, tangents .25 each), a wavelength channel and a radius r ~
Sr (scatter/bssrdf.py), then marches a probe segment of length 2h through
the sample disc with N_PROBE closest-hit calls of the integrator's
traversal, keeping one of the hits on the same material by reservoir
sampling. The lane's shading point moves to that hit, beta takes Sp /
PDF_Sp (the 3-axis x 4-channel MIS pdf), and the lane continues with the
normalized Fresnel exit lobe (MAT_SSS_EXIT); a reflecting lane continues as
a mirror. Random numbers are the JAX package's: hashes of (pixel, sample,
depth, salt) with salts 0x5501-0x5505 and 0x5510 + k.

The JAX package runs this stage in Path only: VolPath never calls it, and
the BSDF has no subsurface branch, so a subsurface lane in VolPath ends
there. The port mirrors that.
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm, rng, rgb2spec
from ..geometry import scene as scene_mod
from ..scatter import bxdf, bssrdf as bss
from ..accel.traverse import Hit

N_PROBE = 3  # closest-hit marches per probe segment


def _sss_table(scene, s: int) -> bss.BSSRDFTable:
    return bss.BSSRDFTable(rho=scene.sss_rho, radius=scene.sss_radius,
                           profile=scene.sss_profile[s], cdf=scene.sss_cdf[s],
                           rho_eff=scene.sss_rho_eff[s])


def _per_material(scene, sssid, fn):
    """fn(table) for each subsurface material, selected per lane (one table
    per material, so an unrolled select)."""
    out = fn(_sss_table(scene, 0))
    single = isinstance(out, torch.Tensor)
    for s in range(1, scene.sss_g.shape[0]):
        val = fn(_sss_table(scene, s))
        sel = sssid == s
        pick = lambda a, b: torch.where(sel.reshape(sel.shape + (1,) * (a.dim() - sel.dim())),
                                        b, a)
        out = pick(out, val) if single else tuple(map(pick, out, val))
    return out


def transition(scene, isect_closest, shading_point_fn, sp, wo, wo_local, ctx, lam, beta,
               active, pixel_idx, sidx, depth: int):
    """Resolve the MAT_SUBSURFACE lanes: a mirror at the interface, or the
    shading point moved through the medium to a sampled exit point.
    -> (sp, ctx, wo_local, beta, active)."""
    is_sss = active & (ctx.mat_type == scene_mod.MAT_SUBSURFACE)
    h_rand = lambda salt: rng.hash_float(pixel_idx, sidx, depth, salt)
    u_entry, u_axis, u_ch, u_r, u_phi = (h_rand(0x5501 + i) for i in range(5))

    fr = bxdf.fr_dielectric(vm.abs_cos_theta(wo_local), ctx.eta)
    enter = is_sss & (u_entry >= fr)
    mirror = is_sss & ~enter

    # scattering coefficients at the sampled wavelengths
    n_sss = scene.sss_g.shape[0]
    sssid = scene.mat_params[torch.clamp(sp.mat, min=0).long(), 3].to(torch.int64)
    sssid = torch.clamp(sssid, 0, n_sss - 1)
    sig_a = rgb2spec.eval_sigmoid_poly(scene.sss_coeffs_a[sssid], lam) \
        * scene.sss_scale_a[sssid][..., None]
    sig_s = rgb2spec.eval_sigmoid_poly(scene.sss_coeffs_s[sssid], lam) \
        * scene.sss_scale_s[sssid][..., None]
    sigma_t = sig_a + sig_s
    rho = sig_s / torch.clamp(sigma_t, min=1e-9)

    # channel, axis and radius
    S = sigma_t.shape[-1]
    ch = torch.clamp((u_ch * S).to(torch.int64), 0, S - 1)
    st_ch = torch.gather(sigma_t, -1, ch[..., None])[..., 0]
    rho_ch = torch.gather(rho, -1, ch[..., None])[..., 0]
    r, rmax = _per_material(scene, sssid, lambda t: (bss.sr_sample(t, st_ch, rho_ch, u_r)[0],
                                                     bss.r_max(t, st_ch, rho_ch)))
    r = torch.minimum(r, rmax * 0.999)
    h = torch.sqrt(torch.clamp(rmax * rmax - r * r, min=0.0))

    ns = sp.ns
    t1, t2 = vm.coordinate_system(ns)
    ax_sel = torch.where(u_axis < 0.5, 0, torch.where(u_axis < 0.75, 1, 2))
    a0, a1 = (ax_sel == 0)[..., None], (ax_sel == 1)[..., None]
    axis_v = torch.where(a0, ns, torch.where(a1, t1, t2))
    va = torch.where(a0, t1, torch.where(a1, t2, ns))
    vb = torch.where(a0, t2, torch.where(a1, ns, t1))
    phi = 2.0 * math.pi * u_phi
    disc = (r * torch.cos(phi))[..., None] * va + (r * torch.sin(phi))[..., None] * vb
    p_start = sp.p + disc + h[..., None] * axis_v
    d_probe = -axis_v
    seg_len = 2.0 * h

    # iterated closest-hit march, one same-material hit kept by reservoir
    o_k = p_start
    t_rem = torch.where(enter, seg_len, -1.0)
    n_found = torch.zeros_like(u_r, dtype=torch.int32)
    best_prim = torch.full_like(n_found, -1)
    best_b1 = torch.zeros_like(u_r)
    best_b2 = torch.zeros_like(u_r)
    best_p = sp.p
    eps = 1e-4 * torch.clamp(seg_len, min=1.0)
    for k in range(N_PROBE):
        hit = isect_closest(o_k, d_probe, t_rem)
        found = enter & (hit.prim >= 0)
        hmat = scene.tri_shade[torch.clamp(hit.prim, min=0).long(), 24].to(torch.int32)
        same = found & (hmat == sp.mat)
        n_new = n_found + same.to(torch.int32)
        u_k = h_rand(0x5510 + k)
        take = same & (u_k * n_new.to(torch.float32) < 1.0)
        t_fin = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
        best_prim = torch.where(take, hit.prim, best_prim)
        best_b1 = torch.where(take, hit.b1, best_b1)
        best_b2 = torch.where(take, hit.b2, best_b2)
        best_p = torch.where(take[..., None], o_k + t_fin[..., None] * d_probe, best_p)
        n_found = n_new
        step = t_fin + eps
        o_k = torch.where(found[..., None], o_k + step[..., None] * d_probe, o_k)
        t_rem = torch.where(found, t_rem - step, -1.0)
    ok = enter & (n_found > 0)

    # the exit shading point
    exit_hit = Hit(t=torch.zeros_like(u_r), prim=torch.clamp(best_prim, min=0),
                   b1=best_b1, b2=best_b2)
    sp_exit = shading_point_fn(scene, exit_hit, best_p, d_probe)._replace(p=best_p)

    # Sp / PDF_Sp
    dist = vm.length(best_p - sp.p)
    sp_val = _per_material(scene, sssid, lambda t: bss.sr_eval(t, sigma_t, rho,
                                                              dist[..., None]))
    d_vec = sp.p - best_p
    d_local = torch.stack([vm.dot(ns, d_vec), vm.dot(t1, d_vec), vm.dot(t2, d_vec)], -1)
    n_exit = sp_exit.ns
    n_local = torch.stack([vm.dot(ns, n_exit), vm.dot(t1, n_exit), vm.dot(t2, n_exit)],
                          -1).abs()
    r_proj = torch.stack([torch.sqrt(d_local[..., 1] ** 2 + d_local[..., 2] ** 2),
                          torch.sqrt(d_local[..., 2] ** 2 + d_local[..., 0] ** 2),
                          torch.sqrt(d_local[..., 0] ** 2 + d_local[..., 1] ** 2)], -1)
    ax_prob = (0.5, 0.25, 0.25)
    pdf = torch.zeros_like(u_r)
    for a in range(3):
        for c in range(4):
            pdf_rc = _per_material(scene, sssid, lambda t, a=a, c=c: bss.sr_pdf(
                t, sigma_t[..., c], rho[..., c], r_proj[..., a]))
            pdf = pdf + ax_prob[a] * 0.25 * pdf_rc * n_local[..., a]
    w_sp = sp_val * (n_found.to(torch.float32) / torch.clamp(pdf, min=1e-12))[..., None]
    w_sp = torch.where(torch.isfinite(w_sp), w_sp, 0.0)

    # merge: exit lanes take the exit point and the Sp weight
    okn = ok[..., None]
    sp = type(sp)(*(torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - ok.dim())), b, a)
                    for a, b in zip(sp, sp_exit)))
    beta = torch.where(okn, beta * w_sp, beta)
    active = active & (~enter | ok)
    # exit lanes: the normalized Fresnel lobe; mirror lanes: a perfect mirror
    new_type = torch.where(ok, scene_mod.MAT_SSS_EXIT,
                           torch.where(mirror, scene_mod.MAT_CONDUCTOR, ctx.mat_type))
    zero_a = torch.where(ok | mirror, 0.0, ctx.ax)
    ctx = ctx._replace(mat_type=new_type.to(torch.int32), k=torch.where(mirror, 1e6, ctx.k),
                       refl=torch.where((ok | mirror)[..., None], 1.0, ctx.refl),
                       ax=zero_a, ay=zero_a)
    # the exit's wo lies along the exit normal (cos = 1)
    wo_local = torch.where(okn, torch.tensor([0.0, 0.0, 1.0], device=wo_local.device),
                           wo_local)
    return sp, ctx, wo_local, beta, active
