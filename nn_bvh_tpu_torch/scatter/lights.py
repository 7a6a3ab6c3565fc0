"""Light sampling over the fused light table (port of
nn_bvh_tpu/scatter/lights.py).

The (L, 20) light record: [0 type | 1:4 pos | 4:7 coeffs | 7 scale |
8:20 params], built from the scene tensors so autograd can reach
light_coeffs / light_scale. `sample_li` computes the branch of each light
tag the scene holds (`scene_tags`, one host read a wave) and picks one per
lane, as the JAX package's select does over every tag:

- point and spot (smoothstep falloff) lights, distant lights;
- projection lights (an image over a square frustum) and goniometric
  lights (an equal-area intensity map over directions): point lights
  scaled by one texture lookup each, computed only when the scene holds
  that tag;
- uniform infinite lights and the equal-area env map (importance sampled
  through its marginal and conditional cdfs);
- the portal env light: the env map restricted to a quad, sampled through
  the rectified image's SAT (scatter/portal.py), or by uniform area on the
  quad when the scene has no warp tables;
- area triangles by solid angle (spherical triangle), with an area-sampling
  fallback for tiny angles;
- analytic sphere area lights by the cone they subtend (uniform area from
  inside).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vecmath as vm, sampling, spectrum, rgb2spec
from ..geometry import scene as scene_mod, texture, triangle

DELTA_TAGS = (scene_mod.LIGHT_POINT, scene_mod.LIGHT_DISTANT, scene_mod.LIGHT_SPOT,
              scene_mod.LIGHT_PROJECTION, scene_mod.LIGHT_GONIOMETRIC)


class LightLiSample(NamedTuple):
    wi: torch.Tensor        # (..., 3) world
    dist: torch.Tensor      # (...,) distance to the light point (inf if infinite)
    li: torch.Tensor        # (..., 4) spectral radiance
    pdf: torch.Tensor       # (...,) solid-angle pdf (1 for delta lights)
    is_delta: torch.Tensor  # (...,) bool
    valid: torch.Tensor     # (...,) bool


def light_records(scene) -> torch.Tensor:
    return torch.cat([scene.light_type[:, None].to(torch.float32), scene.light_pos,
                      scene.light_coeffs, scene.light_scale[:, None],
                      scene.light_params], -1)


def light_types(scene) -> list:
    """The tag of each light of `scene` (one host read of light_type)."""
    return scene_mod.host(scene.light_type).tolist()


def scene_tags(scene) -> frozenset:
    """The light tags of `scene` (one host read of light_type)."""
    return frozenset(light_types(scene))


def portal_ids(types: list) -> list:
    """The ids of the portal lights among `types` (light_types)."""
    return [i for i, t in enumerate(types) if t == scene_mod.LIGHT_PORTAL_ENV]


def record_spectrum(rec, lam):
    """Emission spectrum of a gathered record (RGBIlluminantSpectrum)."""
    return (rgb2spec.eval_sigmoid_poly(rec[..., 4:7], lam)
            * spectrum.illuminant_d_normalized(lam) * rec[..., 7:8])


def area_light_l_rec(light_rec, has_light, ng, w_out, lam):
    """Radiance toward w_out from a hit on an emissive surface."""
    two_sided = light_rec[..., 9] > 0
    front = vm.dot(ng, w_out) > 0
    emit = has_light & (front | two_sided)
    return torch.where(emit[..., None], record_spectrum(light_rec, lam), 0.0)


def _portal_window(to_local, q0, q2, p):
    """The portal's (x0, y0, x1, y1) window in the rectified image seen from
    p, and whether both corners lie in front of the frame."""
    from . import portal as portal_mod

    uv0, _, v0ok = portal_mod.image_from_dir_local(to_local(vm.normalize(q0 - p)))
    uv1, _, v1ok = portal_mod.image_from_dir_local(to_local(vm.normalize(q2 - p)))
    return (torch.minimum(uv0[..., 0], uv1[..., 0]), torch.minimum(uv0[..., 1], uv1[..., 1]),
            torch.maximum(uv0[..., 0], uv1[..., 0]), torch.maximum(uv0[..., 1], uv1[..., 1]),
            v0ok & v1ok)


def _frame_to_local(scene):
    fx, fy, fz = scene.portal_frame[0], scene.portal_frame[1], scene.portal_frame[2]
    return lambda v: torch.stack([(v * fx).sum(-1), (v * fy).sum(-1), (v * fz).sum(-1)], -1)


def _sample_portal(scene, rec, p, u2, lam, emit):
    """Portal env light: (wi, pdf, li)."""
    q0, q1, q2, q3 = rec[..., 8:11], rec[..., 11:14], rec[..., 14:17], rec[..., 17:20]
    if scene.portal_sat is not None:
        from . import portal as portal_mod

        to_local = _frame_to_local(scene)
        x0, y0, x1, y1, corners_ok = _portal_window(to_local, q0, q2, p)
        xs, ys, pdf_uv, ok_w = portal_mod.sample_windowed(scene.portal_sat, u2, x0, y0, x1, y1)
        wloc, duv_dw = portal_mod.dir_from_image_local(torch.stack([xs, ys], -1))
        fx, fy, fz = scene.portal_frame[0], scene.portal_frame[1], scene.portal_frame[2]
        wi = wloc[..., 0:1] * fx + wloc[..., 1:2] * fy + wloc[..., 2:3] * fz
        pdf = torch.where(corners_ok & ok_w, pdf_uv / torch.clamp(duv_dw, min=1e-9), 0.0)
        res = scene.portal_img_coeffs.shape[0]
        pxi = torch.clamp((xs * res).to(torch.int64), 0, res - 1)
        pyi = torch.clamp((ys * res).to(torch.int64), 0, res - 1)
        tex = scene.portal_img_coeffs[pyi, pxi]
        li = (rgb2spec.eval_sigmoid_poly(tex[..., 0:3], lam) * tex[..., 3:4]
              * spectrum.illuminant_d_normalized(lam) * env_scale_total(scene))
        return wi, pdf, li
    # no warp tables: a uniform point on the quad
    qp = vm.lerp(u2[..., 0:1], vm.lerp(u2[..., 1:2], q0, q3), vm.lerp(u2[..., 1:2], q1, q2))
    to_q = qp - p
    d2q = torch.clamp(vm.length_squared(to_q), min=1e-12)
    wi = to_q * torch.rsqrt(d2q)[..., None]
    cos_q = vm.absdot(vm.normalize(vm.cross(q1 - q0, q3 - q0)), wi)
    area_q = vm.length(vm.cross(q1 - q0, q3 - q0))
    pdf = d2q / torch.clamp(cos_q * area_q, min=1e-12)
    li = env_le(scene, wi, lam) if has_env_map(scene) else emit
    return wi, pdf, li


def _sample_area_tri(scene, rec, p, u2, emit):
    """Area triangle: (wi, dist, pdf, li, front_ok)."""
    tri_idx = rec[..., 8].to(torch.int64)
    # clamped into the table as XLA clamps the gather: field 8 of a sphere
    # light's record is its radius
    tv = scene.tri_shade[torch.clamp(tri_idx, 0, scene.tri_shade.shape[0] - 1)][..., 0:9]
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
    return wi_area, dist_a, pdf_a, torch.where(front_ok[..., None], emit, 0.0), front_ok


def _sample_sphere(rec, p, u2, emit):
    """Analytic sphere light: (wi, dist, pdf, li). From outside a uniform
    direction in the subtended cone, its shadow ray ending just short of
    the sphere (the inscribed mesh cannot come first); from inside a
    uniform point on the sphere, the shadow ray ending at the inscribed
    sphere's chord exit."""
    lpos = rec[..., 1:4]
    radius = rec[..., 8]
    r_ins = rec[..., 10]
    dc = lpos - p
    dc2 = torch.clamp(vm.length_squared(dc), min=1e-12)
    dc_len = torch.sqrt(dc2)
    sin2_max = torch.clamp(radius * radius / dc2, 0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2_max)
    outside = dc2 > radius * radius * 1.0001
    cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_max
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi_s = 2.0 * math.pi * u2[..., 1]
    w_axis = dc / dc_len[..., None]
    tx, ty = vm.coordinate_system(w_axis)
    wi_sph = ((sin_t * torch.cos(phi_s))[..., None] * tx
              + (sin_t * torch.sin(phi_s))[..., None] * ty + cos_t[..., None] * w_axis)
    ds = dc_len * cos_t - vm.safe_sqrt(radius * radius - dc2 * (1.0 - cos_t * cos_t))
    pdf_out = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-9)
    dir_in = sampling.sample_uniform_sphere(u2)
    to_in = lpos + radius[..., None] * dir_in - p
    d2_in = torch.clamp(vm.length_squared(to_in), min=1e-12)
    wi_in = to_in / torch.sqrt(d2_in)[..., None]
    cos_in = vm.absdot(dir_in, wi_in)
    area_sph = 4.0 * math.pi * radius * radius
    pdf_in = d2_in / torch.clamp(cos_in * area_sph, min=1e-12)
    b_in = vm.dot(dc, wi_in)
    disc_in = b_in * b_in + r_ins * r_ins - dc2
    t_exit_in = b_in + vm.safe_sqrt(disc_in)
    dist = torch.where(outside, ds * (1.0 - 1e-3), torch.where(disc_in > 0, t_exit_in, 0.0))
    # from inside a one-sided sphere shows its back faces, which emit nothing
    li = torch.where((outside | (rec[..., 9] > 0))[..., None], emit, 0.0)
    return (torch.where(outside[..., None], wi_sph, wi_in), dist,
            torch.where(outside, pdf_out, pdf_in), li)


def _textured_point(scene, tag, rec, wi_point, li_point, lam):
    """A projection or goniometric light's radiance: the point light's times
    its texture's spectrum toward p (li_point itself without an atlas)."""
    if not texture.has_textures(scene):
        return li_point
    tex_id = rec[..., 13].to(torch.int32)
    if tag == scene_mod.LIGHT_PROJECTION:
        pdir, up = rec[..., 8:11], rec[..., 14:17]
        tanx = torch.clamp(rec[..., 11], min=1e-6)
        tany = torch.clamp(rec[..., 12], min=1e-6)
        xax = vm.normalize(vm.cross(up, pdir))
        w_l = -wi_point  # light -> p
        wz, wx, wy = vm.dot(w_l, pdir), vm.dot(w_l, xax), vm.dot(w_l, up)
        wzc = torch.clamp(wz, min=1e-6)
        inside = (wz > 1e-6) & (torch.abs(wx / wzc) <= tanx) & (torch.abs(wy / wzc) <= tany)
        uv = torch.stack([0.5 * (wx / wzc / tanx + 1.0), 0.5 * (wy / wzc / tany + 1.0)], -1)
    else:
        uv = vm.equal_area_sphere_to_square(-wi_point)
    texel = texture.lookup(scene.tex_atlas, scene.tex_desc, tex_id, torch.clamp(uv, 0.0, 0.9999))
    li = li_point * (rgb2spec.eval_sigmoid_poly(texel[..., 0:3], lam) * texel[..., 3:4])
    if tag == scene_mod.LIGHT_PROJECTION:
        li = li * inside[..., None]
    return li


def sample_li(scene, light_all, light_id, p, lam, u2, tags=None) -> LightLiSample:
    """SampleLi for a per-lane chosen light id. p (...,3), u2 (...,2);
    tags: the scene's light tags (scene_tags; read here when None)."""
    if tags is None:
        tags = scene_tags(scene)
    rec = light_all[torch.clamp(light_id, min=0).long()]
    ltype = rec[..., 0].to(torch.int32)
    lpos = rec[..., 1:4]
    emit = record_spectrum(rec, lam)
    shape = p.shape[:-1]
    one = torch.ones(shape, dtype=torch.float32, device=p.device)
    inf = torch.full(shape, torch.inf, dtype=torch.float32, device=p.device)
    # (wi, dist, pdf, li) of each tag the scene holds
    branch = {}
    if tags & {scene_mod.LIGHT_POINT, scene_mod.LIGHT_SPOT, scene_mod.LIGHT_PROJECTION,
               scene_mod.LIGHT_GONIOMETRIC}:
        to_l = lpos - p
        d2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
        wi_point = to_l * torch.rsqrt(d2)[..., None]
        li_point = emit / d2[..., None]
        dist_point = torch.sqrt(d2)
        branch[scene_mod.LIGHT_POINT] = (wi_point, dist_point, one, li_point)
        if scene_mod.LIGHT_SPOT in tags:
            cos_total, cos_start = rec[..., 11], rec[..., 12]
            t_ss = torch.clamp((vm.dot(rec[..., 8:11], -wi_point) - cos_total)
                               / torch.clamp(cos_start - cos_total, min=1e-6), 0.0, 1.0)
            falloff = t_ss * t_ss * (3.0 - 2.0 * t_ss)
            branch[scene_mod.LIGHT_SPOT] = (wi_point, dist_point, one,
                                            li_point * falloff[..., None])
        for tag in tags & {scene_mod.LIGHT_PROJECTION, scene_mod.LIGHT_GONIOMETRIC}:
            branch[tag] = (wi_point, dist_point, one,
                           _textured_point(scene, tag, rec, wi_point, li_point, lam))
    if scene_mod.LIGHT_DISTANT in tags:
        branch[scene_mod.LIGHT_DISTANT] = (lpos.expand(p.shape), inf, one, emit)
    if tags & {scene_mod.LIGHT_UNIFORM_INFINITE, scene_mod.LIGHT_IMAGE_INFINITE}:
        wi_inf = sampling.sample_uniform_sphere(u2)
        pdf_inf = torch.full(shape, sampling.UNIFORM_SPHERE_PDF, dtype=torch.float32,
                             device=p.device)
        branch[scene_mod.LIGHT_UNIFORM_INFINITE] = (wi_inf, inf, pdf_inf, emit)
        if scene_mod.LIGHT_IMAGE_INFINITE in tags:
            if has_env_map(scene):
                wi_img, pdf_img = env_sample_dir(scene, u2)
                branch[scene_mod.LIGHT_IMAGE_INFINITE] = (wi_img, inf, pdf_img,
                                                          env_le(scene, wi_img, lam))
            else:
                branch[scene_mod.LIGHT_IMAGE_INFINITE] = branch[
                    scene_mod.LIGHT_UNIFORM_INFINITE]
    if scene_mod.LIGHT_PORTAL_ENV in tags:
        wi_portal, pdf_portal, li_portal = _sample_portal(scene, rec, p, u2, lam, emit)
        branch[scene_mod.LIGHT_PORTAL_ENV] = (wi_portal, inf, pdf_portal, li_portal)
    front_ok = None
    if scene_mod.LIGHT_AREA_TRI in tags:
        wi_a, dist_a, pdf_a, li_a, front_ok = _sample_area_tri(scene, rec, p, u2, emit)
        branch[scene_mod.LIGHT_AREA_TRI] = (wi_a, dist_a, pdf_a, li_a)
    if scene_mod.LIGHT_SPHERE_AREA in tags:
        branch[scene_mod.LIGHT_SPHERE_AREA] = _sample_sphere(rec, p, u2, emit)

    wi, dist, pdf, li = torch.zeros_like(p), inf, one, torch.zeros_like(emit)
    for tag in sorted(tags):
        if tag not in branch:
            raise NotImplementedError(f"light tag {tag} is unknown")
        is_t = ltype == tag
        b_wi, b_dist, b_pdf, b_li = branch[tag]
        wi = torch.where(is_t[..., None], b_wi, wi)
        dist = torch.where(is_t, b_dist, dist)
        pdf = torch.where(is_t, b_pdf, pdf)
        li = torch.where(is_t[..., None], b_li, li)
    is_delta = torch.zeros(shape, dtype=torch.bool, device=p.device)
    for tag in tags & set(DELTA_TAGS):
        is_delta = is_delta | (ltype == tag)
    valid = (light_id >= 0) & (pdf > 0) & (li > 0).any(-1)
    if front_ok is not None:
        valid = valid & torch.where(ltype == scene_mod.LIGHT_AREA_TRI, front_ok, True)
    if scene_mod.LIGHT_SPHERE_AREA in tags:
        valid = valid & torch.where(ltype == scene_mod.LIGHT_SPHERE_AREA, dist > 0, True)
    return LightLiSample(wi=wi, dist=dist, li=li, pdf=pdf, is_delta=is_delta, valid=valid)


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


def portal_pdf_dir(scene, light_all, ref_p, d, ids=None):
    """Solid-angle pdf portal sampling gives direction d from ref_p, summed
    over the portal lights `ids` (portal_ids; read here when None): the
    window-normalised image density over duv_dw with the warp tables, the
    uniform-area quad pdf without."""
    if ids is None:
        ids = portal_ids(light_types(scene))
    out = torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    if scene.portal_sat is not None:
        from . import portal as portal_mod

        to_local = _frame_to_local(scene)
        uvd, duv_dw, dok = portal_mod.image_from_dir_local(to_local(d))
        for i in ids:
            rec = light_all[i]
            x0, y0, x1, y1, corners_ok = _portal_window(to_local, rec[8:11], rec[14:17],
                                                        ref_p)
            pdf_uv = portal_mod.pdf_windowed(scene.portal_sat, uvd[..., 0], uvd[..., 1],
                                             x0, y0, x1, y1)
            pdf_i = pdf_uv / torch.clamp(duv_dw, min=1e-9)
            out = out + torch.where(dok & corners_ok, pdf_i, 0.0)
        return out
    for i in ids:
        rec = light_all[i]
        q0, q1, q3 = rec[8:11], rec[11:14], rec[17:20]
        pn = vm.normalize(vm.cross(q1 - q0, q3 - q0))
        denom = vm.dot(d, pn)
        t = vm.dot(q0 - ref_p, pn) / torch.where(denom.abs() < 1e-9, 1e-9, denom)
        hitp = ref_p + t[..., None] * d
        e1, e3 = q1 - q0, q3 - q0
        rel = hitp - q0
        a11, a13, a33 = vm.dot(e1, e1), vm.dot(e1, e3), vm.dot(e3, e3)
        det = torch.clamp(a11 * a33 - a13 * a13, min=1e-12)
        b1 = (vm.dot(rel, e1) * a33 - vm.dot(rel, e3) * a13) / det
        b3 = (vm.dot(rel, e3) * a11 - vm.dot(rel, e1) * a13) / det
        inside = (t > 0) & (b1 >= 0) & (b1 <= 1) & (b3 >= 0) & (b3 <= 1)
        d2q = vm.length_squared(hitp - ref_p)
        area_q = vm.length(vm.cross(e1, e3))
        pdf_i = d2q / torch.clamp(denom.abs() * area_q, min=1e-12)
        out = out + torch.where(inside, pdf_i, 0.0)
    return out


def has_portal(scene) -> bool:
    """Static: does the scene hold a portal light (the feat_portal flag)?"""
    return bool(scene.feat_portal)


def area_pdf_li_from_verts(v0, v1, v2, ref_p):
    """Solid-angle pdf of triangle solid-angle sampling toward a hit."""
    omega = triangle.solid_angle(v0, v1, v2, ref_p)
    return torch.where(omega > 1e-5, 1.0 / torch.clamp(omega, min=1e-12), 0.0)


def has_env_map(scene) -> bool:
    """Static: does the scene carry an env map (by the table's shape)?"""
    return scene.env_luminance is not None and scene.env_luminance.numel() > 1


def _env_uv_texel(scene, uv):
    he, we = scene.env_luminance.shape
    x = torch.clamp((uv[..., 0] * we).to(torch.int64), 0, we - 1)
    y = torch.clamp((uv[..., 1] * he).to(torch.int64), 0, he - 1)
    return scene.env_coeffs[y, x], y, x


def env_scale_total(scene):
    is_env = (scene.light_type == scene_mod.LIGHT_IMAGE_INFINITE) | (
        scene.light_type == scene_mod.LIGHT_PORTAL_ENV)
    return torch.where(is_env, scene.light_scale, 0.0).sum()


def env_le(scene, d, lam):
    """Radiance of the env map toward -d (equal-area lookup)."""
    texel, _, _ = _env_uv_texel(scene, vm.equal_area_sphere_to_square(d))
    return (rgb2spec.eval_sigmoid_poly(texel[..., 0:3], lam) * texel[..., 3:4]
            * spectrum.illuminant_d_normalized(lam) * env_scale_total(scene))


def env_pdf_dir(scene, d):
    """Solid-angle pdf of env-map importance sampling for direction d (the
    equal-area map preserves measure: pdf_uv / 4 pi)."""
    _, y, x = _env_uv_texel(scene, vm.equal_area_sphere_to_square(d))
    return scene.env_luminance[y, x] * sampling.INV_4PI


def env_sample_dir(scene, u2):
    """Importance-sample the env map: u2 (R, 2) -> (dir, pdf_dir). The row
    comes from the marginal cdf (the first entry above u, searchsorted
    right), the column from the row's conditional cdf (the first entry at or
    above u, searchsorted left), as the JAX package searches them."""
    he, we = scene.env_luminance.shape
    marg = scene.env_marg_cdf
    uy = u2[..., 1].contiguous()
    y = torch.clamp(torch.searchsorted(marg, uy, right=True) - 1, 0, he - 1)
    c0, c1 = marg[y], marg[y + 1]
    dv = torch.where(c1 > c0, (uy - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0)
    v = (y.to(torch.float32) + dv) / he
    cond = scene.env_cond_cdf[y]  # (R, we + 1)
    ux = u2[..., 0].contiguous()
    x = torch.clamp(torch.searchsorted(cond, ux[..., None]).squeeze(-1) - 1, 0, we - 1)
    d0 = cond.gather(-1, x[..., None]).squeeze(-1)
    d1 = cond.gather(-1, x[..., None] + 1).squeeze(-1)
    du = torch.where(d1 > d0, (ux - d0) / torch.clamp(d1 - d0, min=1e-20), 0.0)
    u = (x.to(torch.float32) + du) / we
    dirs = vm.equal_area_square_to_sphere(torch.stack([u, v], -1))
    return dirs, scene.env_luminance[y, x] * sampling.INV_4PI


def infinite_le(scene, d, lam):
    """Radiance of the infinite lights (uniform, and the env map when the
    scene has one) for escaped rays; zero when it has none."""
    is_inf = scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE
    spec_all = rgb2spec.eval_sigmoid_poly(
        scene.light_coeffs.view((-1,) + (1,) * (lam.dim() - 1) + (3,)), lam[None])
    w = torch.where(is_inf, scene.light_scale, 0.0)
    out = torch.tensordot(w, spec_all, dims=([0], [0])) * spectrum.illuminant_d_normalized(lam)
    if has_env_map(scene):
        out = out + env_le(scene, d, lam)
    return out
