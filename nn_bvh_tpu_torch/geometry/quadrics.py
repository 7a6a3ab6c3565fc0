"""Analytic quadrics: sphere, disk, cylinder and bilinear patch (port of
nn_bvh_tpu/geometry/quadrics.py).

Scenes carry few quadrics, so they stay out of the BVH: after the triangle
traversal every ray is tested against every quadric as an (R, Q) broadcast
and the nearer hit wins (accel/dispatch.Intersectors). Quadric prim ids lie
above the padded triangle range (quad_base + q), and tri_shade carries Q
appended rows, so the material, light and medium gathers are unchanged;
only position, normal and uv come from here (wavefront/integrator.
_shading_point).

Records are world-space canonical frames (13 floats):
  sphere:   [cx cy cz | r | zx zy zz | xx xy xz | zmin zmax phimax]
  disk:     [cx cy cz | r | nx ny nz | xx xy xz | h=0  inner phimax]
  cylinder: [cx cy cz | r | ax ay az | xx xy xz | zmin zmax phimax]
  bilinear: [p00 | p10 | p01 | p11 | 0]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import vecmath as vm

SPHERE = 0
DISK = 1
CYLINDER = 2
BILINEAR = 3

N_QUAD_PARAMS = 13


def make_bilinear_record(p00, p10, p01, p11) -> tuple[int, np.ndarray]:
    """Bilinear-patch record: the 4 corners (pbrt order p00 p10 p01 p11)."""
    p = np.zeros(N_QUAD_PARAMS, np.float32)
    p[0:3] = np.asarray(p00, np.float32)
    p[3:6] = np.asarray(p10, np.float32)
    p[6:9] = np.asarray(p01, np.float32)
    p[9:12] = np.asarray(p11, np.float32)
    return BILINEAR, p


def make_record(kind: str, center, radius: float, axis=(0.0, 0.0, 1.0),
                x_axis=None, zmin: float = -1e30, zmax: float = 1e30,
                inner_radius: float = 0.0,
                phimax: float = 2.0 * np.pi) -> tuple[int, np.ndarray]:
    """Host quadric record (world-space canonical frame)."""
    kinds = {"sphere": SPHERE, "disk": DISK, "cylinder": CYLINDER}
    z = np.asarray(axis, np.float64)
    z = z / max(np.linalg.norm(z), 1e-12)
    if x_axis is None:
        h = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
        x = np.cross(h, z)
        x /= max(np.linalg.norm(x), 1e-12)
    else:
        x = np.asarray(x_axis, np.float64)
        x /= max(np.linalg.norm(x), 1e-12)
    p = np.zeros(N_QUAD_PARAMS, np.float32)
    p[0:3] = np.asarray(center, np.float32)
    p[3] = float(radius)
    p[4:7] = z.astype(np.float32)
    p[7:10] = x.astype(np.float32)
    if kinds[kind] == DISK:
        p[10] = 0.0
        p[11] = float(inner_radius)
    else:
        p[10] = float(max(zmin, -radius if kinds[kind] == SPHERE else zmin))
        p[11] = float(min(zmax, radius if kinds[kind] == SPHERE else zmax))
    p[12] = float(phimax)
    return kinds[kind], p


def bounds(kind: int, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if kind == BILINEAR:
        pts = p[0:12].reshape(4, 3)
        return pts.min(0), pts.max(0)
    c, r = p[0:3], p[3]
    if kind == CYLINDER:
        z = p[4:7]
        lo = np.minimum(c + p[10] * z, c + p[11] * z) - r
        hi = np.maximum(c + p[10] * z, c + p[11] * z) + r
        return lo, hi
    return c - r, c + r


def _quadratic(a, b, c):
    """Stable quadratic roots (the citardauq form) -> (has, t0, t1), t0 <= t1."""
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    q = torch.where(b.abs() < 1e-30, -0.5 * sq, q)
    t0 = q / torch.where(a.abs() < 1e-30, 1e-30, a)
    t1 = c / torch.where(q.abs() < 1e-30, 1e-30, q)
    return has, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _sel(qt, sphere, disk, bilinear, cylinder):
    """Per-kind choice over the (R, Q) grid (the JAX select's order)."""
    return torch.where(qt == SPHERE, sphere,
                       torch.where(qt == DISK, disk,
                                   torch.where(qt == BILINEAR, bilinear, cylinder)))


def intersect(qtype, qparams, o, d, t_max, eps: float = 1e-4):
    """Closest hit over every quadric: o/d (R,3), t_max (R,) -> (t (R,),
    idx (R,) int64, -1 on a miss, u (R,), v (R,)). A lane with t_max <= 0
    misses."""
    R = o.shape[0]
    c = qparams[None, :, 0:3]
    r = qparams[None, :, 3]
    zax = qparams[None, :, 4:7]
    xax = qparams[None, :, 7:10]
    yax = vm.cross(zax, xax)
    p0 = qparams[None, :, 10]
    p1 = qparams[None, :, 11]
    ob = o[:, None, :] - c
    db = d[:, None, :]
    oz = (ob * zax).sum(-1)
    dz = (db * zax).sum(-1)

    # sphere
    a_s = (db * db).sum(-1)
    b_s = 2.0 * (ob * db).sum(-1)
    c_s = (ob * ob).sum(-1) - r * r
    has_s, s0, s1 = _quadratic(a_s, b_s, c_s)
    t_sph = torch.where(s0 > eps, s0, s1)
    ok_s = has_s & (t_sph > eps)

    # disk: the frame's z = 0 plane within the annulus
    t_dk = -oz / torch.where(dz.abs() < 1e-12, 1e-12, dz)
    pd = ob + t_dk[..., None] * db
    rd2 = (pd * pd).sum(-1) - (pd * zax).sum(-1) ** 2
    ok_d = (dz.abs() > 1e-12) & (t_dk > eps) & (rd2 <= r * r) & (rd2 >= p1 * p1)

    # cylinder: infinite, clipped to [zmin, zmax] along the frame's z
    dperp = db - dz[..., None] * zax
    operp = ob - oz[..., None] * zax
    a_c = (dperp * dperp).sum(-1)
    b_c = 2.0 * (dperp * operp).sum(-1)
    c_c = (operp * operp).sum(-1) - r * r
    has_c, c0, c1 = _quadratic(a_c, b_c, c_c)
    z0, z1 = oz + c0 * dz, oz + c1 * dz
    ok_c0 = has_c & (c0 > eps) & (z0 >= p0) & (z0 <= p1)
    ok_c1 = has_c & (c1 > eps) & (z1 >= p0) & (z1 <= p1)
    t_cyl = torch.where(ok_c0, c0, c1)
    ok_c = ok_c0 | ok_c1

    # bilinear patch (Reshetov): project onto two vectors perpendicular to d,
    # eliminate t and v, solve the quadratic in u
    bp00 = qparams[None, :, 0:3]
    ba = qparams[None, :, 3:6] - bp00
    bb = qparams[None, :, 6:9] - bp00
    bcc = qparams[None, :, 9:12] - qparams[None, :, 3:6] - qparams[None, :, 6:9] + bp00
    bs = bp00 - o[:, None, :]
    k1, k2 = vm.coordinate_system(d)
    k1, k2 = k1[:, None, :], k2[:, None, :]
    A1, B1 = (k1 * bcc).sum(-1), (k1 * ba).sum(-1)
    C1, D1 = (k1 * bb).sum(-1), (k1 * bs).sum(-1)
    A2, B2 = (k2 * bcc).sum(-1), (k2 * ba).sum(-1)
    C2, D2 = (k2 * bb).sum(-1), (k2 * bs).sum(-1)
    qa = A1 * B2 - A2 * B1
    qb = A1 * D2 + B2 * C1 - A2 * D1 - B1 * C2
    qc = C1 * D2 - C2 * D1
    has_b, u0, u1 = _quadratic(qa, qb, qc)
    u_lin = -qc / torch.where(qb.abs() < 1e-20, 1e-20, qb)
    lin = qa.abs() < 1e-12 * torch.clamp(qb.abs(), min=1.0)
    dd = (d * d).sum(-1)[:, None]

    def patch_eval(uu):
        den1 = A1 * uu + C1
        den2 = A2 * uu + C2
        vv = torch.where(den1.abs() >= den2.abs(),
                         -(B1 * uu + D1) / torch.where(den1.abs() < 1e-20, 1e-20, den1),
                         -(B2 * uu + D2) / torch.where(den2.abs() < 1e-20, 1e-20, den2))
        pt = bs + uu[..., None] * ba + vv[..., None] * bb + (uu * vv)[..., None] * bcc
        tt = (pt * d[:, None, :]).sum(-1) / dd
        okk = (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1) & (tt > eps)
        return torch.where(okk, tt, torch.inf), vv, okk

    u_first = torch.where(lin, u_lin, u0)
    tb0, vb0, okb0 = patch_eval(u_first)
    tb1, vb1, okb1 = patch_eval(u1)
    okb1 = okb1 & ~lin
    pick0 = tb0 <= tb1
    t_bil = torch.minimum(tb0, tb1)
    u_bil = torch.where(pick0, u_first, u1)
    v_bil = torch.where(pick0, vb0, vb1)
    ok_b = (okb0 | okb1) & (has_b | lin)

    qt = qtype[None, :]
    t_all = _sel(qt, t_sph, t_dk, t_bil, t_cyl)
    ok = _sel(qt, ok_s, ok_d, ok_b, ok_c) & (t_all < t_max[:, None])
    t_all = torch.where(ok, t_all, torch.inf)

    # parametric uv of the hit
    ph = ob + t_all[..., None] * db
    px = (ph * xax).sum(-1)
    py = (ph * yax).sum(-1)
    pz = (ph * zax).sum(-1)
    phi = torch.atan2(py, px)
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    u_sph = phi / torch.clamp(qparams[None, :, 12], min=1e-6)
    v_sph = torch.acos(torch.clamp(pz / torch.clamp(r, min=1e-9), -1.0, 1.0)) / math.pi
    rr = torch.sqrt(torch.clamp(px * px + py * py, min=1e-20))
    v_dk = (r - rr) / torch.clamp(r - p1, min=1e-9)
    v_cyl = (pz - p0) / torch.clamp(p1 - p0, min=1e-9)
    u = torch.where(qt == BILINEAR, torch.clamp(u_bil, 0.0, 1.0), u_sph)
    v = _sel(qt, v_sph, v_dk, torch.clamp(v_bil, 0.0, 1.0), v_cyl)

    best = torch.argmin(t_all, dim=1)
    ar = torch.arange(R, device=o.device)
    t_best = t_all[ar, best]
    hit_any = torch.isfinite(t_best)
    return (torch.where(hit_any, t_best, torch.inf), torch.where(hit_any, best, -1),
            u[ar, best], v[ar, best])


def intersect_any(qtype, qparams, o, d, t_max, eps: float = 1e-4) -> torch.Tensor:
    return intersect(qtype, qparams, o, d, t_max, eps)[1] >= 0


def shading(qtype, qparams, qidx, o, d, t, u=None, v=None):
    """Analytic position and outward normal at a quadric hit (qidx >= 0;
    the caller masks). u/v give the bilinear patch's normal dPdu x dPdv,
    turned toward -d."""
    q = torch.clamp(qidx, min=0).long()
    rec = qparams[q]
    kind = qtype[q]
    c = rec[..., 0:3]
    zax = rec[..., 4:7]
    p = o + t[..., None] * d
    rel = p - c
    n_sph = vm.normalize(rel)
    pz = (rel * zax).sum(-1, keepdim=True)
    n_cyl = vm.normalize(rel - pz * zax)
    n = torch.where((kind == SPHERE)[..., None], n_sph,
                    torch.where((kind == DISK)[..., None], zax, n_cyl))
    if u is not None:
        ba = rec[..., 3:6] - rec[..., 0:3]
        bb = rec[..., 6:9] - rec[..., 0:3]
        bcc = rec[..., 9:12] - rec[..., 3:6] - rec[..., 6:9] + rec[..., 0:3]
        dpdu = ba + v[..., None] * bcc
        dpdv = bb + u[..., None] * bcc
        n_bil = vm.normalize(vm.cross(dpdu, dpdv))
        n_bil = torch.where(((n_bil * d).sum(-1) > 0)[..., None], -n_bil, n_bil)
        n = torch.where((kind == BILINEAR)[..., None], n_bil, n)
    return p, n


def uv_scale(qtype: np.ndarray, qparams: np.ndarray) -> np.ndarray:
    """Host: approximate uv length per world length (ray-cone LOD)."""
    r = np.maximum(qparams[:, 3], 1e-6)
    out = 1.0 / (np.pi * r)
    for i in range(len(qtype)):
        if qtype[i] == BILINEAR:
            pts = qparams[i, 0:12].reshape(4, 3)
            ext = max(np.linalg.norm(pts[1] - pts[0]), np.linalg.norm(pts[2] - pts[0]), 1e-6)
            out[i] = 1.0 / ext
    return out.astype(np.float32)
