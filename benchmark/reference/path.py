"""Plain reference of the Path integrator on the bench scene: the pixels of a
developed 16-spp image worked out again, lane by lane, from the scene's
triangles, its materials and lights, the camera and the sampler seed.

It follows the semantics of the repository's spectral wavefront Path
integrator (the JAX package's, which the port mirrors): the padded Sobol'
sampler with Owen scrambling and its dimension schedule, 4 hero
wavelengths, the analytic CIE fits and the 6504 K illuminant, the
sigmoid-polynomial RGB uplift fitted by Gauss-Newton, Lambertian and
Trowbridge-Reitz conductor lobes, area triangle lights sampled by solid
angle with power-heuristic MIS, Russian roulette, and the white-balanced
XYZ -> linear sRGB develop. Only the parts the bench scene uses are here:
two diffuse materials, one rough conductor, emissive triangles, a pinhole
camera, the box filter.

Visibility is brute force: every ray against every triangle, chunked, with
the same Moller-Trumbore test (first smallest t wins). No BVH, no sort, no
wavefront compaction: each lane is traced on its own, so the reference
shares no structure with the program. It imports torch and numpy only.

`dtype` sets the precision of every float the integrator computes:
float32 is the reference; bfloat16 is the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
LAMBDA_MIN, LAMBDA_MAX = 360.0, 830.0
N_LAMBDA = 4
DIM_PIXEL, DIM_WAVELENGTH, DIM_PATH_BASE, DIMS_PER_DEPTH = 0, 2, 5, 7
INV_PI = 0.31830988618379067154
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961


# ---------------------------------------------------------------------------
# sampler: padded Sobol' (dims 0 and 1 of Sobol', Owen-scrambled), uint32
# ---------------------------------------------------------------------------

def _u(x):
    return np.asarray(x, np.uint64) & np.uint64(M32)


def _mul(a, c):
    return (a * np.uint64(c)) & np.uint64(M32)


def _mix(v):
    v = v ^ (v >> np.uint64(16))
    v = _mul(v, 0x7FEB352D)
    v = v ^ (v >> np.uint64(15))
    v = _mul(v, 0x846CA68B)
    return v ^ (v >> np.uint64(16))


def _hash(*vals):
    h = _u(0x9E3779B9)
    for v in vals:
        v = _u(v)
        s = (v + np.uint64(0x9E3779B9) + ((h << np.uint64(6)) & np.uint64(M32))
             + (h >> np.uint64(2))) & np.uint64(M32)
        h = _mix(h ^ s)
    return h


def _rev(v):
    v = ((v >> np.uint64(1)) & np.uint64(0x55555555)) | ((v & np.uint64(0x55555555)) << np.uint64(1))
    v = ((v >> np.uint64(2)) & np.uint64(0x33333333)) | ((v & np.uint64(0x33333333)) << np.uint64(2))
    v = ((v >> np.uint64(4)) & np.uint64(0x0F0F0F0F)) | ((v & np.uint64(0x0F0F0F0F)) << np.uint64(4))
    v = ((v >> np.uint64(8)) & np.uint64(0x00FF00FF)) | ((v & np.uint64(0x00FF00FF)) << np.uint64(8))
    return ((v >> np.uint64(16)) | (v << np.uint64(16))) & np.uint64(M32)


def _owen(v, seed):
    v = v ^ _mul(v, 0x3D20ADEA)
    v = (v + seed) & np.uint64(M32)
    v = (v * ((seed >> np.uint64(16)) | np.uint64(1))) & np.uint64(M32)
    v = v ^ _mul(v, 0x05526C56)
    return v ^ _mul(v, 0x53A22864)


def _to_float(bits) -> np.ndarray:
    f = bits.astype(np.float64).astype(np.float32) * np.float32(2.0 ** -32)
    return np.minimum(f, np.float32(1.0 - 2.0 ** -24)).astype(np.float32)


_SOBOL = []
_m = 1
for _k in range(32):
    _SOBOL.append((1 << (31 - _k), (_m << (31 - _k)) & M32))
    _m = _m ^ (2 * _m)


def _sobol2(index, seed_x, seed_y, n_bits):
    x = np.zeros_like(index)
    y = np.zeros_like(index)
    for k in range(n_bits):
        bit = (index >> np.uint64(k)) & np.uint64(1)
        x = x ^ (bit * np.uint64(_SOBOL[k][0]))
        y = y ^ (bit * np.uint64(_SOBOL[k][1]))
    return _to_float(_rev(_owen(_rev(x), seed_x))), _to_float(_rev(_owen(_rev(y), seed_y)))


class Sampler:
    """get_1d / get_2d of the padded Sobol' sampler for (pixel, sample)
    lanes given as numpy arrays."""

    def __init__(self, seed: int, spp: int):
        self.seed, self.log_n = int(seed), max(1, int(spp - 1).bit_length())

    def _idx(self, pixel, sample, dim):
        pad = _hash(pixel, dim, self.seed)
        shift = np.uint64(32 - self.log_n)
        idx = _owen((_u(sample) << shift) & np.uint64(M32), pad) >> shift
        return idx, pad

    def get_1d(self, pixel, sample, dim):
        idx, pad = self._idx(pixel, sample, dim)
        return _sobol2(idx, pad ^ np.uint64(0x55555555), pad, self.log_n)[0]

    def get_2d(self, pixel, sample, dim):
        idx, pad = self._idx(pixel, sample, dim)
        return _sobol2(idx, pad ^ np.uint64(0x55555555), _mix(pad), self.log_n)


# ---------------------------------------------------------------------------
# spectra and colour
# ---------------------------------------------------------------------------

def _g(x, mu, s1, s2, xp):
    s = xp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return xp.exp(-0.5 * t * t)


def cie(lam):
    xp = torch if isinstance(lam, torch.Tensor) else np
    x = 1.056 * _g(lam, 599.8, 37.9, 31.0, xp) + 0.362 * _g(lam, 442.0, 16.0, 26.7, xp) \
        - 0.065 * _g(lam, 501.1, 20.4, 26.2, xp)
    y = 0.821 * _g(lam, 568.8, 46.9, 40.5, xp) + 0.286 * _g(lam, 530.9, 16.3, 31.1, xp)
    z = 1.217 * _g(lam, 437.0, 11.8, 36.0, xp) + 0.681 * _g(lam, 459.0, 26.0, 13.8, xp)
    return x, y, z


def _planck(lam_nm, T, xp):
    lam = lam_nm * 1e-9
    c, h, kb = 299792458.0, 6.62606957e-34, 1.3806488e-23
    x = (h * c) / (lam * kb * T)
    x = torch.clamp(x, max=80.0) if xp is torch else np.minimum(x, 80.0)
    return (2.0 * h * c * c) / (lam ** 5 * (xp.exp(x) - 1.0))


CCT = 6504.0
_LAM = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
CIE_Y_INT = float(np.sum(cie(_LAM)[1]))
_PEAK = float(_planck(np.float64(2.8977721e-3 / CCT * 1e9), CCT, np))


def illum(lam):
    """The 6504 K blackbody illuminant, peak 1."""
    return _planck(lam, CCT, torch if isinstance(lam, torch.Tensor) else np) / _PEAK


ILLUM_Y = float(np.sum(cie(_LAM)[1] * illum(_LAM))) / CIE_Y_INT

XYZ_TO_SRGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                        [-0.9692660, 1.8760108, 0.0415560],
                        [0.0556434, -0.2040259, 1.0572252]], np.float32)
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]], np.float32)


def sensor_xyz_to_srgb() -> np.ndarray:
    """XYZ under the illuminant -> linear sRGB: Bradford white balance to
    sRGB's white, then the sRGB matrix."""
    w = illum(_LAM)
    cx, cy, cz = cie(_LAM)
    white = np.array([np.sum(cx * w), np.sum(cy * w), np.sum(cz * w)]) / np.sum(cy * w)
    srgb_white = np.linalg.inv(XYZ_TO_SRGB).astype(np.float32) @ np.ones(3, np.float32)
    lms_s = _BRADFORD @ np.asarray(white, np.float32)
    lms_d = _BRADFORD @ srgb_white
    wb = (np.linalg.inv(_BRADFORD).astype(np.float32) @ np.diag(lms_d / lms_s).astype(np.float32)
          @ _BRADFORD).astype(np.float32)
    return (XYZ_TO_SRGB @ wb).astype(np.float32)


def _lam_n(lam):
    return (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN) * 2.0 - 1.0


def fit_rgb(rgb) -> tuple:
    """Sigmoid-polynomial coefficients of RGB colours (N, 3) by
    Levenberg-damped Gauss-Newton on the reflectance basis -> (coeffs (N, 3)
    float32, scale (N,))."""
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
    m = rgb.max(-1)
    scale = np.where(m > 1.0, 2.0 * m, 1.0).astype(np.float32)
    t = np.asarray(rgb / scale[:, None], np.float64)
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 5.0)
    w = illum(lam)
    cx, cy, cz = cie(lam)
    B = (sensor_xyz_to_srgb() @ (np.stack([cx, cy, cz]) * w[None]) / float(np.sum(cy * w)))
    xn = _lam_n(lam)
    V = np.stack([xn * xn, xn, np.ones_like(xn)], -1)
    c = np.zeros((len(t), 3))
    mean = np.clip(t.mean(-1), 1e-4, 1 - 1e-4)
    c[:, 2] = (2 * mean - 1) / (2.0 * np.sqrt(mean * (1 - mean)))
    for _ in range(60):
        x = c @ V.T
        r = (0.5 + x / (2.0 * np.sqrt(1.0 + x * x))) @ B.T - t
        J = np.einsum("kl,nl,lc->nkc", B, 0.5 / np.power(1.0 + x * x, 1.5), V)
        A = np.einsum("nkc,nkd->ncd", J, J) + 1e-4 * np.eye(3)[None]
        c = c - np.linalg.solve(A, np.einsum("nkc,nk->nc", J, r)[..., None])[..., 0]
    return c.astype(np.float32), scale


def sigmoid_poly(coeffs, lam):
    xn = _lam_n(lam)
    x = coeffs[..., 0:1] * xn * xn + coeffs[..., 1:2] * xn + coeffs[..., 2:3]
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


# ---------------------------------------------------------------------------
# vector helpers
# ---------------------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    l2 = dot(v, v)
    ok = l2 > 1e-20
    return v * torch.where(ok, torch.rsqrt(torch.where(ok, l2, 1.0)), 0.0)[..., None]


def ssqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-12))


def face_forward(n, v):
    return torch.where(dot(n, v)[..., None] < 0, -n, n)


def frame(n):
    nx, ny, z = n.unbind(-1)
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = nx * ny * a
    return (torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1),
            torch.stack([b, sign + ny * ny * a, -ny], -1))


def to_local(n, v):
    t, b = frame(n)
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def from_local(n, v):
    t, b = frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def offset(p, n, w):
    d = (1e-4 * torch.clamp(p.abs().amax(-1), min=1.0))[..., None]
    return p + torch.where(dot(w, n)[..., None] < 0, -d, d) * n


def power_heuristic(f, g):
    f = torch.clamp(f, max=1e18)
    g = torch.clamp(g, max=1e18)
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def concentric_disk(u):
    ox, oy = 2.0 * u[..., 0] - 1.0, 2.0 * u[..., 1] - 1.0
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, PI_OVER_4 * (oy / torch.where(ox == 0, 1.0, ox)),
                        PI_OVER_2 - PI_OVER_4 * (ox / torch.where(oy == 0, 1.0, oy)))
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(((ox == 0) & (oy == 0))[..., None], 0.0, p)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz conductor
# ---------------------------------------------------------------------------

def _trig(w):
    c2 = w[..., 2] * w[..., 2]
    s2 = torch.clamp(1.0 - c2, min=0.0)
    s = torch.sqrt(s2)
    cphi = torch.where(s == 0, 1.0, torch.clamp(w[..., 0] / torch.clamp(s, min=1e-20), -1, 1))
    sphi = torch.where(s == 0, 0.0, torch.clamp(w[..., 1] / torch.clamp(s, min=1e-20), -1, 1))
    return c2, s2 / torch.clamp(c2, min=1e-20), cphi, sphi


def tr_d(wm, a):
    c2, t2, cphi, sphi = _trig(wm)
    e = (cphi ** 2 / torch.clamp(a * a, min=1e-12) + sphi ** 2 / torch.clamp(a * a, min=1e-12)) * t2
    d = 1.0 / torch.clamp(math.pi * a * a * c2 ** 2 * (1.0 + e) ** 2, min=1e-20)
    return torch.where(torch.isfinite(t2) & torch.isfinite(d), d, 0.0)


def tr_lambda(w, a):
    _, t2, cphi, sphi = _trig(w)
    lam = 0.5 * (torch.sqrt(1.0 + (cphi ** 2 * a * a + sphi ** 2 * a * a) * t2) - 1.0)
    return torch.where(torch.isfinite(t2), lam, 0.0)


def fr_complex(cos_i, eta, k):
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


def conductor_f_pdf(refl, a, eta, k, wo, wi):
    """f (R, 4) and pdf of the rough conductor lobe (visible normals)."""
    refl_side = wo[..., 2] * wi[..., 2] > 0
    wm = wi + wo
    wm_n = normalize(wm)
    wm_n = torch.where(wm_n[..., 2:3] < 0, -wm_n, wm_n)
    ok = (dot(wm, wm) > 1e-12) & refl_side
    fr = fr_complex(dot(wo, wm_n).abs(), eta, k)[..., None]
    d = tr_d(wm_n, a)
    g = 1.0 / (1.0 + tr_lambda(wo, a) + tr_lambda(wi, a))
    denom = torch.clamp(4.0 * wo[..., 2].abs() * wi[..., 2].abs(), min=1e-9)
    f = torch.where(ok[..., None], refl * fr * (d * g / denom)[..., None], 0.0)
    g1 = 1.0 / (1.0 + tr_lambda(wo, a))
    d_vis = g1 / torch.clamp(wo[..., 2].abs(), min=1e-9) * d * dot(wo, wm_n).abs()
    pdf = torch.where(ok, d_vis / torch.clamp(4.0 * dot(wo, wm_n).abs(), min=1e-9), 0.0)
    return f, pdf


def sample_wm(w, u, a):
    wh = normalize(torch.stack([a * w[..., 0], a * w[..., 1], w[..., 2]], -1))
    wh = torch.where(wh[..., 2:3] < 0, -wh, wh)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=w.dtype, device=w.device).expand_as(wh)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device).expand_as(wh)
    t1 = torch.where((wh[..., 2].abs() < 0.999)[..., None], normalize(cross(z_axis, wh)), x_axis)
    t2 = cross(wh, t1)
    p = concentric_disk(u)
    h = ssqrt(1.0 - p[..., 0] ** 2)
    s = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - s) * h + s * p[..., 1]
    pz = ssqrt(1.0 - p[..., 0] ** 2 - py ** 2)
    nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
    return normalize(torch.stack([a * nh[..., 0], a * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=1e-6)], -1))


# ---------------------------------------------------------------------------
# visibility: brute-force Moller-Trumbore
# ---------------------------------------------------------------------------

def intersect(tri, o, d, t_max, any_hit: bool, chunk: int):
    """tri (N, 3, 3). Closest hit -> (t, prim, b1, b2), first smallest t
    winning; any hit -> (R,) bool. Lanes with t_max <= 0 hit nothing."""
    R = o.shape[0]
    t_best = torch.where(t_max > 0, t_max, -1.0)
    prim = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    b1 = torch.zeros_like(t_best)
    b2 = torch.zeros_like(t_best)
    hit_any = torch.zeros(R, dtype=torch.bool, device=o.device)
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    for s in range(0, tri.shape[0], chunk):
        p = tri[s:s + chunk]
        x0, y0, z0 = p[None, :, 0, 0], p[None, :, 0, 1], p[None, :, 0, 2]
        e1 = (p[:, 1] - p[:, 0])[None]
        e2 = (p[:, 2] - p[:, 0])[None]
        e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
        e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        sx, sy, sz = ox - x0, oy - y0, oz - z0
        u1 = (sx * px + sy * py + sz * pz) * inv
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        u2 = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        h = (ok & (u1 >= -1e-7) & (u2 >= -1e-7) & (u1 + u2 <= 1.0 + 1e-7) & (t > 0.0)
             & (t < t_best[:, None]))
        if any_hit:
            hit_any = hit_any | h.any(1)
            continue
        tm = torch.where(h, t, torch.inf)
        k = torch.argmin(tm, 1)
        tk = tm.gather(1, k[:, None])[:, 0]
        got = torch.isfinite(tk)
        t_best = torch.where(got, tk, t_best)
        prim = torch.where(got, k + s, prim)
        b1 = torch.where(got, u1.gather(1, k[:, None])[:, 0], b1)
        b2 = torch.where(got, u2.gather(1, k[:, None])[:, 0], b2)
    if any_hit:
        return hit_any
    return torch.where(prim < 0, torch.inf, t_best), prim, b1, b2


# ---------------------------------------------------------------------------
# the scene and one Path render of chosen pixels
# ---------------------------------------------------------------------------

class Scene:
    """The reference's tables of the bench geometry (harness.geometry
    `triangles`), with its materials' and lights' spectra fitted here."""

    def __init__(self, tris: dict, materials, eta_k, device, dtype=torch.float32,
                 bvh: bool = False):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
        self.device, self.dtype = device, dtype
        self.bvh = None
        if bvh:
            from . import bvh as bvh_mod

            self.bvh = bvh_mod.BVH(tris["p"], device)
        self.p = f(tris["p"])
        self.n = f(tris["n"])
        self.mat = torch.as_tensor(tris["mat"], device=device)
        self.light = torch.as_tensor(tris["light"], device=device)
        coeffs, scale = fit_rgb([m["reflectance"] for m in materials])
        self.mat_coeffs, self.mat_scale = f(coeffs), f(scale)
        self.mat_alpha = torch.sqrt(torch.clamp(f([m["roughness"] for m in materials]), min=0.0))
        self.mat_conductor = torch.as_tensor([m["kind"] == "conductor" for m in materials],
                                             device=device)
        self.eta, self.k = f(eta_k[0]), f(eta_k[1])
        em = tris["emitters"]
        lc, ls = fit_rgb([e["rgb"] for e in em])
        self.light_coeffs = f(lc)
        self.light_scale = f(np.array([e["scale"] for e in em], np.float32) * ls)
        self.light_two = torch.as_tensor([bool(e["two_sided"]) for e in em], device=device)
        self.light_tri = torch.as_tensor([e["tri"] for e in em], device=device)
        # power light sampler: pi * area * scale (x2 two-sided), as float32
        power = []
        for e in em:
            p = tris["p"][e["tri"]].astype(np.float64)
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
            power.append(np.pi * area * e["scale"] * (2.0 if e["two_sided"] else 1.0))
        power = np.asarray(power, np.float32)
        pmf = np.maximum((power / power.sum()).astype(np.float32), 1e-8)
        pmf = pmf / pmf.sum()
        self.pmf = f(pmf)
        self.cdf = torch.as_tensor(np.cumsum(pmf).astype(np.float32), device=device)


def emission(sc: Scene, light, lam):
    lid = torch.clamp(light, min=0)
    return (sigmoid_poly(sc.light_coeffs[lid], lam) * (illum(lam) / ILLUM_Y)
            * sc.light_scale[lid][..., None])


def spherical_triangle(v0, v1, v2, p, u):
    a, b, c = normalize(v0 - p), normalize(v1 - p), normalize(v2 - p)
    n_ab, n_bc, n_ca = normalize(cross(a, b)), normalize(cross(b, c)), normalize(cross(c, a))
    acos = lambda x: torch.acos(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))
    alpha, beta, gamma = acos(dot(n_ab, -n_ca)), acos(dot(n_bc, -n_ab)), acos(dot(n_ca, -n_bc))
    A = alpha + beta + gamma - math.pi
    pdf = 1.0 / torch.clamp(A, min=1e-12)
    Ap = u[..., 0] * A
    ca, sa, cAp, sAp = torch.cos(alpha), torch.sin(alpha), torch.cos(Ap), torch.sin(Ap)
    s = sAp * ca - cAp * sa
    t = cAp * ca + sAp * sa
    uu = t - ca
    vv = s + sa * dot(a, b)
    q = ((vv * t - uu * s) * ca - vv) / torch.clamp((vv * s + uu * t) * sa, min=1e-12)
    q = torch.clamp(q, -1.0, 1.0)
    c_perp = normalize(c - dot(c, a)[..., None] * a)
    c_hat = q[..., None] * a + ssqrt(1.0 - q * q)[..., None] * c_perp
    z = torch.clamp(1.0 - u[..., 1] * (1.0 - dot(c_hat, b)), -1.0, 1.0)
    b_perp = normalize(c_hat - dot(c_hat, b)[..., None] * b)
    w = z[..., None] * b + ssqrt(1.0 - z * z)[..., None] * b_perp
    e1, e2 = v1 - v0, v2 - v0
    ng = cross(e1, e2)
    den = dot(w, ng)
    th = dot(v0 - p, ng) / torch.where(den.abs() < 1e-12, 1e-12, den)
    dd = p + th[..., None] * w - v0
    d11, d12, d22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    dx1, dx2 = dot(dd, e1), dot(dd, e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    bb1 = torch.clamp((d22 * dx1 - d12 * dx2) / det, 0.0, 1.0)
    bb2 = torch.clamp((d11 * dx2 - d12 * dx1) / det, 0.0, 1.0)
    bary = torch.stack([torch.clamp(1.0 - bb1 - bb2, 0.0, 1.0), bb1, bb2], -1)
    degen = A < 1e-5
    flip = u[..., 0] < u[..., 1]
    u0 = torch.where(flip, u[..., 0] / 2.0, u[..., 0] - u[..., 1] / 2.0)
    u1 = torch.where(flip, u[..., 1] - u0, u[..., 1] / 2.0)
    bary = torch.where(degen[..., None], torch.stack([u0, u1, 1.0 - u0 - u1], -1), bary)
    return bary, pdf, degen


def solid_angle_pdf(v0, v1, v2, p):
    a, b, c = normalize(v0 - p), normalize(v1 - p), normalize(v2 - p)
    num = dot(a, cross(b, c))
    den = 1.0 + dot(a, b) + dot(a, c) + dot(b, c)
    bad = (num.abs() < 1e-20) & (den.abs() < 1e-12)
    omega = (2.0 * torch.atan2(torch.where(bad, 0.0, num), torch.where(bad, 1.0, den))).abs()
    return torch.where(omega > 1e-5, 1.0 / torch.clamp(omega, min=1e-12), 0.0)


def render_pixels(sc: Scene, cam: dict, pixels: np.ndarray, seed: int, spp: int,
                  max_depth: int = 4, rr_depth: int = 2, chunk: int = 1024) -> torch.Tensor:
    """The developed linear-sRGB values (K, 3) of `pixels` (flat indices)
    of a `spp`-sample image with sampler seed `seed`; cam: cam_to_world
    (4, 4), fov, width, height."""
    K = len(pixels)
    pix = np.tile(np.asarray(pixels, np.int64), spp)
    smp = np.repeat(np.arange(spp, dtype=np.int64), K)
    xyz = sample_xyz(sc, cam, pix, smp, Sampler(seed, spp), max_depth, rr_depth,
                     chunk).reshape(spp, K, 3)
    # the film: XYZ summed in sample order, averaged, developed
    acc = torch.zeros(K, 3, dtype=sc.dtype, device=sc.device)
    for s in range(spp):
        acc = acc + xyz[s]
    acc = acc / float(spp)
    mtx = torch.as_tensor(sensor_xyz_to_srgb(), device=sc.device).to(sc.dtype)
    return (acc[..., None, :] * mtx).sum(-1).float()


def sample_xyz(sc: Scene, cam: dict, pix: np.ndarray, smp: np.ndarray, smpl: Sampler,
               max_depth: int = 4, rr_depth: int = 2, chunk: int = 1024) -> torch.Tensor:
    """XYZ (R, 3) of one Path sample per lane (pixel `pix`, sample index
    `smp`), non-finite values counted 0; differentiable with respect to
    sc.mat_coeffs."""
    dev, dt = sc.device, sc.dtype
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dt)
    R = len(pix)

    W, H = cam["width"], cam["height"]
    ux, uy = smpl.get_2d(pix, smp, DIM_PIXEL)
    pix_t = torch.as_tensor(pix, device=dev)
    px = (pix_t % W).to(dt) + T(ux)
    py = torch.div(pix_t, W, rounding_mode="floor").to(dt) + T(uy)
    sx = 2.0 * px / W - 1.0
    sy = 1.0 - 2.0 * py / H
    if W / H >= 1.0:
        sx = sx * (W / H)
    else:
        sy = sy / (W / H)
    tan_half = float(np.tan(np.deg2rad(cam["fov"]) / 2.0))
    dc = torch.stack([sx * tan_half, sy * tan_half, torch.ones_like(sx)], -1)
    dc = dc / torch.sqrt((dc * dc).sum(-1, keepdim=True))
    m = T(cam["cam_to_world"])
    o = m[:3, 3].expand(R, 3).clone()
    d = (dc[..., None, :] * m[:3, :3]).sum(-1)
    ul = T(smpl.get_1d(pix, smp, DIM_WAVELENGTH))
    up = torch.remainder(ul[:, None] + torch.arange(N_LAMBDA, device=dev).to(dt) / N_LAMBDA, 1.0)
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * up)
    ch = torch.cosh(0.0072 * (lam - 538.0))
    lam_pdf = torch.where((lam >= 360.0) & (lam <= 830.0), 0.0039398042 / (ch * ch), 0.0)

    L = torch.zeros(R, N_LAMBDA, dtype=dt, device=dev)
    beta = torch.ones_like(L)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    spec_prev = torch.ones_like(active)
    prev_pdf = torch.ones(R, dtype=dt, device=dev)
    prev_p = o
    tri = sc.p

    def visible(o, d, t_max, any_hit):
        with torch.no_grad():
            o, d, t_max = o.detach(), d.detach(), t_max.detach()
            if sc.bvh is not None:
                from . import bvh as bvh_mod

                return bvh_mod.walk(sc.bvh, tri, o, d, t_max, any_hit)
            return intersect(tri, o, d, t_max, any_hit, chunk)

    def shade_hit(o, d, t_max):
        t, prim, b1, b2 = visible(o, d, t_max, False)
        found = prim >= 0
        k = torch.clamp(prim, min=0)
        v0, v1, v2 = tri[k, 0], tri[k, 1], tri[k, 2]
        n = sc.n[k]
        b0 = 1.0 - b1 - b2
        p = o + torch.where(torch.isfinite(t), t, 0.0)[..., None] * d
        ng = normalize(cross(v1 - v0, v2 - v0))
        ns = normalize(b0[..., None] * n[:, 0] + b1[..., None] * n[:, 1] + b2[..., None] * n[:, 2])
        ns = torch.where((dot(ns, ns) < 0.5)[..., None], ng, ns)
        return found, p, ng, ns, v0, v1, v2, sc.mat[k], sc.light[k]

    def add_emission(o, d, L, beta, active, spec_prev, prev_pdf, prev_p):
        found, p, ng, ns, v0, v1, v2, mat, light = shade_hit(
            o, d, torch.where(active, 1e30, -1.0).to(dt))
        wo = -d
        lid = torch.clamp(light, min=0)
        emit = found & (light >= 0) & ((dot(ng, wo) > 0) | sc.light_two[lid])
        le = torch.where(emit[..., None], emission(sc, light, lam), 0.0)
        pdf_l = solid_angle_pdf(v0, v1, v2, prev_p) * sc.pmf[lid]
        w = torch.where(spec_prev, 1.0, power_heuristic(prev_pdf, pdf_l))
        L = L + torch.where(found[..., None], beta * le * w[..., None], 0.0)
        return L, found, p, ng, ns, mat, wo

    for depth in range(max_depth):
        if not bool(active.any()):
            break
        base = DIM_PATH_BASE + depth * DIMS_PER_DEPTH
        L, found, p, ng, ns, mat, wo = add_emission(o, d, L, beta, active, spec_prev,
                                                     prev_pdf, prev_p)
        active = found
        refl = torch.clamp(sigmoid_poly(sc.mat_coeffs[mat], lam) * sc.mat_scale[mat][..., None],
                           min=0.0)
        a = sc.mat_alpha[mat]
        is_cond = sc.mat_conductor[mat]
        wo_l = to_local(ns, wo)

        def bsdf_eval(wi_l):
            side = wo_l[..., 2] * wi_l[..., 2] > 0
            f_d = torch.where(side[..., None], refl * INV_PI, 0.0)
            pdf_d = torch.where(side, wi_l[..., 2].abs() * INV_PI, 0.0)
            f_c, pdf_c = conductor_f_pdf(refl, a, sc.eta, sc.k, wo_l, wi_l)
            return (torch.where(is_cond[..., None], f_c, f_d), torch.where(is_cond, pdf_c, pdf_d))

        # next-event estimation: one light by power, a point by solid angle
        u_sel = T(smpl.get_1d(pix, smp, base + 3))
        lu, lv = smpl.get_2d(pix, smp, base + 4)
        lid = torch.clamp(torch.searchsorted(sc.cdf, u_sel.float().contiguous(), right=True),
                          0, sc.cdf.shape[0] - 1)
        lt = sc.light_tri[lid]
        v0, v1, v2 = tri[lt, 0], tri[lt, 1], tri[lt, 2]
        bary, pdf_sa, degen = spherical_triangle(v0, v1, v2, p, torch.stack([T(lu), T(lv)], -1))
        lp = bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2
        to_lp = lp - p
        d2 = torch.clamp(dot(to_lp, to_lp), min=1e-12)
        dist = torch.sqrt(d2)
        wi = to_lp / dist[..., None]
        cos_lt = dot(normalize(cross(v1 - v0, v2 - v0)), -wi)
        front = sc.light_two[lid] | (cos_lt > 0)
        area = 0.5 * torch.sqrt(dot(cross(v1 - v0, v2 - v0), cross(v1 - v0, v2 - v0)))
        pdf_li = torch.where(degen, d2 / torch.clamp(cos_lt.abs() * area, min=1e-12), pdf_sa)
        li = torch.where(front[..., None], emission(sc, lid, lam), 0.0)
        valid = (pdf_li > 0) & (li > 0).any(-1) & front
        f_l, pdf_b = bsdf_eval(to_local(ns, wi))
        cos_l = dot(wi, ns).abs()
        want = active & valid & (cos_l > 0) & (f_l > 0).any(-1)
        so = offset(p, face_forward(ng, wi), wi)
        s_tmax = torch.where(want, torch.clamp(dist * 0.999, max=1e30), -1.0)
        occluded = visible(so, wi, s_tmax, True)
        pdf_light = pdf_li * sc.pmf[lid]
        take = want & ~occluded
        w_over = torch.where(take, cos_l * power_heuristic(pdf_light, pdf_b)
                             / torch.clamp(pdf_light, min=1e-20), 0.0)
        L = L + beta * torch.where(take[..., None], f_l, 0.0) * w_over[..., None] \
            * torch.where(take[..., None], li, 0.0)

        # BSDF sampling
        ub, vb = smpl.get_2d(pix, smp, base + 1)
        u2 = torch.stack([T(ub), T(vb)], -1)
        dsk = concentric_disk(u2)
        wi_d = torch.stack([dsk[..., 0], dsk[..., 1],
                            ssqrt(1.0 - dsk[..., 0] ** 2 - dsk[..., 1] ** 2)], -1)
        wi_d = torch.where(wo_l[..., 2:3] < 0, wi_d * torch.tensor([1.0, 1.0, -1.0], dtype=dt,
                                                                   device=dev), wi_d)
        wo_up = torch.where(wo_l[..., 2:3] < 0, -wo_l, wo_l)
        wm = sample_wm(wo_up, u2, a)
        wm = torch.where(wo_l[..., 2:3] < 0, -wm, wm)
        wi_c = -wo_l + 2.0 * dot(wo_l, wm)[..., None] * wm
        f_c, pdf_c = conductor_f_pdf(refl, a, sc.eta, sc.k, wo_l, wi_c)
        wi_l = torch.where(is_cond[..., None], wi_c, wi_d)
        f = torch.where(is_cond[..., None], f_c, refl * INV_PI)
        pdf = torch.where(is_cond, pdf_c, wi_d[..., 2].abs() * INV_PI)
        ok = torch.where(is_cond, wo_l[..., 2] * wi_c[..., 2] > 0, True) & (pdf > 0) & (mat >= 0)
        wi_w = from_local(ns, wi_l)
        inv_pdf = torch.where(ok, 1.0 / torch.clamp(torch.where(ok, pdf, 1.0), min=1e-20), 0.0)
        beta_new = beta * f * (dot(wi_w, ns).abs() * inv_pdf)[..., None]
        active = active & ok & (beta_new > 0).any(-1)
        beta = torch.where(active[..., None], beta_new, beta)
        spec_prev = torch.where(active, False, spec_prev)
        prev_pdf = torch.where(active, pdf, prev_pdf)
        prev_p = torch.where(active[..., None], p, prev_p)
        o = torch.where(active[..., None], offset(p, face_forward(ng, wi_w), wi_w), o)
        d = torch.where(active[..., None], wi_w, d)
        if depth >= rr_depth:
            u_rr = T(smpl.get_1d(pix, smp, base + 6))
            q = torch.clamp(1.0 - beta.amax(-1), min=0.0)
            die = active & (u_rr < q)
            active = active & ~die
            beta = torch.where(active[..., None], beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                               beta)
    if bool(active.any()):
        L = add_emission(o, d, L, beta, active, spec_prev, prev_pdf, prev_p)[0]

    w = torch.where(lam_pdf != 0, 1.0 / torch.where(lam_pdf == 0, 1.0, lam_pdf), 0.0)
    cx, cy, cz = cie(lam)
    xyz = torch.stack([(cx * L * w).mean(-1), (cy * L * w).mean(-1), (cz * L * w).mean(-1)],
                      -1) / CIE_Y_INT
    return torch.where(torch.isfinite(xyz), xyz, 0.0)
