"""Measured (tabulated) BRDFs (port of nn_bvh_tpu/scatter/measured.py).

A table is a dense isotropic grid over (mu_o, mu_i, dphi / pi) in [0, 1]^3,
each cell the uplift coefficients [c0 c1 c2 scale] of an RGB BRDF value.
On the device (torch): `eval_coeffs` (one 8-corner trilinear gather),
`f`, `pdf` and `sample_f` (a 50/50 mixture of the cosine hemisphere and a
GGX visible-normal proxy fitted to the table). On the host (numpy):
`tabulate` (any RGB BRDF function -> table), `table_to_coeffs`,
`save_table` / `load_table`, `fit_ggx_alpha`, and the RGL `.bsdf` tensor
files of Dupuy and Jakob (`read_bsdf`, `write_bsdf`, `bsdf_to_table`: the
NDF-warped spectra resampled onto the grid with closed-form CDFs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import vecmath as vm, sampling, rgb2spec


def tabulate(fn, res: tuple[int, int, int] = (16, 16, 16)) -> np.ndarray:
    """fn(wo, wi) -> (..., 3) on the grid's cell centres (mu_o, mu_i in
    (0, 1], dphi in [0, pi]) -> (No, Ni, Np, 3) float32 RGB."""
    no, ni, npp = res
    mu_o = (np.arange(no) + 0.5) / no
    mu_i = (np.arange(ni) + 0.5) / ni
    dphi = (np.arange(npp) + 0.5) / npp * np.pi
    MO, MI, DP = np.meshgrid(mu_o, mu_i, dphi, indexing="ij")
    so = np.sqrt(1 - MO ** 2)
    si = np.sqrt(1 - MI ** 2)
    wo = np.stack([so, np.zeros_like(so), MO], -1)
    wi = np.stack([si * np.cos(DP), si * np.sin(DP), MI], -1)
    return np.asarray(fn(wo.astype(np.float32), wi.astype(np.float32))).astype(np.float32)


def table_to_coeffs(table_rgb: np.ndarray) -> np.ndarray:
    """(No, Ni, Np, 3) RGB -> (No, Ni, Np, 4) uplift coefficients."""
    no, ni, npp, _ = table_rgb.shape
    flat = table_rgb.reshape(no, ni * npp, 3)
    return rgb2spec.rgb_image_to_coeffs(flat).reshape(no, ni, npp, 4)


def save_table(path: str, table_rgb: np.ndarray) -> None:
    np.savez_compressed(path, brdf_rgb=table_rgb.astype(np.float32))


def load_table(path: str) -> np.ndarray:
    return np.load(path)["brdf_rgb"]


def eval_coeffs(tab, tab_id, wo, wi):
    """Trilinear lookup -> (..., 4) coefficients. tab (T, No, Ni, Np, 4),
    tab_id (...,) i32, wo and wi in the local frame."""
    T, no, ni, npp, _ = tab.shape
    flat = tab.reshape(T * no * ni * npp, 4)
    mu_o = vm.abs_cos_theta(wo)
    mu_i = vm.abs_cos_theta(wi)
    phi = torch.atan2(wi[..., 1], wi[..., 0]) - torch.atan2(wo[..., 1], wo[..., 0])
    dphi = (torch.remainder(phi + math.pi, 2 * math.pi) - math.pi).abs() / math.pi

    def axis(u, n):
        x = torch.clamp(u * n - 0.5, 0.0, n - 1.0)
        i0 = torch.clamp(x.to(torch.int64), 0, n - 2)
        return i0, x - i0

    io, fo = axis(mu_o, no)
    ii, fi = axis(mu_i, ni)
    ip, fp = axis(dphi, npp)
    base = torch.clamp(tab_id.to(torch.int64), min=0) * (no * ni * npp)
    out = torch.zeros(wo.shape[:-1] + (4,), dtype=torch.float32, device=wo.device)
    for do in (0, 1):
        for di in (0, 1):
            for dp in (0, 1):
                # lanes of other materials carry other ids: clamped, as
                # JAX clamps a gather (their values are selected away)
                idx = torch.clamp(base + ((io + do) * ni + (ii + di)) * npp + (ip + dp),
                                  max=flat.shape[0] - 1)
                w = ((fo if do else 1 - fo) * (fi if di else 1 - fi)
                     * (fp if dp else 1 - fp))
                out = out + w[..., None] * flat[idx]
    return out


def f(tab, tab_id, wo, wi, lam):
    """BRDF value (..., S): the uplift of the interpolated RGB; zero across
    hemispheres (tables hold reflection only)."""
    c = eval_coeffs(tab, tab_id, wo, wi)
    spec = rgb2spec.eval_sigmoid_poly(c[..., 0:3], lam) * c[..., 3:4]
    ok = vm.same_hemisphere(wo, wi)
    return torch.where(ok[..., None], torch.clamp(spec, min=0.0), 0.0)


def pdf(wo, wi, alpha=None):
    """Sampling pdf: half cosine hemisphere, half the GGX visible-normal
    proxy of roughness alpha (plain cosine without alpha)."""
    ok = vm.same_hemisphere(wo, wi)
    pdf_cos = sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi))
    if alpha is None:
        return torch.where(ok, pdf_cos, 0.0)
    from . import bxdf as bx

    sgn = torch.where(wo[..., 2:3] < 0, -1.0, 1.0)
    wo_u = wo * sgn
    wi_u = wi * sgn
    wm = wo_u + wi_u
    wm = vm.normalize(torch.where((vm.length_squared(wm) < 1e-12)[..., None], wo_u, wm))
    pdf_ggx = bx.tr_pdf(wo_u, wm, alpha, alpha) / torch.clamp(4.0 * vm.absdot(wo_u, wm),
                                                              min=1e-9)
    return torch.where(ok, 0.5 * pdf_cos + 0.5 * pdf_ggx, 0.0)


def sample_f(tab, tab_id, wo, lam, u2, uc=None, alpha=None):
    """Mixture sample (cosine, or the GGX proxy's reflection when uc < 0.5)
    -> (wi, f, pdf). A GGX reflection below the horizon is an invalid sample
    (pdf 0), not a fallback."""
    wi_cos = sampling.sample_cosine_hemisphere(u2)
    flip_z = torch.tensor([1.0, 1.0, -1.0], device=wo.device)
    wi_cos = torch.where(wo[..., 2:3] < 0, wi_cos * flip_z, wi_cos)
    if alpha is None or uc is None:
        return wi_cos, f(tab, tab_id, wo, wi_cos, lam), pdf(wo, wi_cos)
    from . import bxdf as bx

    sgn = torch.where(wo[..., 2:3] < 0, -1.0, 1.0)
    wo_u = wo * sgn
    wm = bx.tr_sample_wm(wo_u, u2, alpha, alpha)
    wi_ggx = vm.reflect(wo_u, wm) * sgn
    wi = torch.where((uc < 0.5)[..., None], wi_ggx, wi_cos)
    return wi, f(tab, tab_id, wo, wi, lam), pdf(wo, wi, alpha)


# ---------------------------------------------------------------------------
# RGL .bsdf tensor files (host numpy)
# ---------------------------------------------------------------------------

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}


def read_bsdf(path: str) -> dict:
    """Parse an RGL tensor file -> {field: np.ndarray}."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor file")
    if raw[12] != 1 or raw[13] != 0:
        raise ValueError(f"{path}: unknown tensor-file version {raw[12]}.{raw[13]}")
    n_fields = int(np.frombuffer(raw[14:18], np.uint32)[0])
    pos = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = np.frombuffer(raw[pos:pos + 2], np.uint16)
        pos += 2
        name = raw[pos:pos + name_len].decode()
        pos += int(name_len)
        (ndim,) = np.frombuffer(raw[pos:pos + 2], np.uint16)
        pos += 2
        dtype = raw[pos]
        pos += 1
        (offset,) = np.frombuffer(raw[pos:pos + 8], np.uint64)
        pos += 8
        shape = tuple(int(x) for x in np.frombuffer(raw[pos:pos + 8 * ndim], np.uint64))
        pos += 8 * int(ndim)
        count = int(np.prod(shape)) if shape else 1
        fields[name] = np.frombuffer(raw, _DTYPES[int(dtype)], count, int(offset)).reshape(shape)
    return fields


def write_bsdf(path: str, fields: dict) -> None:
    """Write an RGL tensor file (the inverse of read_bsdf)."""
    rev = {np.dtype(v): k for k, v in _DTYPES.items()}
    header = bytearray(b"tensor_file\x00" + bytes([1, 0]))
    header += np.uint32(len(fields)).tobytes()
    entries = [(name.encode(), np.ascontiguousarray(arr)) for name, arr in fields.items()]
    offset = len(header) + sum(2 + len(n) + 2 + 1 + 8 + 8 * a.ndim for n, a in entries)
    body = bytearray()
    for n, a in entries:
        header += np.uint16(len(n)).tobytes() + n
        header += np.uint16(a.ndim).tobytes()
        header += bytes([rev[a.dtype]])
        header += np.uint64(offset).tobytes()
        for s in a.shape:
            header += np.uint64(s).tobytes()
        body += a.tobytes()
        offset += a.nbytes
    with open(path, "wb") as fh:
        fh.write(bytes(header) + bytes(body))


def _pl1d_cdf(density: np.ndarray, x: np.ndarray) -> np.ndarray:
    """CDF of a piecewise-linear density with nodes at i/(n-1), at x in
    [0, 1]; density (..., n) broadcasts against x."""
    n = density.shape[-1]
    nodes = np.minimum(0.5 * (density[..., :-1] + density[..., 1:]), 1e30)
    cum = np.concatenate([np.zeros(density.shape[:-1] + (1,)), np.cumsum(nodes, -1)], -1)
    total = np.maximum(cum[..., -1], 1e-30)
    t = np.clip(x, 0.0, 1.0) * (n - 1)
    i0 = np.clip(t.astype(np.int64), 0, n - 2)
    fr = t - i0
    d0 = np.take_along_axis(density, i0[..., None], -1)[..., 0]
    d1 = np.take_along_axis(density, (i0 + 1)[..., None], -1)[..., 0]
    c0 = np.take_along_axis(cum, i0[..., None], -1)[..., 0]
    seg = d0 * fr + 0.5 * (d1 - d0) * fr * fr
    return (c0 + seg) / total


def bsdf_to_table(fields: dict, res=(32, 32, 32)) -> np.ndarray:
    """An isotropic RGL measured BRDF resampled onto the (mu_o, mu_i, dphi)
    RGB grid: fr = spectra(R^-1(u_wm)) ndf(u_wm) / (4 sigma(u_wo) cos th_i),
    the warp inverse as the (conditional, marginal) CDFs of the
    per-incidence bilinear vndf slice, the spectra integrated against the
    CIE curves to RGB."""
    from ..core import spectrum as sp

    theta_i = np.asarray(fields["theta_i"], np.float64)
    ndf = np.asarray(fields["ndf"], np.float64)
    sigma = np.asarray(fields["sigma"], np.float64)
    vndf = np.asarray(fields["vndf"], np.float64)
    spectra = np.asarray(fields["spectra"], np.float64)
    lam = np.asarray(fields["wavelengths"], np.float64)
    if vndf.shape[0] > 2:
        raise ValueError("anisotropic RGL tables are not supported")
    P, T, H, W = vndf.shape

    no, ni, npp = res
    mu_o = (np.arange(no) + 0.5) / no
    mu_i = (np.arange(ni) + 0.5) / ni
    dphi = (np.arange(npp) + 0.5) / npp * np.pi
    MO, MI, DP = np.meshgrid(mu_o, mu_i, dphi, indexing="ij")
    so = np.sqrt(1 - MO ** 2)
    si = np.sqrt(1 - MI ** 2)
    wo = np.stack([so, np.zeros_like(so), MO], -1)
    wi = np.stack([si * np.cos(DP), si * np.sin(DP), MI], -1)
    wm = wo + wi
    wm /= np.maximum(np.linalg.norm(wm, axis=-1, keepdims=True), 1e-12)

    theta2u = lambda th: np.sqrt(np.clip(th * (2.0 / np.pi), 0.0, None))
    phi2u = lambda ph: ph / (2.0 * np.pi) + 0.5

    th_o = np.arccos(np.clip(MO, -1, 1))
    th_m = np.arccos(np.clip(wm[..., 2], -1, 1))
    ph_m = np.arctan2(wm[..., 1], wm[..., 0])
    x_wm = theta2u(th_m)
    y_wm = phi2u(ph_m) % 1.0
    u_wo = theta2u(th_o)

    ti = np.interp(th_o, theta_i, np.arange(T))
    i0 = np.clip(ti.astype(np.int64), 0, T - 2)
    tf = (ti - i0)[..., None, None]
    vn = vndf[0]
    v_sl = vn[i0] * (1 - tf) + vn[i0 + 1] * tf

    marg_nodes = v_sl.sum(-1)
    u2 = _pl1d_cdf(marg_nodes, y_wm)
    ty = np.clip(y_wm * (H - 1), 0, H - 1 - 1e-6)
    r0 = np.clip(ty.astype(np.int64), 0, H - 2)
    rf = (ty - r0)[..., None]
    row = (np.take_along_axis(v_sl, r0[..., None, None], -2)[..., 0, :] * (1 - rf)
           + np.take_along_axis(v_sl, (r0 + 1)[..., None, None], -2)[..., 0, :] * rf)
    u1 = _pl1d_cdf(row, x_wm)

    sx = np.clip(u1 * (W - 1), 0, W - 1 - 1e-6)
    sy = np.clip(u2 * (H - 1), 0, H - 1 - 1e-6)
    x0 = sx.astype(np.int64)
    xf = sx - x0
    y0 = sy.astype(np.int64)
    yf = sy - y0
    sp_t = spectra[0]
    L = sp_t.shape[1]

    def gather(tidx, yy, xx):
        return sp_t[tidx, :, yy, xx]

    spec = np.zeros(MO.shape + (L,))
    for dt_, wt_ in ((0, 1 - tf[..., 0, 0]), (1, tf[..., 0, 0])):
        acc = (gather(i0 + dt_, y0, x0) * ((1 - xf) * (1 - yf))[..., None]
               + gather(i0 + dt_, y0, x0 + 1) * (xf * (1 - yf))[..., None]
               + gather(i0 + dt_, y0 + 1, x0) * ((1 - xf) * yf)[..., None]
               + gather(i0 + dt_, y0 + 1, x0 + 1) * (xf * yf)[..., None])
        spec = spec + wt_[..., None] * acc
    spec = np.clip(spec, 0.0, None)

    def bil(tab2d, xx, yy):
        Ht, Wt = tab2d.shape
        tx = np.clip(xx * (Wt - 1), 0, Wt - 1 - 1e-6)
        tyy = np.clip(yy * (Ht - 1), 0, Ht - 1 - 1e-6)
        a0 = tx.astype(np.int64)
        af = tx - a0
        b0 = tyy.astype(np.int64)
        bf = tyy - b0
        return (tab2d[b0, a0] * (1 - af) * (1 - bf) + tab2d[b0, a0 + 1] * af * (1 - bf)
                + tab2d[b0 + 1, a0] * (1 - af) * bf + tab2d[b0 + 1, a0 + 1] * af * bf)

    ndf_v = bil(ndf, x_wm, y_wm)
    sig_v = np.maximum(bil(sigma, u_wo, np.zeros_like(u_wo)), 1e-9)
    scale = ndf_v / (4.0 * sig_v * np.maximum(MI, 1e-4))

    # spectral -> RGB: integrate against the CIE curves, then the sRGB matrix
    lam32 = lam.astype(np.float32)
    cx = np.asarray(sp.cie_x(lam32), np.float64)
    cy = np.asarray(sp.cie_y(lam32), np.float64)
    cz = np.asarray(sp.cie_z(lam32), np.float64)
    norm = np.trapezoid(cy, lam)
    X = np.trapezoid(spec * cx, lam, axis=-1) / norm
    Y = np.trapezoid(spec * cy, lam, axis=-1) / norm
    Z = np.trapezoid(spec * cz, lam, axis=-1) / norm
    M = np.array([[3.2406, -1.5372, -0.4986],
                  [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    rgb = np.clip(np.einsum("ij,...j->...i", M, np.stack([X, Y, Z], -1)), 0.0, None)
    return (rgb * scale[..., None]).astype(np.float32)


def fit_ggx_alpha(table_rgb: np.ndarray) -> float:
    """A GGX roughness for the proxy sampler: moment match of the
    specular-peak profile at mu_o ~ 0.7."""
    no, ni, npp, _ = table_rgb.shape
    lum = table_rgb.mean(-1)
    io = int(0.7 * no)
    mu_i = (np.arange(ni) + 0.5) / ni
    prof = lum[io, :, 0] * mu_i
    tot = prof.sum()
    if tot <= 1e-9:
        return 1.0
    w = prof / tot
    spread = np.sqrt(np.sum(w * (mu_i - (w * mu_i).sum()) ** 2))
    return float(np.clip(2.0 * spread, 0.05, 1.0))
