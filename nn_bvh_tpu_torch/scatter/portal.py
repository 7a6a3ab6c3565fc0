"""Portal image importance sampling (port of nn_bvh_tpu/scatter/portal.py;
PortalImageInfiniteLight).

The equal-area env map is rectified into the portal frame's directional
coordinates (alpha, beta) = (atan2(x, z), atan2(y, z)); in them the portal's
visible window from any point is an axis-aligned rectangle, sampled in
proportion to radiance through a summed-area table by a fixed-depth
bisection (N_BISECT steps). `build_tables` is host numpy; the rest are
batched torch ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import vecmath as vm

RES = 256          # rectified image resolution (square)
N_BISECT = 9       # log2(RES) + 1 bisection steps


def frame_from_quad(q0, q1, q2, q3):
    """Portal frame (host): x along p0->p3, y along p0->p1."""
    x = np.asarray(q3, np.float64) - np.asarray(q0, np.float64)
    y = np.asarray(q1, np.float64) - np.asarray(q0, np.float64)
    x /= max(np.linalg.norm(x), 1e-12)
    y /= max(np.linalg.norm(y), 1e-12)
    z = np.cross(x, y)
    z /= max(np.linalg.norm(z), 1e-12)
    return x.astype(np.float32), y.astype(np.float32), z.astype(np.float32)


def image_from_dir_local(w):
    """Local direction -> (uv (..., 2), duv_dw (...,), valid); valid needs w.z > 0."""
    valid = w[..., 2] > 1e-6
    z = torch.clamp(w[..., 2], min=1e-6)
    alpha = torch.atan2(w[..., 0], z)
    beta = torch.atan2(w[..., 1], z)
    uv = torch.stack([torch.clamp((alpha + math.pi / 2) / math.pi, 0.0, 1.0),
                      torch.clamp((beta + math.pi / 2) / math.pi, 0.0, 1.0)], -1)
    duv_dw = (math.pi ** 2) * (1.0 - w[..., 0] ** 2) * (1.0 - w[..., 1] ** 2) / z
    return uv, duv_dw, valid


def dir_from_image_local(uv):
    """(u, v) -> (local direction (..., 3), duv_dw (...,))."""
    alpha = -math.pi / 2 + uv[..., 0] * math.pi
    beta = -math.pi / 2 + uv[..., 1] * math.pi
    x = torch.tan(torch.clamp(alpha, -1.55, 1.55))
    y = torch.tan(torch.clamp(beta, -1.55, 1.55))
    w = vm.normalize(torch.stack([x, y, torch.ones_like(x)], -1))
    duv_dw = (math.pi ** 2) * (1.0 - w[..., 0] ** 2) * (1.0 - w[..., 1] ** 2) \
        / torch.clamp(w[..., 2], min=1e-6)
    return w, duv_dw


def build_tables(env_rgb: np.ndarray, quad: np.ndarray, res: int = RES, frame=None):
    """Rectify the equal-area env map into portal coordinates and build the
    SAT of its sampling density -> (img_coeffs (res, res, 4), sat (res+1,
    res+1)). quad: (4, 3) corners p0..p3; frame overrides the derived frame.
    The equal-area lookup runs in float32 torch on the CPU, as the JAX
    package runs it in float32 jnp."""
    from ..core import rgb2spec

    if frame is None:
        xw, yw, zw = frame_from_quad(quad[0], quad[1], quad[2], quad[3])
    else:
        xw, yw, zw = frame
    u = (np.arange(res) + 0.5) / res
    U, V = np.meshgrid(u, u, indexing="xy")
    x = np.tan(-np.pi / 2 + U * np.pi)
    y = np.tan(-np.pi / 2 + V * np.pi)
    wl = np.stack([x, y, np.ones_like(x)], -1)
    wl /= np.linalg.norm(wl, axis=-1, keepdims=True)
    wworld = wl[..., 0:1] * xw + wl[..., 1:2] * yw + wl[..., 2:3] * zw
    uv_eq = vm.equal_area_sphere_to_square(
        torch.as_tensor(wworld.reshape(-1, 3), dtype=torch.float32)).numpy()
    he, we = env_rgb.shape[:2]
    xi = np.clip((uv_eq[:, 0] * we).astype(np.int64), 0, we - 1)
    yi = np.clip((uv_eq[:, 1] * he).astype(np.int64), 0, he - 1)
    img = env_rgb[yi, xi].reshape(res, res, 3).astype(np.float32)
    img_coeffs = rgb2spec.rgb_image_to_coeffs(img)
    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]).astype(np.float64)
    duv_dw = (np.pi ** 2) * (1 - wl[..., 0] ** 2) * (1 - wl[..., 1] ** 2) \
        / np.maximum(wl[..., 2], 1e-6)
    dens = lum / np.maximum(duv_dw, 1e-9) + 1e-12
    sat = np.zeros((res + 1, res + 1), np.float64)  # S[j, i] = sum of dens[:j, :i]
    sat[1:, 1:] = np.cumsum(np.cumsum(dens, 0), 1)
    return img_coeffs.astype(np.float32), (sat / sat[-1, -1]).astype(np.float32)


def _sat_tap(sat, x, y):
    """Bilinear SAT lookup at (x, y) in [0, 1]^2."""
    res = sat.shape[0] - 1
    fx = torch.clamp(x, 0.0, 1.0) * res
    fy = torch.clamp(y, 0.0, 1.0) * res
    x0 = torch.clamp(fx.to(torch.int64), 0, res - 1)
    y0 = torch.clamp(fy.to(torch.int64), 0, res - 1)
    tx = fx - x0
    ty = fy - y0
    flat = sat.reshape(-1)
    W = res + 1
    s00 = flat[y0 * W + x0]
    s10 = flat[y0 * W + x0 + 1]
    s01 = flat[(y0 + 1) * W + x0]
    s11 = flat[(y0 + 1) * W + x0 + 1]
    return (s00 * (1 - tx) + s10 * tx) * (1 - ty) + (s01 * (1 - tx) + s11 * tx) * ty


def _window_integral(sat, x0, y0, x1, y1):
    return (_sat_tap(sat, x1, y1) - _sat_tap(sat, x0, y1)
            - _sat_tap(sat, x1, y0) + _sat_tap(sat, x0, y0))


def _bisect(f, lo, hi, target):
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        go_hi = f(mid) < target
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    return 0.5 * (lo + hi)


def sample_windowed(sat, u2, x0, y0, x1, y1):
    """(x, y) inside the window in proportion to the SAT's density ->
    (x, y, pdf_uv, valid): x by bisection on the window's marginal, then y
    within the one-texel column at x."""
    total = _window_integral(sat, x0, y0, x1, y1)
    xs = _bisect(lambda m: _window_integral(sat, x0, y0, m, y1), x0, x1, u2[..., 0] * total)
    res = sat.shape[0] - 1
    cx0 = torch.floor(torch.clamp(xs, 0.0, 1.0 - 1e-6) * res) / res
    cx1 = cx0 + 1.0 / res
    ctotal = _window_integral(sat, cx0, y0, cx1, y1)
    ys = _bisect(lambda m: _window_integral(sat, cx0, y0, cx1, m), y0, y1,
                 u2[..., 1] * ctotal)
    pdf = pdf_windowed(sat, xs, ys, x0, y0, x1, y1)
    return xs, ys, pdf, (total > 1e-12) & (ctotal > 1e-12) & (pdf > 0)


def pdf_windowed(sat, x, y, x0, y0, x1, y1):
    """Window-normalised density at (x, y) (a pdf over the uv square)."""
    res = sat.shape[0] - 1
    total = _window_integral(sat, x0, y0, x1, y1)
    tx0 = torch.floor(torch.clamp(x, 0.0, 1.0 - 1e-6) * res) / res
    ty0 = torch.floor(torch.clamp(y, 0.0, 1.0 - 1e-6) * res) / res
    dens = _window_integral(sat, tx0, ty0, tx0 + 1.0 / res, ty0 + 1.0 / res) * (res * res)
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    return torch.where(inside & (total > 1e-12), dens / torch.clamp(total, min=1e-12), 0.0)
