"""RGB -> spectrum uplift via sigmoid polynomials (port of
nn_bvh_tpu/core/rgb2spec.py). The Gauss-Newton fit runs on the host in
numpy at scene-build time, exactly as in the JAX package; the device side is
`eval_sigmoid_poly` in torch."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import spectrum, colorspace


def _lam_normalized(lam):
    """Map [LAMBDA_MIN, LAMBDA_MAX] -> [-1, 1]."""
    return (lam - spectrum.LAMBDA_MIN) / (spectrum.LAMBDA_MAX - spectrum.LAMBDA_MIN) * 2.0 - 1.0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def eval_sigmoid_poly(coeffs: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """coeffs (..., 3), lam (..., S) -> spectrum values (..., S)."""
    xn = _lam_normalized(lam)
    x = coeffs[..., 0:1] * xn * xn + coeffs[..., 1:2] * xn + coeffs[..., 2:3]
    return sigmoid(x)


def _reflectance_basis():
    """B (3, nl): spectrum samples -> sensor RGB under the std illuminant."""
    lam = np.arange(spectrum.LAMBDA_MIN, spectrum.LAMBDA_MAX + 1.0, 5.0)
    w = spectrum.illuminant_d(lam)
    cie = np.stack([spectrum.cie_x(lam), spectrum.cie_y(lam), spectrum.cie_z(lam)])
    norm = float(np.sum(spectrum.cie_y(lam) * w))
    B = colorspace.SENSOR_XYZ_TO_SRGB @ (cie * w[None, :]) / norm
    return B.astype(np.float64), lam


def _np_sigmoid(x):
    return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


def fit_sigmoid_coeffs(targets: np.ndarray, iters: int = 60) -> np.ndarray:
    """Vectorized Gauss-Newton fit. targets (N,3) in [0,1] -> coeffs (N,3)."""
    B, lam = _reflectance_basis()
    xn = np.asarray(_lam_normalized(lam), np.float64)
    V = np.stack([xn * xn, xn, np.ones_like(xn)], axis=-1)  # (nl, 3)
    t = np.asarray(targets, np.float64)
    n = t.shape[0]
    c = np.zeros((n, 3))
    mean = np.clip(t.mean(-1), 1e-4, 1 - 1e-4)
    c[:, 2] = (2 * mean - 1) / (2.0 * np.sqrt(mean * (1 - mean)))
    lm = np.full(n, 1e-4)
    for _ in range(iters):
        x = c @ V.T
        s = _np_sigmoid(x)
        r = s @ B.T - t
        ds = 0.5 / np.power(1.0 + x * x, 1.5)
        J = np.einsum("kl,nl,lc->nkc", B, ds, V)
        JtJ = np.einsum("nkc,nkd->ncd", J, J)
        Jtr = np.einsum("nkc,nk->nc", J, r)
        A = JtJ + lm[:, None, None] * np.eye(3)[None]
        try:
            step = np.linalg.solve(A, Jtr[..., None])[..., 0]
        except np.linalg.LinAlgError:
            step = np.linalg.solve(A + 1e-6 * np.eye(3)[None], Jtr[..., None])[..., 0]
        c = c - step
    return c.astype(np.float32)


def rgb_to_coeffs_host(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-color fit. rgb (N,3) >= 0 -> (coeffs (N,3), scale (N,)):
    spectrum = scale * sigmoid_poly(coeffs)."""
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
    m = rgb.max(-1)
    scale = np.where(m > 1.0, 2.0 * m, 1.0).astype(np.float32)
    coeffs = fit_sigmoid_coeffs(rgb / scale[:, None])
    return coeffs, scale


TABLE_RES = 33
_TABLE = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                      f"rgb2spec_srgb_{TABLE_RES}.npy")


@functools.lru_cache(maxsize=1)
def get_table() -> np.ndarray:
    """(33, 33, 33, 3) coefficient table over RGB in [0,1]^3: the
    repository's `data/rgb2spec_srgb_33.npy`, fit_sigmoid_coeffs on that
    grid (the file the JAX package reads)."""
    return np.load(_TABLE)


def rgb_image_to_coeffs(img: np.ndarray) -> np.ndarray:
    """(..., 3) RGB -> (..., 4) [c0, c1, c2, scale] by trilinear lookup in
    get_table (host, scene-build time)."""
    img = np.asarray(img, np.float32)
    table = get_table()
    res = TABLE_RES
    m = img.max(-1)
    scale = np.where(m > 1.0, 2.0 * m, 1.0).astype(np.float32)
    norm = np.clip(img / scale[..., None], 0.0, 1.0)
    f = norm * (res - 1)
    i0 = np.minimum(f.astype(np.int64), res - 2)
    fr = f - i0
    out = np.zeros(img.shape[:-1] + (3,), np.float32)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = ((fr[..., 0] if di else 1 - fr[..., 0])
                     * (fr[..., 1] if dj else 1 - fr[..., 1])
                     * (fr[..., 2] if dk else 1 - fr[..., 2]))
                out += w[..., None] * table[i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk]
    return np.concatenate([out, scale[..., None]], axis=-1)
