"""Point-sampled spectra: 4 hero wavelengths per ray and the analytic
Wyman-Sloan-Shirley CIE fits (port of nn_bvh_tpu/core/spectrum.py). The
curve functions take numpy arrays (host tables) or torch tensors."""

from __future__ import annotations

import numpy as np
import torch

from . import sampling

N_SPECTRUM_SAMPLES = 4
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def _gauss(x, mu, s1, s2):
    s = _xp(x).where(x < mu, s1, s2)
    t = (x - mu) / s
    return _xp(x).exp(-0.5 * t * t)


def cie_x(lam):
    return (1.056 * _gauss(lam, 599.8, 37.9, 31.0)
            + 0.362 * _gauss(lam, 442.0, 16.0, 26.7)
            - 0.065 * _gauss(lam, 501.1, 20.4, 26.2))


def cie_y(lam):
    return 0.821 * _gauss(lam, 568.8, 46.9, 40.5) + 0.286 * _gauss(lam, 530.9, 16.3, 31.1)


def cie_z(lam):
    return 1.217 * _gauss(lam, 437.0, 11.8, 36.0) + 0.681 * _gauss(lam, 459.0, 26.0, 13.8)


_LAM_1NM = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
CIE_Y_INTEGRAL = float(np.sum(cie_y(_LAM_1NM)))


def sample_wavelengths_visible(u: torch.Tensor):
    """u (...,) -> (lambda (..., 4), pdf (..., 4)), stratified."""
    offsets = torch.arange(N_SPECTRUM_SAMPLES, dtype=torch.float32,
                           device=u.device) / N_SPECTRUM_SAMPLES
    up = torch.remainder(u[..., None] + offsets, 1.0)
    lam = sampling.sample_visible_wavelengths(up)
    return lam, sampling.visible_wavelengths_pdf(lam)


def blackbody(lam_nm, T):
    """Planck's law, W/(m^2 sr nm)-proportional."""
    lam = lam_nm * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    x = (h * c) / (lam * kb * T)
    x = torch.clamp(x, max=80.0) if isinstance(x, torch.Tensor) else np.minimum(x, 80.0)
    return (2.0 * h * c * c) / (lam ** 5 * (_xp(lam_nm).exp(x) - 1.0))


def blackbody_normalized(lam_nm, T):
    lam_max = 2.8977721e-3 / T * 1e9
    peak = float(blackbody(np.float64(lam_max), T))
    return blackbody(lam_nm, T) / peak


STD_ILLUM_CCT = 6504.0


def illuminant_d(lam_nm):
    return blackbody_normalized(lam_nm, STD_ILLUM_CCT)


ILLUM_D_Y = float(np.sum(cie_y(_LAM_1NM) * illuminant_d(_LAM_1NM))) / CIE_Y_INTEGRAL


def illuminant_d_normalized(lam_nm):
    """Illuminant scaled to luminance Y=1."""
    return illuminant_d(lam_nm) / ILLUM_D_Y


def illuminant_whitepoint_xyz() -> np.ndarray:
    w = illuminant_d(_LAM_1NM)
    x = float(np.sum(cie_x(_LAM_1NM) * w))
    y = float(np.sum(cie_y(_LAM_1NM) * w))
    z = float(np.sum(cie_z(_LAM_1NM) * w))
    return np.array([x, y, z]) / y


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b != 0, a / torch.where(b == 0, 1.0, b), 0.0)


def spectrum_to_xyz(values, lam, pdf) -> torch.Tensor:
    """MC estimate of XYZ from point samples: (..., 4) -> (..., 3)."""
    w = safe_div(torch.ones_like(pdf), pdf)
    x = (cie_x(lam) * values * w).mean(-1)
    y = (cie_y(lam) * values * w).mean(-1)
    z = (cie_z(lam) * values * w).mean(-1)
    return torch.stack([x, y, z], -1) / CIE_Y_INTEGRAL
