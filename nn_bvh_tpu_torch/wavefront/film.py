"""Film: pixel accumulation and develop (port of the RGB film of
nn_bvh_tpu/wavefront/film.py). A Film is a NamedTuple of tensors;
`add_samples` returns a new Film, like the JAX function."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import colorspace, spectrum
from ..devices import resolve_device


class Film(NamedTuple):
    xyz: torch.Tensor        # (H*W, 3) weighted XYZ sums
    weight: torch.Tensor     # (H*W,) filter-weight sums
    splat_xyz: torch.Tensor  # (H*W, 3) splat accumulation
    height: int
    width: int


def make_film(height: int, width: int, device=None) -> Film:
    """An empty film on `device` (the CUDA card when None)."""
    device = resolve_device(device)
    n = height * width
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return Film(z(n, 3), z(n), z(n, 3), height, width)


def add_samples(film: Film, pixel_idx: torch.Tensor, L, lam, lam_pdf,
                filter_weight=None, sequential: bool = False) -> Film:
    """Accumulate spectral radiance samples (RGBFilm::AddSample).

    sequential=True asserts pixel_idx == arange(H*W) and adds as vectors;
    otherwise the samples scatter with index_add (on CUDA its float
    atomics make the sum order, and so the last bits, vary run to run)."""
    xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    w = torch.ones(pixel_idx.shape, dtype=torch.float32, device=xyz.device) \
        if filter_weight is None else filter_weight
    xyz = torch.where(torch.isfinite(xyz), xyz, 0.0)
    if sequential:
        return film._replace(xyz=film.xyz + xyz * w[..., None], weight=film.weight + w)
    idx = pixel_idx.long()
    return film._replace(xyz=film.xyz.index_add(0, idx, xyz * w[..., None]),
                         weight=film.weight.index_add(0, idx, w))


class PixelSensor(NamedTuple):
    xyz_to_rgb: np.ndarray   # (3,3) f32
    imaging_ratio: float


def make_sensor(white_balance_temp: float | None = None, iso: float = 100.0,
                exposure: float = 1.0) -> PixelSensor:
    """The default sensor contract: adapt the renderer's standard illuminant
    to sRGB white. Other white-balance temperatures are not in this slice."""
    if white_balance_temp is not None:
        raise NotImplementedError("white-balance temperatures are not ported "
                                  "yet (ROADMAP queue 1, item 8)")
    wb = colorspace.white_balance_matrix(spectrum.illuminant_whitepoint_xyz(),
                                         colorspace.SRGB_WHITE_XYZ)
    m = colorspace.XYZ_TO_RGB_SRGB @ wb
    return PixelSensor(m.astype(np.float32), float(exposure * iso / 100.0))


def develop(film: Film, splat_scale: float = 1.0,
            sensor: PixelSensor | None = None) -> torch.Tensor:
    """-> (H, W, 3) linear sRGB."""
    w = torch.clamp(film.weight, min=1e-9)[:, None]
    xyz = film.xyz / w + splat_scale * film.splat_xyz
    if sensor is None:
        rgb = colorspace.xyz_to_linear_srgb(xyz)
    else:
        rgb = colorspace.apply_matrix(sensor.xyz_to_rgb, xyz) * sensor.imaging_ratio
    return rgb.reshape(film.height, film.width, 3)
