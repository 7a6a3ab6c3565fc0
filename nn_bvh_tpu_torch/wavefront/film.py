"""Film: pixel accumulation and develop (port of
nn_bvh_tpu/wavefront/film.py): the RGB film with its PixelSensor (white
balance, output color space) and measured camera sensors, and the spectral
film. A Film is a NamedTuple of tensors; `add_samples` returns a new Film,
like the JAX function. Sensors are host numpy."""

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


def spectrum_to_sensor_rgb(values, lam, pdf, curves: torch.Tensor) -> torch.Tensor:
    """MC estimate of a measured sensor's RGB from point samples: (..., 4)
    -> (..., 3), the samples projected on the camera's r/g/b response curves
    (3, 471) (1-nm grid from LAMBDA_MIN), linearly interpolated."""
    w = spectrum.safe_div(torch.ones_like(pdf), pdf)
    f = torch.clamp(lam - spectrum.LAMBDA_MIN, 0.0, curves.shape[1] - 1.001)
    i0 = f.to(torch.int64)
    t = f - i0.to(torch.float32)
    out = []
    for c in range(3):
        resp = curves[c][i0] * (1 - t) + curves[c][i0 + 1] * t
        out.append((resp * values * w).mean(-1))
    return torch.stack(out, -1)


class MeasuredSensor(NamedTuple):
    """A measured camera sensor (PixelSensor with named response curves):
    the swatch-trained camera-RGB -> output XYZ matrix, the response curves
    and the imaging ratio."""

    curves: np.ndarray        # (3, 471) f32 response curves / their g integral
    xyz_from_rgb: np.ndarray  # (3,3) f32 camera RGB (under the wb illuminant) -> XYZ
    imaging_ratio: float


def _f32_curve(fn, lam, *args) -> np.ndarray:
    """A spectrum function evaluated in float32 torch on the CPU (the
    precision the JAX package evaluates its curves in) -> numpy."""
    return fn(torch.as_tensor(lam, dtype=torch.float32), *args).numpy()


def make_measured_sensor(name: str, white_balance_temp: float | None = 6500.0,
                         iso: float = 100.0, exposure: float = 1.0):
    """The MeasuredSensor of the named response curves (`<name>_r/_g/_b` in
    data/named_spectra.npz), None for an unknown name. The 3x3 matrix is the
    least-squares map from the 24 ColorChecker swatches' camera RGB under the
    white-balance illuminant (CIE D65 within 51 K of 6500 K, else a
    blackbody) to their XYZ under D65, the output space's illuminant."""
    from ..core import named_spectra

    if not named_spectra.has(f"{name}_r"):
        return None
    sp = spectrum
    curves = np.stack([named_spectra.dense(f"{name}_{c}") for c in "rgb"])
    lam = np.arange(sp.LAMBDA_MIN, sp.LAMBDA_MAX + 1.0)
    wb = 6500.0 if not white_balance_temp else float(white_balance_temp)
    if named_spectra.has("stdillum-D65"):
        d65 = named_spectra.dense("stdillum-D65")
        d65 = d65 / max(d65[lam == 560.0][0] if (lam == 560.0).any() else d65.max(), 1e-9)
    else:
        d65 = _f32_curve(sp.blackbody_normalized, lam, 6500.0)
    if abs(wb - 6500.0) < 51.0:
        illum = d65
    else:
        illum = _f32_curve(sp.blackbody_normalized, lam, wb)
    out_illum = d65
    sw = np.stack([named_spectra.dense(f"swatch_{i:02d}") for i in range(24)])
    g_int = float((curves[1] * illum).sum())
    rgb_cam = (sw * illum[None, :]) @ curves.T / max(g_int, 1e-9)
    cie = np.stack([_f32_curve(f, lam) for f in (sp.cie_x, sp.cie_y, sp.cie_z)])
    y_int = float((cie[1] * out_illum).sum())
    xyz_out = (sw * out_illum[None, :]) @ cie.T / max(y_int, 1e-9)
    X, *_ = np.linalg.lstsq(rgb_cam, xyz_out, rcond=None)
    # the per-sample projection uses the training projection's normalization
    return MeasuredSensor(curves=(curves / max(g_int, 1e-9)).astype(np.float32),
                          xyz_from_rgb=X.T.astype(np.float32),
                          imaging_ratio=float(exposure * iso / 100.0))


def sensor_curves(sensor, device) -> torch.Tensor | None:
    """A measured sensor's response curves as a tensor on `device`, None
    for any other sensor (its film plane holds XYZ)."""
    if not isinstance(sensor, MeasuredSensor):
        return None
    return torch.as_tensor(sensor.curves, dtype=torch.float32, device=device)


def add_samples(film: Film, pixel_idx: torch.Tensor, L, lam, lam_pdf,
                filter_weight=None, sequential: bool = False,
                sensor_curves: torch.Tensor | None = None) -> Film:
    """Accumulate spectral radiance samples (RGBFilm::AddSample).

    sequential=True asserts pixel_idx == arange(H*W) and adds as vectors;
    otherwise the samples scatter with index_add (on CUDA its float
    atomics make the sum order, and so the last bits, vary run to run
    where a pixel takes more than one sample). With a measured sensor's
    `sensor_curves` the film's xyz plane holds sensor RGB, which develop
    maps through the sensor's matrix."""
    if sensor_curves is None:
        xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    else:
        xyz = spectrum_to_sensor_rgb(L, lam, lam_pdf, sensor_curves)
    w = torch.ones(pixel_idx.shape, dtype=torch.float32, device=xyz.device) \
        if filter_weight is None else filter_weight
    xyz = torch.where(torch.isfinite(xyz), xyz, 0.0)
    if sequential:
        return film._replace(xyz=film.xyz + xyz * w[..., None], weight=film.weight + w)
    idx = pixel_idx.long()
    return film._replace(xyz=film.xyz.index_add(0, idx, xyz * w[..., None]),
                         weight=film.weight.index_add(0, idx, w))


def merge(films: list) -> Film:
    """Sum partial films of one size (the host-side psum analog)."""
    out = films[0]
    for f in films[1:]:
        out = out._replace(xyz=out.xyz + f.xyz, weight=out.weight + f.weight,
                           splat_xyz=out.splat_xyz + f.splat_xyz)
    return out


def add_splats(film: Film, pixel_idx: torch.Tensor, L, lam, lam_pdf) -> Film:
    """Splat spectral samples into arbitrary pixels (AddSplat): their XYZ
    summed into splat_xyz through index_put with accumulate, which on CUDA
    sorts the indices before it adds (not index_add's float atomics): two
    renders of one seed give bit-equal splat films on the card (chip_smoke
    phase 20's "repeatable"). Its sum order is not the CPU's, so splat
    films are compared with a tolerance, never bit for bit."""
    xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    xyz = torch.where(torch.isfinite(xyz), xyz, 0.0)
    return film._replace(splat_xyz=film.splat_xyz.index_put(
        (pixel_idx.long(),), xyz, accumulate=True))


class PixelSensor(NamedTuple):
    """XYZ -> output RGB with white balance folded in, and the imaging
    ratio (exposure * ISO/100)."""

    xyz_to_rgb: np.ndarray   # (3,3) f32
    imaging_ratio: float


def make_sensor(white_balance_temp: float | None = None, iso: float = 100.0,
                exposure: float = 1.0, output_space: str = "srgb") -> PixelSensor:
    """white_balance_temp: the blackbody CCT that should map to neutral
    (pbrt's "whitebalance"); None adapts the renderer's standard illuminant.
    output_space: a key of colorspace.XYZ_TO_RGB."""
    if white_balance_temp is None:
        src = spectrum.illuminant_whitepoint_xyz()
    else:
        lam = np.linspace(spectrum.LAMBDA_MIN, spectrum.LAMBDA_MAX, 471)
        bb = _f32_curve(spectrum.blackbody_normalized, lam, float(white_balance_temp))
        x, y, z = (_f32_curve(f, lam) for f in (spectrum.cie_x, spectrum.cie_y, spectrum.cie_z))
        src = np.array([np.trapezoid(bb * x, lam), np.trapezoid(bb * y, lam),
                        np.trapezoid(bb * z, lam)], np.float32)
        src = src / max(src[1], 1e-9)
    wb = colorspace.white_balance_matrix(src, colorspace.SRGB_WHITE_XYZ)
    m = colorspace.XYZ_TO_RGB[output_space] @ wb
    return PixelSensor(m.astype(np.float32), float(exposure * iso / 100.0))


def develop(film: Film, splat_scale: float = 1.0, sensor=None) -> torch.Tensor:
    """-> (H, W, 3) linear output RGB. A MeasuredSensor's film plane holds
    camera RGB: its matrix maps it to XYZ, then to linear sRGB, times the
    imaging ratio."""
    w = torch.clamp(film.weight, min=1e-9)[:, None]
    xyz = film.xyz / w + splat_scale * film.splat_xyz
    if sensor is None:
        rgb = colorspace.xyz_to_linear_srgb(xyz)
    elif isinstance(sensor, MeasuredSensor):
        x2 = colorspace.apply_matrix(sensor.xyz_from_rgb, xyz)
        rgb = colorspace.xyz_to_linear_srgb(x2) * sensor.imaging_ratio
    else:
        rgb = colorspace.apply_matrix(sensor.xyz_to_rgb, xyz) * sensor.imaging_ratio
    return rgb.reshape(film.height, film.width, 3)


class SpectralFilm(NamedTuple):
    """Per-wavelength-bucket accumulation (SpectralFilm)."""

    buckets: torch.Tensor   # (H*W, NB) radiance sums per wavelength bucket
    bweight: torch.Tensor   # (H*W, NB) per-bucket weight sums
    height: int
    width: int
    lambda_min: float
    lambda_max: float


def make_spectral_film(height: int, width: int, n_buckets: int = 16,
                       lambda_min: float = spectrum.LAMBDA_MIN,
                       lambda_max: float = spectrum.LAMBDA_MAX, device=None) -> SpectralFilm:
    """An empty spectral film on `device` (the CUDA card when None)."""
    device = resolve_device(device)
    z = torch.zeros(height * width, n_buckets, dtype=torch.float32, device=device)
    return SpectralFilm(z, z.clone(), height, width, float(lambda_min), float(lambda_max))


def add_samples_spectral(film: SpectralFilm, pixel_idx: torch.Tensor, L, lam, lam_pdf,
                         filter_weight=None, sequential: bool = False) -> SpectralFilm:
    """Each of the 4 hero-wavelength samples lands in its bucket (the
    truncated, clamped (lam - min) / (max - min) * NB) with the estimate
    L / pdf. sequential as in add_samples."""
    nb = film.buckets.shape[-1]
    t = (lam - film.lambda_min) / (film.lambda_max - film.lambda_min)
    b = torch.clamp((t * nb).to(torch.int64), 0, nb - 1)  # (R, 4)
    w = torch.ones(pixel_idx.shape, dtype=torch.float32, device=L.device) \
        if filter_weight is None else filter_weight
    est = torch.where(lam_pdf > 0, L / torch.clamp(lam_pdf, min=1e-20), 0.0)
    est = torch.where(torch.isfinite(est), est, 0.0) * w[..., None]
    onehot = torch.nn.functional.one_hot(b, nb).to(torch.float32)  # (R, 4, NB)
    vals = (est[..., None] * onehot).sum(1)
    wsum = (w[..., None, None] * onehot).sum(1)
    if sequential:
        return film._replace(buckets=film.buckets + vals, bweight=film.bweight + wsum)
    idx = pixel_idx.long()
    return film._replace(buckets=film.buckets.index_add(0, idx, vals),
                         bweight=film.bweight.index_add(0, idx, wsum))


def develop_spectral(film: SpectralFilm) -> torch.Tensor:
    """-> (H, W, NB) mean spectral radiance per bucket."""
    out = film.buckets / torch.clamp(film.bweight, min=1e-9)
    return out.reshape(film.height, film.width, -1)
