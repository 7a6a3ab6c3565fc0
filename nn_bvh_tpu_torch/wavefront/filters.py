"""Reconstruction filters with tabulated importance sampling (port of
nn_bvh_tpu/wavefront/filters.py): box, triangle, gaussian, mitchell and
Lanczos sinc, and their FilterSampler. Every film sample carries the
weight f(p) / pdf(p) of an in-pixel offset drawn from a 32x32 table over
|f|, so the film averages (filter importance sampling).

`evaluate_np` evaluates on the host (numpy); `evaluate` and `sample` on
tensors. The sampling table is built on the CPU; `to_device` moves it to
the device that draws (make_wave_fn does it once), and a draw on another
device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import sampling

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
LANCZOS = 4

_TABLE = 32


class FilterConfig(NamedTuple):
    kind: int
    radius: tuple        # (rx, ry)
    p0: float            # sigma | b | tau
    p1: float            # c
    dist: dict | None    # sampling.make_distribution_2d over |f| (None for box)
    integral: float      # integral of f over the support


def _gauss_np(x, sigma):
    return np.exp(-x * x / (2 * sigma * sigma)) / np.sqrt(2 * np.pi * sigma * sigma)


def _eval_1d_np(kind, x, r, p0, p1):
    ax = np.abs(x)
    if kind == BOX:
        return np.where(ax <= r, 1.0, 0.0)
    if kind == TRIANGLE:
        return np.maximum(0.0, r - ax)
    if kind == GAUSSIAN:
        return np.maximum(0.0, _gauss_np(x, p0) - _gauss_np(r, p0))
    if kind == MITCHELL:
        b, c = p0, p1
        x2 = np.abs(2 * x / r)  # Mitchell is defined on [-2, 2]
        out = np.where(
            x2 > 1,
            ((-b - 6 * c) * x2**3 + (6 * b + 30 * c) * x2**2
             + (-12 * b - 48 * c) * x2 + (8 * b + 24 * c)) / 6,
            ((12 - 9 * b - 6 * c) * x2**3 + (-18 + 12 * b + 6 * c) * x2**2 + (6 - 2 * b)) / 6)
        return np.where(x2 <= 2, out, 0.0)
    if kind == LANCZOS:
        def sinc(v):
            v = np.abs(v) + 1e-9
            return np.sin(np.pi * v) / (np.pi * v)

        return np.where(ax <= r, sinc(x) * sinc(x / p0), 0.0)
    raise ValueError(kind)


def evaluate_np(cfg: FilterConfig, x, y):
    """f(x, y) on the host (the separable product)."""
    rx, ry = cfg.radius
    return (_eval_1d_np(cfg.kind, np.asarray(x), rx, cfg.p0, cfg.p1)
            * _eval_1d_np(cfg.kind, np.asarray(y), ry, cfg.p0, cfg.p1))


def make_filter(kind: str = "box", radius=None, sigma: float = 0.5, b: float = 1.0 / 3.0,
                c: float = 1.0 / 3.0, tau: float = 3.0) -> FilterConfig:
    """A filter with the reference's defaults: box r=0.5, triangle r=2,
    gaussian r=1.5 sigma=0.5, mitchell r=2 b=c=1/3, lanczossinc r=4 tau=3."""
    kinds = {"box": BOX, "triangle": TRIANGLE, "gaussian": GAUSSIAN, "mitchell": MITCHELL,
             "sinc": LANCZOS, "lanczossinc": LANCZOS}
    k = kinds[kind]
    defaults = {BOX: 0.5, TRIANGLE: 2.0, GAUSSIAN: 1.5, MITCHELL: 2.0, LANCZOS: 4.0}
    r = float(radius) if radius is not None else defaults[k]
    p0 = {GAUSSIAN: sigma, MITCHELL: b, LANCZOS: tau}.get(k, 0.0)
    p1 = c if k == MITCHELL else 0.0
    if k == BOX:
        return FilterConfig(k, (r, r), p0, p1, None, (2 * r) ** 2)
    xs = (np.arange(_TABLE) + 0.5) / _TABLE * 2 * r - r
    f1 = _eval_1d_np(k, xs, r, p0, p1)
    f = f1[None, :] * f1[:, None]
    integral = float(f.sum() * (2 * r / _TABLE) ** 2)
    dist = sampling.make_distribution_2d(torch.as_tensor(np.abs(f), dtype=torch.float32))
    return FilterConfig(k, (r, r), p0, p1, dist, integral)


def to_device(cfg: FilterConfig | None, device) -> FilterConfig | None:
    """The filter with its sampling table on `device`."""
    if cfg is None or cfg.dist is None:
        return cfg
    return cfg._replace(dist=sampling.distribution_to(cfg.dist, device))


def _eval_1d(cfg: FilterConfig, x: torch.Tensor, r: float) -> torch.Tensor:
    ax = x.abs()
    k = cfg.kind
    if k == BOX:
        return torch.where(ax <= r, 1.0, 0.0)
    if k == TRIANGLE:
        return torch.clamp(r - ax, min=0.0)
    if k == GAUSSIAN:
        s = cfg.p0
        g = lambda v: torch.exp(-v * v / (2 * s * s)) / np.float32(np.sqrt(2 * np.pi * s * s))
        return torch.clamp(g(x) - g(torch.tensor(r, dtype=torch.float32, device=x.device)),
                           min=0.0)
    if k == MITCHELL:
        b, c = cfg.p0, cfg.p1
        x2 = (2 * x / r).abs()
        hi = ((-b - 6 * c) * x2**3 + (6 * b + 30 * c) * x2**2
              + (-12 * b - 48 * c) * x2 + (8 * b + 24 * c)) / 6
        lo = ((12 - 9 * b - 6 * c) * x2**3 + (-18 + 12 * b + 6 * c) * x2**2 + (6 - 2 * b)) / 6
        return torch.where(x2 <= 1, lo, torch.where(x2 <= 2, hi, 0.0))
    if k == LANCZOS:
        tau = cfg.p0
        sinc = lambda v: (torch.sin(np.pi * (v.abs() + 1e-9))
                          / (np.pi * (v.abs() + 1e-9)))
        return torch.where(ax <= r, sinc(x) * sinc(x / tau), 0.0)
    raise ValueError(k)


def evaluate(cfg: FilterConfig, p: torch.Tensor) -> torch.Tensor:
    """f(p) for offsets p (..., 2) from the pixel center."""
    return _eval_1d(cfg, p[..., 0], cfg.radius[0]) * _eval_1d(cfg, p[..., 1], cfg.radius[1])


def sample(cfg: FilterConfig, u2: torch.Tensor):
    """FilterSampler::Sample: u2 (..., 2) -> (offset (..., 2), weight
    f(p) / pdf(p) (...,)); box: uniform offsets, weight 1."""
    rx, ry = cfg.radius
    extent = torch.tensor([2 * rx, 2 * ry], dtype=torch.float32, device=u2.device)
    if cfg.kind == BOX:
        return (u2 - 0.5) * extent, torch.ones(u2.shape[:-1], dtype=torch.float32,
                                               device=u2.device)
    p01, pdf = sampling.sample_distribution_2d(cfg.dist, u2)
    off = (p01 - 0.5) * extent
    # the table's pdf is over [0,1]^2: rescale to the support's area
    pdf_area = pdf / (4 * rx * ry)
    return off, evaluate(cfg, off) / torch.clamp(pdf_area, min=1e-12)
