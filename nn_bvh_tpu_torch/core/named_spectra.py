"""Named spectra and .spd files (port of nn_bvh_tpu/core/named_spectra.py,
host numpy).

pbrt's measured spectra (metal eta/k, CIE illuminants, glass dispersion)
live in the repository's `data/named_spectra.npz` as (N, 2) (wavelength_nm,
value) pairs; scenes name them (`"spectrum eta" ["metal-Au-eta"]`) or give
two-column `.spd` files. Illuminants listed under `__normalize__` are scaled
to luminance 1 with the analytic CIE-Y fit, as the JAX package scales them.

On the device a spectrum is a dense 1-nm table over [LAMBDA_MIN,
LAMBDA_MAX] (`dense`), read with one gather and a lerp per sampled
wavelength (scatter.bxdf.sample_spec_table).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from . import spectrum as spec_mod

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data", "named_spectra.npz")

DENSE_N = int(spec_mod.LAMBDA_MAX - spec_mod.LAMBDA_MIN) + 1  # 471 at 1 nm


@lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA, allow_pickle=False)
    normalize = set(str(s) for s in z["__normalize__"])
    out = {}
    for k in z.files:
        if k == "__normalize__":
            continue
        pairs = z[k].astype(np.float64)
        lam, val = pairs[:, 0], pairs[:, 1]
        if k in normalize:
            # scale to luminance 1: CIE_Y_INTEGRAL / <spectrum, Y>
            grid = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
            v = np.interp(grid, lam, val, left=val[0], right=val[-1])
            inner = float(np.sum(v * spec_mod.cie_y(grid)))
            val = val * (spec_mod.CIE_Y_INTEGRAL / max(inner, 1e-12))
        out[k] = (lam, val)
    return out


def names() -> list[str]:
    return sorted(_load().keys())


def has(name: str) -> bool:
    return name in _load()


def get(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(wavelengths_nm, values), normalized where the reference normalizes."""
    try:
        return _load()[name]
    except KeyError:
        raise KeyError(f"unknown named spectrum {name!r}; known: {names()[:8]}...")


def read_spd(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Two-column .spd file (wavelength_nm value per line, '#' comments),
    sorted by wavelength."""
    lam, val = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            lam.append(float(parts[0]))
            val.append(float(parts[1]))
    lam = np.asarray(lam, np.float64)
    val = np.asarray(val, np.float64)
    order = np.argsort(lam)
    return lam[order], val[order]


def dense(name_or_pairs) -> np.ndarray:
    """A named spectrum (str), .spd path or (lam, val) pair on the 1-nm
    device grid -> (DENSE_N,) float32, constant beyond the measured range."""
    if isinstance(name_or_pairs, str):
        if name_or_pairs.endswith(".spd") or os.path.sep in name_or_pairs:
            lam, val = read_spd(name_or_pairs)
        else:
            lam, val = get(name_or_pairs)
    else:
        lam, val = name_or_pairs
    grid = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
    return np.interp(grid, lam, val, left=val[0], right=val[-1]).astype(np.float32)


def eval_at(name_or_pairs, lam_nm: np.ndarray) -> np.ndarray:
    """Piecewise-linear evaluation at arbitrary wavelengths (host)."""
    if isinstance(name_or_pairs, str):
        l, v = get(name_or_pairs)
    else:
        l, v = name_or_pairs
    return np.interp(lam_nm, l, v, left=v[0], right=v[-1])
