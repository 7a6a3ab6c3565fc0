"""sRGB matrices, sensor white balance and the sRGB gamma (port of the
parts of nn_bvh_tpu/core/colorspace.py the port uses). The matrices are
host numpy, computed exactly as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from . import spectrum

XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB).astype(np.float32)
SRGB_WHITE_XYZ = SRGB_TO_XYZ @ np.ones(3, np.float32)

_BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ],
    np.float32,
)
_BRADFORD_INV = np.linalg.inv(_BRADFORD).astype(np.float32)


def white_balance_matrix(src_white_xyz, dst_white_xyz) -> np.ndarray:
    """XYZ->XYZ Bradford adaptation from src to dst whitepoint."""
    lms_src = _BRADFORD @ np.asarray(src_white_xyz, np.float32)
    lms_dst = _BRADFORD @ np.asarray(dst_white_xyz, np.float32)
    d = np.diag(lms_dst / lms_src).astype(np.float32)
    return (_BRADFORD_INV @ d @ _BRADFORD).astype(np.float32)


_WB = white_balance_matrix(spectrum.illuminant_whitepoint_xyz(), SRGB_WHITE_XYZ)
SENSOR_XYZ_TO_SRGB = (XYZ_TO_SRGB @ _WB).astype(np.float32)


def _rgb_space(rx, ry, gx, gy, bx, by, wx, wy):
    """RGB->XYZ matrix from chromaticity primaries + whitepoint."""
    def xyz(x, y):
        return np.array([x / y, 1.0, (1 - x - y) / y], np.float32)

    m = np.stack([xyz(rx, ry), xyz(gx, gy), xyz(bx, by)], axis=1)
    s = np.linalg.solve(m, xyz(wx, wy))
    return (m * s[None, :]).astype(np.float32)


# XYZ -> sRGB from the published primaries: the default sensor's output space
# (the other output spaces are not in this slice)
XYZ_TO_RGB_SRGB = np.linalg.inv(
    _rgb_space(0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290)).astype(np.float32)


def apply_matrix(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """(3,3) host matrix times (..., 3) vectors, in full float32 (a
    broadcast multiply-sum, so no TF32 matmul path is involved)."""
    mt = torch.as_tensor(m, dtype=torch.float32, device=v.device)
    return (v[..., None, :] * mt).sum(-1)


def xyz_to_linear_srgb(xyz: torch.Tensor) -> torch.Tensor:
    """White-balanced sensor XYZ -> linear sRGB."""
    return apply_matrix(SENSOR_XYZ_TO_SRGB, xyz)


def srgb_encode(rgb: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma, clipped to [0, 1]."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.where(rgb <= 0.0031308, 12.92 * rgb,
                       1.055 * torch.pow(rgb, 1.0 / 2.4) - 0.055)

