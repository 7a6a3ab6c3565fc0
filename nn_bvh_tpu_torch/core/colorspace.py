"""Color spaces, sensor white balance and the sRGB gamma (port of
nn_bvh_tpu/core/colorspace.py). The matrices are host numpy, computed
exactly as in the JAX package; the conversions take tensors."""

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


# The four color spaces (sRGB, DCI-P3, Rec2020, ACES2065-1) as RGB->XYZ
# matrices from their published chromaticities
RGB_TO_XYZ = {
    "srgb": _rgb_space(0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    "dci-p3": _rgb_space(0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    "rec2020": _rgb_space(0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    "aces2065-1": _rgb_space(0.7347, 0.2653, 0.0000, 1.0000, 0.0001, -0.0770,
                             0.32168, 0.33767),
}
XYZ_TO_RGB = {k: np.linalg.inv(v).astype(np.float32) for k, v in RGB_TO_XYZ.items()}
XYZ_TO_RGB_SRGB = XYZ_TO_RGB["srgb"]  # the default sensor's output space


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



def linear_srgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return apply_matrix(SRGB_TO_XYZ, rgb)


def srgb_decode(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB gamma -> linear."""
    return torch.where(srgb <= 0.04045, srgb / 12.92, torch.pow((srgb + 0.055) / 1.055, 2.4))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
