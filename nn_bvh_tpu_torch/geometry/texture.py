"""Ray-cone footprint helpers (port of nn_bvh_tpu/geometry/texture.py:154-171).
Texture lookups themselves are not in this slice (ROADMAP queue 1, item 3)."""

from __future__ import annotations

import math

import torch


def camera_spread(fov_deg: float, height: int) -> float:
    """Per-pixel cone spread angle of the camera (radians/pixel)."""
    return 2.0 * math.tan(math.radians(fov_deg) * 0.5) / max(height, 1)


def cone_foot_log2(cone_width, cos_in, uv_scale) -> torch.Tensor:
    """log2 uv-space footprint of a ray cone at the hit."""
    foot_uv = cone_width * uv_scale / torch.sqrt(torch.clamp(cos_in, 1e-2, 1.0))
    return torch.log2(torch.clamp(foot_uv, min=1e-12))
