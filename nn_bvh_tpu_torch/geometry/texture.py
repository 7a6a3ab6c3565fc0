"""Native-resolution mipmapped textures and ray-cone LOD (port of
nn_bvh_tpu/geometry/texture.py).

- Host (numpy): `build_pyramid` box-filters each RGB image down to 1x1, and
  `pack_atlas` turns every level of every texture into sigmoid-polynomial
  coefficients per texel (core/rgb2spec) packed into one flat (N, 4) atlas,
  with a (T, LMAX, 3) table of [offset, width, height] per level.
- Device (torch): `lookup` reads the flat atlas, bilinear within a level
  (4 gathers), at level 0, at the rounded level of the footprint, or lerped
  across the two bracketing levels (trilinear, 8 gathers). Every index is
  clamped into its table, as XLA clamps out-of-range gathers; indexing a CUDA
  tensor out of range would stop the device instead.
- LOD: the ray-cone footprint helpers (`camera_spread`, `cone_foot_log2`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# host: pyramid build + atlas packing
# ---------------------------------------------------------------------------

def build_pyramid(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered mip chain down to 1x1; odd sizes are edge-padded to even
    before the 2x box."""
    img = np.asarray(img, np.float32)
    levels = [img]
    cur = img
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h % 2 or w % 2:
            cur = np.pad(cur, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
            h, w = cur.shape[:2]
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                      + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(cur.astype(np.float32))
    return levels


def pack_atlas(images: list[np.ndarray]):
    """Mip pyramids of all textures -> (atlas (N, 4) f32, desc (T, LMAX, 3)
    i32 [offset, w, h]). Levels beyond a texture's chain repeat its 1x1 tail,
    so clamping the level needs no per-texture bound."""
    from ..core import rgb2spec

    pyramids = [build_pyramid(im) for im in images]
    lmax = max(len(p) for p in pyramids)
    chunks = []
    desc = np.zeros((len(images), lmax, 3), np.int64)
    offset = 0
    for t, pyr in enumerate(pyramids):
        for lev_i in range(lmax):
            if lev_i < len(pyr):
                lev = pyr[lev_i]
                h, w = lev.shape[:2]
                chunks.append(rgb2spec.rgb_image_to_coeffs(lev).reshape(-1, 4))
                desc[t, lev_i] = (offset, w, h)
                offset += h * w
            else:
                desc[t, lev_i] = desc[t, len(pyr) - 1]
    atlas = np.concatenate(chunks, 0).astype(np.float32)
    return atlas, desc.astype(np.int32)


# ---------------------------------------------------------------------------
# device: lookup
# ---------------------------------------------------------------------------

def _bilerp_level(atlas, off, w, h, uv) -> torch.Tensor:
    """Bilinear fetch inside one level (4 flat gathers); uv in [0, 1] after
    wrapping, texel centres at (i + 0.5) / w, repeat addressing."""
    fx = uv[..., 0] * w.to(torch.float32) - 0.5
    fy = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = (fx - x0.to(torch.float32))[..., None]
    ty = (fy - y0.to(torch.float32))[..., None]
    wm = torch.clamp(w, min=1)
    hm = torch.clamp(h, min=1)
    last = atlas.shape[0] - 1

    def texel(xi, yi):
        # lax.rem of the non-negative x + 16 w; the clamp only ever acts on
        # lanes whose uv is not finite
        xi = torch.remainder(xi + w * 16, wm)
        yi = torch.remainder(yi + h * 16, hm)
        return atlas[torch.clamp(off + yi * w + xi, 0, last).long()]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)


def _level(desc, tid, li):
    d = desc[tid, li]
    return d[..., 0], d[..., 1], d[..., 2]


def lookup(atlas, desc, tex_id, uv, foot_log2=None, trilinear: bool = True) -> torch.Tensor:
    """Filtered texture fetch -> (..., 4) spectral coefficients.

    tex_id (...,) int, clamped to the table; uv (..., 2); foot_log2 (...,)
    log2 of the uv-space footprint width, whose mip level is foot_log2 +
    log2(native width) (None: level 0). trilinear lerps the two bracketing
    levels, else bilinear at the rounded level."""
    T, LMAX, _ = desc.shape
    tid = torch.clamp(tex_id.long(), 0, T - 1)
    uvw = uv - torch.floor(uv)
    if foot_log2 is None:
        return _bilerp_level(atlas, *_level(desc, tid, 0), uvw)
    w0 = desc[tid, 0, 1].to(torch.float32)
    lod = torch.clamp(foot_log2 + torch.log2(torch.clamp(w0, min=1.0)), 0.0, LMAX - 1.0)
    if not trilinear:
        li = torch.clamp(torch.round(lod).long(), 0, LMAX - 1)
        return _bilerp_level(atlas, *_level(desc, tid, li), uvw)
    l0 = torch.clamp(torch.floor(lod).to(torch.int32), 0, LMAX - 1)
    l1 = torch.clamp(l0 + 1, max=LMAX - 1)
    fr = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilerp_level(atlas, *_level(desc, tid, l0.long()), uvw)
    c1 = _bilerp_level(atlas, *_level(desc, tid, l1.long()), uvw)
    return c0 * (1.0 - fr) + c1 * fr


def has_textures(scene) -> bool:
    """Whether `scene` carries an atlas (the 1-texel placeholder is none)."""
    atlas = getattr(scene, "tex_atlas", None)
    return atlas is not None and atlas.shape[0] > 1


# ---------------------------------------------------------------------------
# ray-cone LOD
# ---------------------------------------------------------------------------

def camera_spread(fov_deg: float, height: int) -> float:
    """Per-pixel cone spread angle of the camera (radians/pixel)."""
    return 2.0 * math.tan(math.radians(fov_deg) * 0.5) / max(height, 1)


def cone_foot_log2(cone_width, cos_in, uv_scale) -> torch.Tensor:
    """log2 uv-space footprint of a ray cone at the hit."""
    foot_uv = cone_width * uv_scale / torch.sqrt(torch.clamp(cos_in, 1e-2, 1.0))
    return torch.log2(torch.clamp(foot_uv, min=1e-12))
