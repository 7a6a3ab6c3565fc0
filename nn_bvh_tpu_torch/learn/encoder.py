"""Per-level PointNet encoders for treeNet (port of
nn_bvh_tpu/learn/encoder.py).

SAH/point variant: input (..., N, 3 axes): 3x [shared dense C, relu] ->
masked mean pool over N -> 3x regressor [dense, relu / relu / linear] -> 3
local thetas; plus (scale, translate), without gradient, mapping the local
[0, 1] to node space.

EPO/primitive variant: input (..., N, 9) grouped as 3 axes x 3 vertices;
the first layer is a per-axis dense over the 3 vertex coords
(..., N, 3, C), then as above.

Normalisation: per-axis masked min/max of the cloud inside the node;
features scaled to [0, 1) * layer_gamma + 1.

The products stay torch.matmul, as the JAX package left its einsums to XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import common

FIELDS = ("vert", "w1", "w2", "w3", "r1", "r2", "r3")


class EncoderParams(NamedTuple):
    """An encoder's weights as numpy arrays, the JAX package's
    EncoderParams field for field (the carrier of params_from_jax)."""
    vert: np.ndarray | None  # (3, C) EPO first layer over vertex coords, else None
    w1: np.ndarray           # (C, C) EPO, (1, C) SAH
    w2: np.ndarray           # (C, C)
    w3: np.ndarray           # (C, C)
    r1: np.ndarray           # (C, C)
    r2: np.ndarray           # (C, C/2)
    r3: np.ndarray           # (C/2, 1)


def _uniform(shape, limit: float, generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def _he_uniform(shape, generator):
    return _uniform(shape, math.sqrt(6.0 / shape[0]), generator)


def _glorot_uniform(shape, generator):
    return _uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])), generator)


class Encoder(nn.Module):
    """One level's encoder: parameters vert (None for SAH), w1, w2, w3, r1,
    r2, r3 in the JAX package's shapes."""

    def __init__(self, params: dict):
        super().__init__()
        for name in FIELDS:
            v = params.get(name)
            self.register_parameter(name, None if v is None else nn.Parameter(v))


def init_encoder(capacity: int, epo: bool, generator: torch.Generator) -> Encoder:
    """He-uniform layers and a Glorot-uniform last layer, drawn on the CPU
    from `generator`."""
    c = capacity
    he = lambda *s: _he_uniform(s, generator)
    return Encoder(dict(
        vert=he(3, c) if epo else None,
        w1=he(c, c) if epo else he(1, c),
        w2=he(c, c), w3=he(c, c), r1=he(c, c), r2=he(c, c // 2),
        r3=_glorot_uniform((c // 2, 1), generator)))


def _inv_extent(lo, hi):
    ext = hi - lo
    return torch.where(ext > 0, 1.0 / torch.where(ext == 0, 1.0, ext), 0.0)


def _normalize_points(points, mask, gamma: float):
    """points (..., N, 3), mask (..., N) -> features (..., N, 3), min, max."""
    m = mask[..., None]
    pmin = torch.amin(torch.where(m > 0, points, common.BIG), -2)
    pmax = torch.amax(torch.where(m > 0, points, -common.BIG), -2)
    pmin = torch.minimum(pmin, pmax)
    inv = _inv_extent(pmin, pmax)
    feat = (points - pmin[..., None, :]) * inv[..., None, :] * gamma + 1.0
    return feat * m, pmin, pmax


def _normalize_prims(prims, mask, gamma: float):
    """prims (..., N, 9) -> features (..., N, 3 axes, 3 verts), axis min/max."""
    v = torch.stack([prims[..., 0:3], prims[..., 3:6], prims[..., 6:9]], -2)
    m = mask[..., None, None]
    pmin = torch.amin(torch.where(m > 0, v, common.BIG), (-3, -1))
    pmax = torch.amax(torch.where(m > 0, v, -common.BIG), (-3, -1))
    pmin = torch.minimum(pmin, pmax)
    inv = _inv_extent(pmin, pmax)
    feat = (v - pmin[..., None, :, None]) * inv[..., None, :, None] * gamma + 1.0
    return feat * m, pmin, pmax


def apply_encoder(enc: Encoder, cloud, bounds, mask, gamma: float = 4.0):
    """-> (lthetas (..., 3), scale (..., 3), translate (..., 3)).

    thetas = lthetas * scale + translate maps the prediction from the tight
    masked-cloud box to node-bounds-relative coordinates. The cloud, the mask,
    scale and translate carry no gradient; gradients reach the weights
    alone."""
    cloud = cloud.detach()
    mask = mask.detach()
    relu = torch.relu
    if cloud.shape[-1] == 9:
        feat, pmin, pmax = _normalize_prims(cloud, mask, gamma)  # (..., N, 3, 3v)
        h = relu(torch.matmul(feat, enc.vert))
        h = relu(torch.matmul(h, enc.w1))
    else:
        feat, pmin, pmax = _normalize_points(cloud, mask, gamma)  # (..., N, 3)
        h = relu(feat[..., None] * enc.w1[0])  # (..., N, 3, C): 1x1 conv on 1 channel
    h = relu(torch.matmul(h, enc.w2))
    h = relu(torch.matmul(h, enc.w3))

    # masked mean pool over the cloud: (..., 1, N) @ (..., N, 3C)
    n = torch.clamp(mask.sum(-1), min=1.0)
    c = h.shape[-1]
    pooled = torch.matmul(mask[..., None, :], h.flatten(-2)).squeeze(-2)
    pooled = pooled.unflatten(-1, (3, c)) / n[..., None, None]

    g = relu(torch.matmul(pooled, enc.r1))
    g = relu(torch.matmul(g, enc.r2))
    lthetas = torch.matmul(g, enc.r3)[..., 0]

    with torch.no_grad():
        inv = _inv_extent(bounds[..., 0:3], bounds[..., 3:6])
        scale = (pmax - pmin) * inv
        translate = (pmin - bounds[..., 0:3]) * inv
    return lthetas, scale, translate
