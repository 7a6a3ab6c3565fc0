"""Light samplers: uniform and power (port of those kinds of
nn_bvh_tpu/scatter/lightsamplers.py). The light BVH and exhaustive samplers
are not in this slice (ROADMAP queue 1, item 2)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import scene as scene_mod
from ..geometry.scene import host

UNIFORM = 0
POWER = 1


def compute_light_powers(scene) -> np.ndarray:
    """Relative power of each light (host, scene-build time)."""
    lt = host(scene.light_type)
    scale = host(scene.light_scale)
    params = host(scene.light_params)
    bounds = host(scene.bounds)
    radius = 0.5 * float(np.linalg.norm(bounds[1] - bounds[0])) + 1e-6
    tri_p = host(scene.tri_p)
    power = np.zeros(len(lt), np.float64)
    for i, t in enumerate(lt):
        if t == scene_mod.LIGHT_UNIFORM_INFINITE:
            power[i] = 4 * np.pi ** 2 * radius * radius * scale[i]
        elif t == scene_mod.LIGHT_AREA_TRI:
            p = tri_p[int(params[i, 0])]
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
            two = 2.0 if params[i, 1] > 0 else 1.0
            power[i] = np.pi * area * scale[i] * two
        else:
            raise NotImplementedError(f"light tag {t} is not ported yet "
                                      "(ROADMAP queue 1, item 2)")
    return np.maximum(power.astype(np.float32), 0.0)


class LightSamplerTables(NamedTuple):
    kind: int
    pmf: torch.Tensor  # (L,) selection pmf
    cdf: torch.Tensor  # (L,) inclusive cdf


def build(scene, kind: str, device) -> LightSamplerTables:
    kinds = {"uniform": UNIFORM, "power": POWER}
    if kind not in kinds:
        raise NotImplementedError(f"light sampler {kind!r} is not ported yet "
                                  "(ROADMAP queue 1, item 2)")
    k = kinds[kind]
    L = int(scene.n_lights)
    if L == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=device)
        return LightSamplerTables(k, empty, empty)
    if k == UNIFORM:
        pmf = np.full(L, 1.0 / L, np.float32)
    else:
        p = compute_light_powers(scene)
        tot = p.sum()
        pmf = (p / tot).astype(np.float32) if tot > 0 else np.full(L, 1.0 / L, np.float32)
        pmf = np.maximum(pmf, 1e-8)  # never zero-probability a light
        pmf /= pmf.sum()
    cdf = np.cumsum(pmf).astype(np.float32)
    return LightSamplerTables(k, torch.as_tensor(pmf, device=device),
                              torch.as_tensor(cdf, device=device))


def sample_ctx(tables: LightSamplerTables, p: torch.Tensor, u: torch.Tensor):
    """u (R,) -> (light_id (R,) i64, pmf (R,), u_remapped (R,)). Uniform and
    power sampling ignore the reference point p."""
    L = tables.pmf.shape[0]
    if L == 0:
        return torch.full(u.shape, -1, dtype=torch.int64, device=u.device), \
            torch.zeros_like(u), u
    if tables.kind == UNIFORM:
        lid = torch.clamp((u * L).to(torch.int64), max=L - 1)
        u2 = torch.clamp(u * L - lid.to(torch.float32), 0.0, 1.0 - 2 ** -24)
        return lid, torch.full_like(u, 1.0 / L), u2
    lid = torch.clamp(torch.searchsorted(tables.cdf, u, right=True), 0, L - 1)
    pmf_ = tables.pmf[lid]
    lo = torch.where(lid == 0, 0.0, tables.cdf[torch.clamp(lid - 1, min=0)])
    hi = tables.cdf[lid]
    u2 = torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0 - 2 ** -24)
    return lid, pmf_, u2


def pmf_ctx(tables: LightSamplerTables, p: torch.Tensor,
            light_id: torch.Tensor) -> torch.Tensor:
    """Selection pmf of light_id (MIS at emissive hits); ignores p."""
    L = tables.pmf.shape[0]
    if L == 0:
        return torch.zeros(light_id.shape, dtype=torch.float32, device=light_id.device)
    if tables.kind == UNIFORM:
        return torch.full(light_id.shape, 1.0 / L, dtype=torch.float32,
                          device=light_id.device)
    return tables.pmf[torch.clamp(light_id, 0, L - 1).long()]
