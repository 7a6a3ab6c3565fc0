"""Light samplers: uniform, power, the light BVH and the exhaustive sampler
(port of nn_bvh_tpu/scatter/lightsamplers.py).

The tables are built on the host (numpy, as in the JAX package) and
uploaded once. The light BVH is a median split over light-bounds centroids
with DirectionCone unions; its Sample is a stochastic descent of
`bvh_depth` lockstep steps over every lane (a Python loop of a host int,
no step reads a value back), its PMF the walk of each light's bit trail.
Infinite and distant lights sit outside the tree and are chosen first with
p_infinite = n_inf / (n_inf + 1). The exhaustive sampler evaluates every
bounded light's importance per lane: an (R, Lb) matrix and its cumsum. The
importance omits the shading normal's cosine (the reference's ctx normal
= 0 case), so Sample and PMF agree without carrying the normal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..geometry import scene as scene_mod
from ..geometry.scene import host

UNIFORM = 0
POWER = 1
BVH = 2
EXHAUSTIVE = 3

_INFINITE_TAGS = (scene_mod.LIGHT_DISTANT, scene_mod.LIGHT_UNIFORM_INFINITE,
                  scene_mod.LIGHT_IMAGE_INFINITE, scene_mod.LIGHT_PORTAL_ENV)
_U_MAX = 1.0 - 2.0 ** -24


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
        if t == scene_mod.LIGHT_POINT:
            power[i] = 4 * np.pi * scale[i]
        elif t == scene_mod.LIGHT_SPOT:
            power[i] = 2 * np.pi * scale[i]
        elif t in (scene_mod.LIGHT_PROJECTION, scene_mod.LIGHT_GONIOMETRIC):
            power[i] = 4 * np.pi * scale[i]
        elif t == scene_mod.LIGHT_DISTANT:
            power[i] = np.pi * radius * radius * scale[i]
        elif t == scene_mod.LIGHT_UNIFORM_INFINITE:
            power[i] = 4 * np.pi ** 2 * radius * radius * scale[i]
        elif t in (scene_mod.LIGHT_IMAGE_INFINITE, scene_mod.LIGHT_PORTAL_ENV):
            lum = host(scene.env_luminance)
            mean_lum = float(lum.mean()) if lum.size > 1 else 1.0
            power[i] = 4 * np.pi ** 2 * radius * radius * scale[i] * mean_lum
        elif t == scene_mod.LIGHT_AREA_TRI:
            p = tri_p[int(params[i, 0])]
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
            two = 2.0 if params[i, 1] > 0 else 1.0
            power[i] = np.pi * area * scale[i] * two
        elif t == scene_mod.LIGHT_SPHERE_AREA:
            r = float(params[i, 0])
            two = 2.0 if params[i, 1] > 0 else 1.0
            power[i] = np.pi * (4 * np.pi * r * r) * scale[i] * two
    return np.maximum(power.astype(np.float32), 0.0)


class LightSamplerTables(NamedTuple):
    kind: int
    pmf: torch.Tensor           # (L,) context-free selection pmf
    cdf: torch.Tensor           # (L,) inclusive cdf
    # light BVH nodes, or the exhaustive sampler's one leaf per bounded
    # light (1-row placeholders for uniform and power)
    node_blo: torch.Tensor   # (N, 3)
    node_bhi: torch.Tensor   # (N, 3)
    node_w: torch.Tensor     # (N, 3) cone axis
    node_cos: torch.Tensor   # (N, 2) [cos_theta_o, cos_theta_e]
    node_phi: torch.Tensor   # (N,)
    node_meta: torch.Tensor  # (N, 3) int64 [second child or light, is_leaf, two_sided]
    light_trail: torch.Tensor   # (L,) int64 bit trail (LSB = first descent)
    light_in_bvh: torch.Tensor  # (L,) bool
    inf_ids: torch.Tensor       # (Li,) int64 infinite/distant light ids
    p_infinite: float = 0.0
    bvh_depth: int = 0
    has_bvh: bool = False


def _cone_union(w1, t1, w2, t2):
    """DirectionCone::Union -> (axis, half-angle)."""
    if t1 < 0:
        return w2, t2
    if t2 < 0:
        return w1, t1
    td = float(np.arccos(np.clip(np.dot(w1, w2), -1.0, 1.0)))
    if min(td + t2, np.pi) <= t1:
        return w1, t1
    if min(td + t1, np.pi) <= t2:
        return w2, t2
    to = (t1 + t2 + td) / 2
    if to >= np.pi:
        return w1, np.pi
    tr = to - t1
    axis = np.cross(w1, w2)
    n = np.linalg.norm(axis)
    if n < 1e-9:
        return w1, np.pi if td > 1e-3 else to
    axis = axis / n
    wr = (w1 * np.cos(tr) + np.cross(axis, w1) * np.sin(tr)
          + axis * np.dot(axis, w1) * (1 - np.cos(tr)))
    return wr / np.linalg.norm(wr), to


def _light_bounds(scene, powers):
    """LightBounds rows (id, lo, hi, w, theta_o, theta_e, phi, two_sided) of
    the bounded lights, and the ids of the infinite and distant ones."""
    lt = host(scene.light_type)
    pos = host(scene.light_pos)
    params = host(scene.light_params)
    tri_p = host(scene.tri_p)
    rows, inf_ids = [], []
    z = np.array([0, 0, 1.0])
    for i, t in enumerate(lt):
        if t in _INFINITE_TAGS:
            inf_ids.append(i)
        elif t == scene_mod.LIGHT_AREA_TRI:
            p = tri_p[int(params[i, 0])]
            n = np.cross(p[1] - p[0], p[2] - p[0])
            ln = np.linalg.norm(n)
            rows.append((i, p.min(0), p.max(0), n / ln if ln > 1e-12 else z, 0.0,
                         np.pi / 2, powers[i], params[i, 1] > 0))
        elif t == scene_mod.LIGHT_SPHERE_AREA:
            r = float(params[i, 0])
            rows.append((i, pos[i] - r, pos[i] + r, z, np.pi, np.pi / 2, powers[i],
                         params[i, 1] > 0))
        elif t == scene_mod.LIGHT_SPOT:
            rows.append((i, pos[i], pos[i], params[i, 0:3],
                         float(np.arccos(np.clip(params[i, 3], -1, 1))), np.pi / 2,
                         powers[i], False))
        else:  # point (and the texture-driven point lights)
            rows.append((i, pos[i], pos[i], z, np.pi, np.pi / 2, powers[i], False))
    return rows, inf_ids


def _build_light_bvh(rows):
    """Median split over light-bounds centroids -> flat node arrays (the
    first child of node k is k + 1, the second meta[k, 0]) and each light's
    bit trail."""
    nodes = []
    trails = {}

    def emit(lights, trail, depth):
        my = len(nodes)
        nodes.append(None)
        if len(lights) == 1:
            i, lo, hi, w, to, te, phi, two = lights[0]
            nodes[my] = dict(blo=lo, bhi=hi, w=w, cos=(np.cos(to), np.cos(te)),
                             phi=phi, child=i, leaf=1, two=int(two))
            trails[i] = trail
            return my
        cents = np.stack([(l[1] + l[2]) * 0.5 for l in lights])
        axis = int(np.argmax(cents.max(0) - cents.min(0)))
        order = np.argsort(cents[:, axis], kind="stable")
        half = len(lights) // 2
        emit([lights[j] for j in order[:half]], trail, depth + 1)
        c1 = emit([lights[j] for j in order[half:]], trail | (1 << depth), depth + 1)
        blo = np.minimum.reduce([l[1] for l in lights])
        bhi = np.maximum.reduce([l[2] for l in lights])
        w, t = lights[0][3], lights[0][4]
        for l in lights[1:]:
            w, t = _cone_union(np.asarray(w, np.float64), t, np.asarray(l[3], np.float64), l[4])
        nodes[my] = dict(blo=blo, bhi=bhi, w=w, cos=(np.cos(t), np.cos(max(l[5] for l in lights))),
                         phi=sum(l[6] for l in lights), child=c1, leaf=0,
                         two=int(any(l[7] for l in lights)))
        return my

    emit(rows, 0, 0)
    blo = np.stack([nd["blo"] for nd in nodes]).astype(np.float32)
    bhi = np.stack([nd["bhi"] for nd in nodes]).astype(np.float32)
    w = np.stack([np.asarray(nd["w"], np.float32) for nd in nodes])
    cos = np.asarray([nd["cos"] for nd in nodes], np.float32)
    phi = np.asarray([nd["phi"] for nd in nodes], np.float32)
    meta = np.asarray([[nd["child"], nd["leaf"], nd["two"]] for nd in nodes], np.int32)
    return blo, bhi, w, cos, phi, meta, trails, len(nodes)


def build(scene, kind: str, device) -> LightSamplerTables:
    """The sampler `kind` (uniform | power | bvh | exhaustive) of `scene`,
    uploaded to `device`. bvh and exhaustive fall back to power and uniform
    sampling when every light is infinite, as in the JAX package."""
    kinds = {"uniform": UNIFORM, "power": POWER, "bvh": BVH, "exhaustive": EXHAUSTIVE}
    if kind not in kinds:
        raise ValueError(f"unknown light sampler {kind!r}")
    k = kinds[kind]
    L = int(scene.n_lights)
    up = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)
    dummy = dict(node_blo=up(np.zeros((1, 3))), node_bhi=up(np.zeros((1, 3))),
                 node_w=up(np.zeros((1, 3))), node_cos=up(np.zeros((1, 2))),
                 node_phi=up(np.zeros(1)), node_meta=up(np.zeros((1, 3)), torch.int64),
                 light_trail=up(np.zeros(max(L, 1)), torch.int64),
                 light_in_bvh=up(np.zeros(max(L, 1)), torch.bool),
                 inf_ids=up(np.zeros(1), torch.int64))
    if L == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=device)
        return LightSamplerTables(k, empty, empty, **dummy)
    if k in (UNIFORM, EXHAUSTIVE):
        pmf = np.full(L, 1.0 / L, np.float32)
    else:
        p = compute_light_powers(scene)
        tot = p.sum()
        pmf = (p / tot).astype(np.float32) if tot > 0 else np.full(L, 1.0 / L, np.float32)
        pmf = np.maximum(pmf, 1e-8)  # never zero-probability a light
        pmf /= pmf.sum()
    cdf = np.cumsum(pmf).astype(np.float32)
    if k in (BVH, EXHAUSTIVE):
        rows, inf_ids = _light_bounds(scene, compute_light_powers(scene))
        if rows:
            n_inf = len(inf_ids)
            common = dict(inf_ids=up(inf_ids if inf_ids else [0], torch.int64),
                          p_infinite=float(n_inf / (n_inf + 1.0) if n_inf else 0.0),
                          has_bvh=True)
            in_bvh = np.zeros(L, bool)
            trail_arr = np.zeros(L, np.int64)
            if k == EXHAUSTIVE:
                ids = np.asarray([r[0] for r in rows], np.int32)
                blo = np.stack([r[1] for r in rows])
                bhi = np.stack([r[2] for r in rows])
                w = np.stack([np.asarray(r[3], np.float32) for r in rows])
                cos = np.asarray([(np.cos(r[4]), np.cos(r[5])) for r in rows], np.float32)
                phi = np.asarray([r[6] for r in rows], np.float32)
                meta = np.stack([ids, np.ones_like(ids),
                                 np.asarray([int(bool(r[7])) for r in rows], np.int32)], 1)
                in_bvh[ids] = True
                depth = 0
            else:
                blo, bhi, w, cos, phi, meta, trails, _ = _build_light_bvh(rows)
                for lid, tr in trails.items():
                    trail_arr[lid] = tr
                    in_bvh[lid] = True
                depth = int(np.ceil(np.log2(max(len(rows), 2)))) + 2
            return LightSamplerTables(
                k, up(pmf), up(cdf), node_blo=up(blo.astype(np.float32)),
                node_bhi=up(bhi.astype(np.float32)), node_w=up(w), node_cos=up(cos),
                node_phi=up(phi), node_meta=up(meta, torch.int64),
                light_trail=up(trail_arr, torch.int64), light_in_bvh=up(in_bvh, torch.bool),
                bvh_depth=depth, **common)
        k = UNIFORM if k == EXHAUSTIVE else POWER  # only infinite lights
    return LightSamplerTables(k, up(pmf), up(cdf), **dummy)


# ---------------------------------------------------------------------------
# importance (CompactLightBounds::Importance without the normal's cosine)
# ---------------------------------------------------------------------------

def _cos_sub(sin_a, cos_a, sin_b, cos_b):
    return torch.where(cos_a > cos_b, 1.0, cos_a * cos_b + sin_a * sin_b)


def _sin_sub(sin_a, cos_a, sin_b, cos_b):
    return torch.where(cos_a > cos_b, 0.0, sin_a * cos_b - cos_a * sin_b)


def _importance(t: LightSamplerTables, node, p):
    """Importance of nodes `node` (any shape broadcasting with p[..., 0])
    at points p."""
    blo, bhi, w = t.node_blo[node], t.node_bhi[node], t.node_w[node]
    cos_o, cos_e = t.node_cos[node, 0], t.node_cos[node, 1]
    phi = t.node_phi[node]
    two = t.node_meta[node, 2] > 0
    pc = 0.5 * (blo + bhi)
    d2 = torch.maximum(vm.length_squared(p - pc), vm.length(bhi - blo) / 2.0)
    cos_w = vm.dot(w, vm.normalize(p - pc))
    cos_w = torch.where(two, cos_w.abs(), cos_w)
    sin_w = vm.safe_sqrt(1.0 - cos_w * cos_w)
    r2 = vm.length_squared(bhi - pc)
    dc2 = vm.length_squared(p - pc)
    sin2_b = torch.clamp(r2 / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
    cos_b = torch.where(dc2 <= r2, -1.0, vm.safe_sqrt(1.0 - sin2_b))
    sin_b = vm.safe_sqrt(1.0 - cos_b * cos_b)
    sin_o = vm.safe_sqrt(1.0 - cos_o * cos_o)
    cos_x = _cos_sub(sin_w, cos_w, sin_o, cos_o)
    sin_x = _sin_sub(sin_w, cos_w, sin_o, cos_o)
    cos_p = _cos_sub(sin_x, cos_x, sin_b, cos_b)
    imp = torch.where(cos_p <= cos_e, 0.0, phi * cos_p / d2)
    return torch.clamp(imp, min=0.0)


def _exhaustive_importances(t: LightSamplerTables, p):
    """(R, Lb) importances of every bounded light at p (R, 3)."""
    Lb = t.node_phi.shape[0]
    return _importance(t, torch.arange(Lb, device=p.device)[None, :], p[:, None, :])


def _infinite_choice(t: LightSamplerTables, u):
    """(take_inf, inf_id, inf_pmf, u remapped into the bounded lights,
    1 - p_infinite). p_infinite is a float32 here, and so are the
    constants made from it, as in the JAX package's Sample."""
    n_inf = t.inf_ids.shape[0] if t.p_infinite > 0 else 0
    p_inf = np.float32(t.p_infinite)
    rest = float(max(np.float32(1.0) - p_inf, np.float32(1e-9)))
    take_inf = u < float(p_inf)
    if n_inf > 0:
        ui = torch.clamp(u / float(max(p_inf, np.float32(1e-9))), 0.0, _U_MAX)
        inf_id = t.inf_ids[torch.clamp((ui * n_inf).to(torch.int64), max=n_inf - 1)]
        inf_pmf = float(p_inf / np.float32(n_inf))
    else:
        inf_id = torch.full(u.shape, -1, dtype=torch.int64, device=u.device)
        inf_pmf = 0.0
    ub = torch.clamp((u - float(p_inf)) / rest, 0.0, _U_MAX)
    return take_inf, inf_id, inf_pmf, ub, float(np.float32(1.0) - p_inf)


def sample_ctx(t: LightSamplerTables, p, u):
    """Context-aware Sample: p (R,3) reference points, u (R,) -> (light_id
    (R,) int64, -1 where none, pmf (R,), u remapped (R,))."""
    if t.kind == EXHAUSTIVE and t.has_bvh:
        return _sample_exhaustive(t, p, u)
    if t.kind != BVH or not t.has_bvh:
        return sample(t, u)
    take_inf, inf_id, inf_pmf, ub, _ = _infinite_choice(t, u)
    R = u.shape[0]
    node = torch.zeros(R, dtype=torch.int64, device=u.device)
    pmf_acc = torch.full((R,), 1.0 - t.p_infinite, dtype=torch.float32, device=u.device)
    ok = u > -1.0
    last = t.node_phi.shape[0] - 1
    for _ in range(t.bvh_depth):
        is_leaf = t.node_meta[node, 1] > 0
        c0 = node + 1
        c1 = t.node_meta[node, 0]
        # a leaf's "children" are read clamped, as XLA clamps a gather, and
        # never taken
        i0 = _importance(t, torch.clamp(c0, max=last), p)
        i1 = _importance(t, torch.clamp(c1, 0, last), p)
        tot = i0 + i1
        dead = ~is_leaf & (tot <= 0)
        w0 = torch.where(tot > 0, i0 / torch.clamp(tot, min=1e-30), 0.5)
        go0 = ub < w0
        ub_new = torch.where(go0, ub / torch.clamp(w0, min=1e-9),
                             (ub - w0) / torch.clamp(1.0 - w0, min=1e-9))
        ub_new = torch.clamp(ub_new, 0.0, _U_MAX)
        upd = ~is_leaf & ~dead
        node = torch.where(upd, torch.where(go0, c0, c1), node)
        ub = torch.where(upd, ub_new, ub)
        pmf_acc = torch.where(upd, pmf_acc * torch.where(go0, w0, 1.0 - w0), pmf_acc)
        ok = ok & ~dead
    light = t.node_meta[node, 0]
    lid = torch.where(take_inf, inf_id, torch.where(ok, light, -1))
    valid = torch.where(take_inf, inf_id >= 0, ok)
    return (torch.where(valid, lid, -1), torch.where(take_inf, inf_pmf, pmf_acc),
            torch.where(take_inf, 0.0, ub))


def _sample_exhaustive(t: LightSamplerTables, p, u):
    """Infinite lights first with p_infinite, else cdf inversion over the
    per-lane importances of every bounded light."""
    take_inf, inf_id, inf_pmf, ub, bounded = _infinite_choice(t, u)
    imp = _exhaustive_importances(t, p)
    total = imp.sum(-1)
    csum = torch.cumsum(imp, -1)
    target = ub[:, None] * total[:, None]
    idx = torch.clamp((csum <= target).to(torch.int64).sum(-1), 0, imp.shape[1] - 1)
    sel_imp = imp.gather(-1, idx[:, None])[:, 0]
    lo = torch.where(idx == 0, 0.0,
                     csum.gather(-1, torch.clamp(idx - 1, min=0)[:, None])[:, 0])
    u2 = torch.clamp((target[:, 0] - lo) / torch.clamp(sel_imp, min=1e-20), 0.0, _U_MAX)
    pmf_b = bounded * sel_imp / torch.clamp(total, min=1e-30)
    lid = torch.where(take_inf, inf_id, torch.where(total > 0, t.node_meta[idx, 0], -1))
    return lid, torch.where(take_inf, inf_pmf, pmf_b), torch.where(take_inf, 0.0, u2)


def pmf_ctx(t: LightSamplerTables, p, light_id):
    """Context-aware PMF of light_id at p (MIS at emissive hits)."""
    L = t.pmf.shape[0]
    if t.has_bvh and t.kind in (BVH, EXHAUSTIVE):
        lid = torch.clamp(light_id, 0, L - 1).long()
        in_b = t.light_in_bvh[lid]
        n_inf = t.inf_ids.shape[0] if t.p_infinite > 0 else 0
        inf_pmf = (t.p_infinite / n_inf) if n_inf > 0 else 0.0
        if t.kind == EXHAUSTIVE:
            imp = _exhaustive_importances(t, p)
            match = t.node_meta[None, :, 0] == lid[:, None]
            light_imp = torch.where(match, imp, 0.0).sum(-1)
            pmf_b = (1.0 - t.p_infinite) * light_imp / torch.clamp(imp.sum(-1), min=1e-30)
            return torch.where(in_b, pmf_b, inf_pmf)
        trail = t.light_trail[lid]
        node = torch.zeros_like(lid)
        pmf_acc = torch.full(lid.shape, 1.0 - t.p_infinite, dtype=torch.float32,
                             device=lid.device)
        done = torch.zeros(lid.shape, dtype=torch.bool, device=lid.device)
        last = t.node_phi.shape[0] - 1
        for _ in range(t.bvh_depth):
            is_leaf = t.node_meta[node, 1] > 0
            c0 = node + 1
            c1 = t.node_meta[node, 0]
            i0 = _importance(t, torch.clamp(c0, max=last), p)
            i1 = _importance(t, torch.clamp(c1, 0, last), p)
            bit = (trail & 1) == 1
            pmf_new = pmf_acc * torch.where(bit, i1, i0) / torch.clamp(i0 + i1, min=1e-30)
            upd = ~done & ~is_leaf
            node = torch.where(upd, torch.where(bit, c1, c0), node)
            trail = torch.where(upd, trail >> 1, trail)
            pmf_acc = torch.where(upd, pmf_new, pmf_acc)
            done = done | is_leaf
        return torch.where(in_b, pmf_acc, inf_pmf)
    return pmf(t, light_id)


def sample(t: LightSamplerTables, u):
    """Context-free sample: u (R,) -> (light_id (R,) int64, pmf, u remapped)."""
    L = t.pmf.shape[0]
    if L == 0:
        return torch.full(u.shape, -1, dtype=torch.int64, device=u.device), \
            torch.zeros_like(u), u
    if t.kind in (UNIFORM, EXHAUSTIVE):
        lid = torch.clamp((u * L).to(torch.int64), max=L - 1)
        u2 = torch.clamp(u * L - lid.to(torch.float32), 0.0, _U_MAX)
        return lid, torch.full_like(u, 1.0 / L), u2
    lid = torch.clamp(torch.searchsorted(t.cdf, u, right=True), 0, L - 1)
    lo = torch.where(lid == 0, 0.0, t.cdf[torch.clamp(lid - 1, min=0)])
    hi = t.cdf[lid]
    u2 = torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, _U_MAX)
    return lid, t.pmf[lid], u2


def pmf(t: LightSamplerTables, light_id):
    """Context-free selection pmf of light_id."""
    L = t.pmf.shape[0]
    if L == 0:
        return torch.zeros(light_id.shape, dtype=torch.float32, device=light_id.device)
    if t.kind in (UNIFORM, EXHAUSTIVE):
        return torch.full(light_id.shape, 1.0 / L, dtype=torch.float32, device=light_id.device)
    return t.pmf[torch.clamp(light_id, 0, L - 1).long()]
