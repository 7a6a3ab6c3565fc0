"""Plain reference of a treeNet training step (EPO variant) and Adam.

The treeNet split learner of nss (cgaueb/nss, with the fork's EPO
variant), written out again: per interior level of the static 6-wide node
tree, a PointNet encoder over the whole primitive cloud (a per-axis dense
layer over the three vertex coordinates, three C x C layers, a masked mean
pool, a C -> C -> C/2 -> 1 regressor per axis) predicts one split plane per
axis; the children's bounds come from primitive-midpoint classification;
the tree cost blends SAH with the EPO overlap term, pooled bottom-up by a
hard min; the loss is the root cost's square plus an out-of-bounds huber
penalty. The discrete events carry the reference's event gradients: the
child bound moves to the next primitive's extent over the distance to it,
the EPO term by the surface of the next primitive to stop overlapping, and
the min back-propagates a softmax of the negated costs. Adam is written
out as its update rule.

It imports torch only, and takes the weights and clouds as tensors.
"""

from __future__ import annotations

import torch

BIG = 1e9
CLIP = 1.0 / 1e-4
F = torch.float32


def _mmin(x, m):
    return torch.amin(torch.where(m > 0, x, BIG), -1)


def _mmax(x, m):
    return torch.amax(torch.where(m > 0, x, -BIG), -1)


def _div(n, d):
    return n / torch.where(d.abs() < 1e-12, 1e-12, d)


def _inside(g, off, lo, hi):
    return g * (off >= lo).to(F) * (off <= hi).to(F)


def _clip(x, lo, hi):
    return torch.minimum(hi, torch.maximum(lo, x))


class LeftBound(torch.autograd.Function):
    """Max extent of the prims whose mid lies left of the plane."""

    @staticmethod
    def forward(ctx, ap, m, lo, hi, off):
        mx = ap.amax(-1)
        mid = 0.5 * (ap.amin(-1) + mx)
        b = torch.maximum(_mmax(mx, m * (off[..., None] >= mid).to(F)), lo)
        ctx.save_for_backward(ap, m, lo, hi, off, b)
        return b

    @staticmethod
    def backward(ctx, up):
        ap, m, lo, hi, off, b = ctx.saved_tensors
        mx = ap.amax(-1)
        mid = 0.5 * (ap.amin(-1) + mx)
        right = m * (b[..., None] < mid).to(F)
        nxt = _mmin(mid, right)
        b_next = _mmax(mx, right * (mid == nxt[..., None]).to(F))
        slope = torch.where(nxt < BIG, _div(b_next - b, nxt - off), 0.0).clamp(0.0, CLIP)
        return None, None, None, None, _inside(up * slope, off, lo, hi)


class RightBound(torch.autograd.Function):
    """Min extent of the prims whose mid lies right of the plane."""

    @staticmethod
    def forward(ctx, ap, m, lo, hi, off):
        mn = ap.amin(-1)
        mid = 0.5 * (mn + ap.amax(-1))
        b = torch.minimum(_mmin(mn, m * (off[..., None] < mid).to(F)), hi)
        ctx.save_for_backward(ap, m, lo, hi, off, b)
        return b

    @staticmethod
    def backward(ctx, up):
        ap, m, lo, hi, off, b = ctx.saved_tensors
        mn = ap.amin(-1)
        mid = 0.5 * (mn + ap.amax(-1))
        left = m * (b[..., None] >= mid).to(F)
        prv = _mmax(mid, left)
        b_prev = _mmin(mn, left * (mid == prv[..., None]).to(F))
        slope = torch.where(prv > -BIG, -_div(b - b_prev, off - prv), 0.0).clamp(0.0, CLIP)
        return None, None, None, None, _inside(up * slope, off, lo, hi)


class HardMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t):
        ctx.save_for_backward(x)
        ctx.t = t
        return x.amin(-1)

    @staticmethod
    def backward(ctx, up):
        (x,) = ctx.saved_tensors
        z = -ctx.t * x
        return up[..., None] * torch.softmax(z - z.amax(-1, keepdim=True), -1), None


def _verts(prims):
    """(..., N, 9) x1 x2 x3 | y1 y2 y3 | z1 z2 z3 -> (..., N, 3 verts, 3 xyz)."""
    return torch.stack([prims[..., 0:3], prims[..., 3:6], prims[..., 6:9]], -1)


def _areas(prims):
    v = _verts(prims)
    c = torch.linalg.cross(v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :])
    return 0.5 * torch.linalg.vector_norm(c, dim=-1)


def _overlap_masks(prims, nb, m, pm):
    v = _verts(prims)
    pt_in = ((v >= nb[..., None, None, 0:3]) & (v <= nb[..., None, None, 3:6])).all(-1)
    outside = 1.0 - m
    isect = pt_in.any(-1).to(F) * outside
    sib = isect * (pm * outside)
    return isect, sib, isect - sib, pt_in


class Overlap(torch.autograd.Function):
    """EPO weight: half the area of the prims that reach into the node
    without belonging to it, over the cloud's area."""

    @staticmethod
    def forward(ctx, prims, nb, m, pm, nmin, nmax, axis, is_left):
        isect = _overlap_masks(prims, nb, m, pm)[0]
        a = _areas(prims)
        ctx.save_for_backward(prims, nb, m, pm, nmin, nmax)
        ctx.axis, ctx.is_left = axis, is_left
        return 0.5 * (a * isect).sum(-1) / torch.clamp(a.sum(-1), min=1e-12)

    @staticmethod
    def backward(ctx, up):
        prims, nb, m, pm, nmin, nmax = ctx.saved_tensors
        isect, sib, out, pt_in = _overlap_masks(prims, nb, m, pm)
        ap = prims[..., 3 * ctx.axis:3 * ctx.axis + 3]
        a = _areas(prims)
        if ctx.is_left:
            ref = torch.where(sib > 0, ap.amin(-1),
                              torch.where(out > 0, torch.amin(torch.where(pt_in, ap, BIG), -1),
                                          -BIG))
            ev = _mmax(ref, isect)
            num = (a * isect * (ref == ev[..., None]).to(F)).sum(-1) * 0.5
            den = nmax - ev
        else:
            ref = torch.where(sib > 0, ap.amax(-1),
                              torch.where(out > 0, torch.amax(torch.where(pt_in, ap, -BIG), -1),
                                          BIG))
            ev = _mmin(ref, isect)
            num = -(a * isect * (ref == ev[..., None]).to(F)).sum(-1) * 0.5
            den = ev - nmin
        slope = torch.where(den.abs() > 1e-12, _div(num, den), 0.0) / torch.clamp(a.sum(-1),
                                                                               min=1e-12)
        g = up * slope.clamp(0.0, CLIP)
        z = torch.zeros_like(g)
        return (None, None, None, None, z if ctx.is_left else g, g if ctx.is_left else z,
                None, None)


def encode(w: dict, cloud, mask, gamma):
    """One level's encoder on the (B, 1, N, 9) cloud under node masks (B, K,
    N) -> local thetas (B, K, 3) and the (scale, translate) extents."""
    v = torch.stack([cloud[..., 0:3], cloud[..., 3:6], cloud[..., 6:9]], -2)  # axis, vert
    mm = mask[..., None, None]
    lo = torch.amin(torch.where(mm > 0, v, BIG), (-3, -1))
    hi = torch.amax(torch.where(mm > 0, v, -BIG), (-3, -1))
    lo = torch.minimum(lo, hi)
    ext = hi - lo
    inv = torch.where(ext > 0, 1.0 / torch.where(ext == 0, 1.0, ext), 0.0)
    feat = ((v - lo[..., None, :, None]) * inv[..., None, :, None] * gamma + 1.0) * mm
    h = torch.relu(feat @ w["vert"])
    for k in ("w1", "w2", "w3"):
        h = torch.relu(h @ w[k])
    n = torch.clamp(mask.sum(-1), min=1.0)
    C = h.shape[-1]
    pooled = (mask[..., None, :] @ h.flatten(-2)).squeeze(-2).unflatten(-1, (3, C))
    g = torch.relu((pooled / n[..., None, None]) @ w["r1"])
    g = torch.relu(g @ w["r2"])
    return (g @ w["r3"])[..., 0], lo, hi


def _sa(b):
    d = b[..., 3:6] - b[..., 0:3]
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def loss(weights: list, cfg: dict, clouds) -> torch.Tensor:
    """The training loss of `clouds` (B, N, 9) under per-level weight dicts."""
    B, N = clouds.shape[:2]
    L = cfg["levels"]
    v = _verts(clouds)
    bounds = torch.cat([v.amin((-3, -2)), v.amax((-3, -2))], -1)[:, None]
    mask = torch.ones(B, 1, N, dtype=F, device=clouds.device)
    cb = clouds.detach()[:, None]
    mids = [0.5 * (cb[..., 3 * a:3 * a + 3].amin(-1) + cb[..., 3 * a:3 * a + 3].amax(-1))
            for a in range(3)]
    lev_b, lev_m, lev_th = [], [], []
    for l in range(L - 1):
        lth, lo, hi = encode(weights[l], cb, mask, cfg["layer_gamma"])
        with torch.no_grad():
            bl, bh = bounds[..., 0:3], bounds[..., 3:6]
            ie = torch.where(bh - bl > 0, 1.0 / torch.where(bh - bl == 0, 1.0, bh - bl), 0.0)
            scale, shift = (hi - lo) * ie, (lo - bl) * ie
        th = lth * scale + shift
        bmin, bmax = bounds[..., 0:3], bounds[..., 3:6]
        off = bmin + th * (bmax - bmin)
        kids, kid_m = [], []
        for a in range(3):
            ap = cb[..., 3 * a:3 * a + 3]
            b0, b1 = bmin[..., a], bmax[..., a]
            lb = _clip(LeftBound.apply(ap, mask, b0, b1, off[..., a]), b0, b1)
            rb = _clip(RightBound.apply(ap, mask, b0, b1, off[..., a]), b0, b1)
            hi_l = torch.stack([lb if i == a else bmax[..., i] for i in range(3)], -1)
            lo_r = torch.stack([rb if i == a else bmin[..., i] for i in range(3)], -1)
            kids += [torch.cat([bmin, hi_l], -1), torch.cat([lo_r, bmax], -1)]
            side = off[..., a, None] >= mids[a]
            kid_m += [(mask * side.to(F)).detach(), (mask * (~side).to(F)).detach()]
        lev_b.append(bounds)
        lev_m.append(mask)
        lev_th.append(lth)
        K = bounds.shape[1]
        bounds = torch.stack(kids, 2).reshape(B, 6 * K, 6)
        mask = torch.stack(kid_m, 2).reshape(B, 6 * K, N)
    lev_b.append(bounds)
    lev_m.append(mask)

    root_sa = torch.clamp(_sa(lev_b[0][:, 0]), min=1e-12)[:, None]
    al = cfg["alpha"]

    def node_cost(l):
        b, K = lev_b[l], lev_b[l].shape[1]
        c_sah = cfg["i_isect"] * _sa(b) / root_sa
        if l == 0:
            return (1 - al) * c_sah
        ws = []
        for c in range(6):
            a, right = c // 2, c % 2 == 1
            nb = b[:, c::6]
            ws.append(Overlap.apply(clouds[:, None], nb, lev_m[l][:, c::6], lev_m[l - 1],
                                    nb[..., a], nb[..., 3 + a], a, not right))
        return (1 - al) * c_sah + al * cfg["i_isect"] * torch.stack(ws, -1).reshape(B, K)

    p = L - 2
    K = lev_b[p].shape[1]
    cb6 = lev_b[p + 1].reshape(B, K, 6, 6)
    cm6 = lev_m[p + 1].reshape(B, K, 6, N)
    child = []
    for c in range(6):
        a, right = c // 2, c % 2 == 1
        nb = cb6[:, :, c]
        w = Overlap.apply(clouds[:, None], nb, cm6[:, :, c], lev_m[p], nb[..., a],
                          nb[..., 3 + a], a, not right)
        child.append((1 - al) * _sa(nb) / root_sa + al * cfg["t_isect"] * w)
    child = torch.stack(child, -1)
    cost = node_cost(p)[..., None] + child[..., 0::2] + child[..., 1::2]
    pooled = HardMin.apply(cost, cfg["t_soft"])
    for l in range(p - 1, -1, -1):
        K = lev_b[l].shape[1]
        kp = pooled.reshape(B, K, 6)
        pooled = HardMin.apply(node_cost(l)[..., None] + kp[..., 0::2] + kp[..., 1::2],
                               cfg["t_soft"])
    root = pooled[:, 0] / (cfg["pc_size"] * cfg["i_isect"])

    pen = torch.zeros((), dtype=F, device=clouds.device)
    for l in range(L - 1):
        t = lev_th[l]
        hub = lambda d: torch.where(d.abs() <= 0.1, 0.5 * d * d, 0.1 * (d.abs() - 0.05))
        e = (t < 0) * hub(t) + (t > 1) * hub(t - 1.0)
        pen = pen + cfg["penalty_slope"] * (2.0 ** (L - 1 - l + 1) - 1.0) * e.sum(-1).mean(0).sum()
    return (root ** 2).mean() + pen


def train(weights: list, cfg: dict, batches: list, tf32: bool = False) -> dict:
    """Adam steps (lr, betas 0.9 / 0.999, eps 1e-8) from `weights` (a list
    of per-level dicts of leaf tensors, left unchanged) on each of
    `batches` -> {"loss": [per step], "grad": {name: first step's
    gradient}, "delta": {name: change after the last step}}; names are
    "<level>.<weight>". `tf32` computes the products in TF32 (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = [{k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
                  for w in weights]
        flat = [(f"{l}.{k}", p) for l, w in enumerate(params) for k, p in w.items()]
        m = {n: torch.zeros_like(p) for n, p in flat}
        v = {n: torch.zeros_like(p) for n, p in flat}
        out = {"loss": [], "grad": {}, "delta": {}}
        lr, b1, b2, eps = cfg["learning_rate"], 0.9, 0.999, 1e-8
        for t, clouds in enumerate(batches, 1):
            lo = loss(params, cfg, clouds)
            grads = torch.autograd.grad(lo, [p for _, p in flat], allow_unused=True)
            out["loss"].append(float(lo.detach()))
            with torch.no_grad():
                for (n, p), g in zip(flat, grads):
                    g = torch.zeros_like(p) if g is None else g
                    if t == 1:
                        out["grad"][n] = g.clone()
                    m[n] = b1 * m[n] + (1 - b1) * g
                    v[n] = b2 * v[n] + (1 - b2) * g * g
                    mh = m[n] / (1 - b1 ** t)
                    vh = v[n] / (1 - b2 ** t)
                    p -= lr * mh / (torch.sqrt(vh) + eps)
        for l, w in enumerate(weights):
            for k, p0 in w.items():
                out["delta"][f"{l}.{k}"] = (params[l][k] - p0).detach()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
