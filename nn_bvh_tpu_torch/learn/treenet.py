"""treeNet: the neural spatial-split model (port of
nn_bvh_tpu/learn/treenet.py).

- Every level of the static 6-wide node tree is one tensor with a K = 6^l
  node axis; a whole level's encoder runs as one batched product.
- torch.utils.checkpoint around the encoder (the JAX package's
  jax.checkpoint) recomputes its activations in the backward pass instead
  of holding them.
- Pooling (the agglomerative soft-min cost) runs per level.

Cost model: per node C = (1-alpha) * C_SAH + alpha * C_EPO, with C_SAH =
SA(node)/SA(root) and C_EPO = w_epo; a treelet's cost is the soft_min over
its 3 axis splits; the root's pooled cost, normalised by
1/(pc_size * i_isect), is driven to zero by the MSE loss plus the
out-of-bounds theta huber penalty with a 2^depth slope.

The functions take the model (a TreeNet) where the JAX package takes its
params tuple; `params_from_jax` and `params_to_numpy` carry weights between
the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import devices
from . import common, encoder as enc_mod, splitter


class TreeNetConfig(NamedTuple):
    levels: int = 4          # lvls (nss_global_config.py:15)
    capacity: int = 128      # dense units (:20)
    pc_size: int = 2048      # cloud size (:14)
    epo: bool = True         # fork EPO path vs nss SAH path
    alpha: float = 0.71      # EPO_SAH_alpha (:19)
    i_isect: float = 1.0     # C_tri (:23)
    t_isect: float = 1.2     # C_inn (:25)
    t_soft: float = 1.0      # soft-min temperature (:27)
    layer_gamma: float = 4.0
    learning_rate: float = 1e-5
    penalty_slope: float = 1.0

    @property
    def norm_factor(self) -> float:
        return 1.0 / (self.pc_size * self.i_isect)


class TreeNet(nn.Module):
    """levels-1 encoders, one per interior level."""

    def __init__(self, cfg: TreeNetConfig, encoders):
        super().__init__()
        self.cfg = cfg
        self.encoders = nn.ModuleList(encoders)


def init_params(cfg: TreeNetConfig, seed: int = 0, device=None) -> TreeNet:
    """A TreeNet with random weights drawn from a CPU torch.Generator seeded
    with `seed` (the same weights on every device), on `device`."""
    dev = devices.resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    return TreeNet(cfg, [enc_mod.init_encoder(cfg.capacity, cfg.epo, generator).to(dev)
                         for _ in range(cfg.levels - 1)])


def params_from_jax(params_np, cfg: TreeNetConfig, device=None) -> TreeNet:
    """The JAX package's tuple of EncoderParams as numpy arrays
    (jax.tree.map(np.asarray, params)) -> the port's TreeNet."""
    dev = devices.resolve_device(device)
    if len(params_np) != cfg.levels - 1:
        raise ValueError(f"{len(params_np)} encoders for {cfg.levels} levels")
    encs = []
    for p in params_np:
        fields = dict(zip(enc_mod.FIELDS, p))
        encs.append(enc_mod.Encoder({
            k: None if v is None else torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in fields.items()}))
    return TreeNet(cfg, encs)


def params_to_numpy(model: TreeNet) -> tuple:
    """The inverse of params_from_jax: a tuple of encoder.EncoderParams of
    numpy arrays (jax.tree.map(jnp.asarray, ...) of JAX EncoderParams built
    from them gives the JAX package's params)."""
    return tuple(enc_mod.EncoderParams(*(
        None if getattr(e, k) is None else getattr(e, k).detach().cpu().numpy()
        for k in enc_mod.FIELDS)) for e in model.encoders)


class LevelState(NamedTuple):
    bounds: torch.Tensor        # (B, K, 6)
    mask: torch.Tensor          # (B, K, N)
    parent_offset: torch.Tensor  # (B, K) split offset of the parent plane (root: dummy)
    lthetas: torch.Tensor | None  # (B, K, 3) local thetas (None at the leaf level)
    offsets: torch.Tensor | None  # (B, K, 3) per-axis split offsets of THIS node


def forward_tree(model: TreeNet, cfg: TreeNetConfig, clouds: torch.Tensor) -> list[LevelState]:
    """Build the full 6-wide tree. clouds: (B, N, 3) points or (B, N, 9)
    prims. The encoders' activations are recomputed in the backward pass.

    Returns one LevelState per level (index 0 = root, levels-1 = leaves).
    """
    B, N = clouds.shape[0], clouds.shape[1]
    f32 = dict(dtype=torch.float32, device=clouds.device)
    bounds = common.cloud_bounds(clouds)[:, None, :]  # (B, 1, 6)
    mask = torch.ones((B, 1, N), **f32)
    parent_offset = torch.ones((B, 1), **f32)
    cloud_b = clouds.detach()[:, None]  # (B, 1, N, F), broadcast over K
    levels: list[LevelState] = []

    for l in range(cfg.levels - 1):
        K = 6 ** l
        lth, scale, transl = checkpoint(enc_mod.apply_encoder, model.encoders[l], cloud_b,
                                        bounds, mask, cfg.layer_gamma, use_reentrant=False)
        thetas = lth * scale + transl  # (B, K, 3)

        if cfg.epo:
            offsets, _, _, child_bounds = splitter.gen_nodes_epo(clouds[:, None], bounds,
                                                                 thetas, mask)
        else:
            offsets, child_bounds = splitter.gen_nodes(bounds, thetas)
        levels.append(LevelState(bounds, mask, parent_offset, lth, offsets))

        # children: (B, K, 6, 6) -> (B, 6K, 6), child c of node k at 6k + c
        child_masks, child_par_off = [], []
        for c in range(6):
            a, right = c // 2, c % 2 == 1
            off_a = offsets[..., a]  # (B, K)
            if cfg.epo:
                cm = common.build_mask_epo(clouds[:, None], off_a[..., None], a, mask, right)
            else:
                cm = common.build_mask_points(clouds[:, None], child_bounds[:, :, c])
            child_masks.append(cm)
            child_par_off.append(off_a)
        bounds = child_bounds.reshape(B, 6 * K, 6)
        mask = torch.stack(child_masks, 2).reshape(B, 6 * K, N)
        parent_offset = torch.stack(child_par_off, 2).reshape(B, 6 * K)

    levels.append(LevelState(bounds, mask, parent_offset, None, None))
    return levels


def _sa_ratio(bounds, root_bounds):
    sa = common.surface_area_bounds(bounds)
    sa_root = torch.clamp(common.surface_area_bounds(root_bounds), min=1e-12)
    return sa / sa_root.reshape(sa_root.shape + (1,) * (sa.ndim - sa_root.ndim))


def _node_cost_epo(cfg, clouds, level: LevelState, parent: LevelState | None, root_bounds):
    """Blended (1-a) SAH + a EPO cost of each node as a child of its parent.
    Node k is child c = k % 6 of its parent: the six children's w_epo are
    computed apart (axis and side are static per child) and interleaved
    back to 6j + c (the JAX package's c_epo.at[:, sel].set)."""
    B, K, _ = level.bounds.shape
    c_sah = cfg.i_isect * _sa_ratio(level.bounds, root_bounds)
    if parent is None or K == 1:
        return (1 - cfg.alpha) * c_sah  # root: no external-overlap term
    parent_mask = parent.mask  # (B, K/6, N): the parent of node 6j + c is j
    ws = []
    for c in range(6):
        a, right = c // 2, c % 2 == 1
        nb = level.bounds[:, c::6]
        ws.append(splitter.w_epo(clouds[:, None], nb, level.mask[:, c::6], parent_mask,
                                 nb[..., a], nb[..., 3 + a], a, not right))
    c_epo = cfg.i_isect * torch.stack(ws, -1).reshape(B, K)
    return (1 - cfg.alpha) * c_sah + cfg.alpha * c_epo


def _child_costs_epo(cfg, clouds, level: LevelState, child_bounds6, child_masks6, root_bounds):
    """(B, K, 6) blended costs of the 6 candidate children of each node."""
    costs = []
    for c in range(6):
        a, right = c // 2, c % 2 == 1
        nb = child_bounds6[:, :, c]
        w = splitter.w_epo(clouds[:, None], nb, child_masks6[:, :, c], level.mask,
                           nb[..., a], nb[..., 3 + a], a, not right)
        costs.append((1 - cfg.alpha) * _sa_ratio(nb, root_bounds) + cfg.alpha * cfg.t_isect * w)
    return torch.stack(costs, -1)


def _node_cost_sah(cfg, level: LevelState, root_bounds):
    """SAH/point variant Cnode = t_isect * SA ratio."""
    return cfg.t_isect * _sa_ratio(level.bounds, root_bounds)


def pooled_cost(model: TreeNet, cfg: TreeNetConfig, clouds, levels=None):
    """Soft-pooled tree cost (training forward) -> (cost (B,), aux dict)."""
    if levels is None:
        levels = forward_tree(model, cfg, clouds)
    root_bounds = levels[0].bounds[:, 0]
    B = clouds.shape[0]

    # --- leaf-parent level: evaluate candidate children directly ----------
    p = cfg.levels - 2
    lev = levels[p]
    K = 6 ** p
    child_bounds6 = levels[p + 1].bounds.reshape(B, K, 6, 6)
    child_masks6 = levels[p + 1].mask.reshape(B, K, 6, -1)
    if cfg.epo:
        cnode = _node_cost_epo(cfg, clouds, lev, levels[p - 1] if p > 0 else None, root_bounds)
        cchild = _child_costs_epo(cfg, clouds, lev, child_bounds6, child_masks6, root_bounds)
    else:
        cnode = _node_cost_sah(cfg, lev, root_bounds)
        n_tot = lev.mask.sum(-1).detach()
        costs = []
        for c in range(6):  # q * SA ratio per child
            a, right = c // 2, c % 2 == 1
            n_left = splitter.ql_points(clouds[:, None, :, a], lev.mask, lev.bounds[..., a],
                                        lev.bounds[..., 3 + a], lev.offsets[..., a])
            q = (n_tot - n_left) if right else n_left
            costs.append(cfg.i_isect * q * _sa_ratio(child_bounds6[:, :, c], root_bounds))
        cchild = torch.stack(costs, -1)

    cost_axes = cnode[..., None] + cchild[..., 0::2] + cchild[..., 1::2]  # (B, K, 3)
    pooled = splitter.soft_min(cost_axes, cfg.t_soft)
    per_level_cost_axes = {p: cost_axes}

    # --- interior levels bottom-up ---------------------------------------
    for l in range(p - 1, -1, -1):
        lev = levels[l]
        K = 6 ** l
        if cfg.epo:
            cnode = _node_cost_epo(cfg, clouds, lev, levels[l - 1] if l > 0 else None,
                                   root_bounds)
        else:
            cnode = _node_cost_sah(cfg, lev, root_bounds)
        child_pool = pooled.reshape(B, K, 6)
        cost_axes = cnode[..., None] + child_pool[..., 0::2] + child_pool[..., 1::2]
        pooled = splitter.soft_min(cost_axes, cfg.t_soft)
        per_level_cost_axes[l] = cost_axes

    return pooled[:, 0] * cfg.norm_factor, {"cost_axes": per_level_cost_axes, "levels": levels}


def _huber(d, delta: float = 0.1):
    a = d.abs()
    return torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))


def penalty_loss(cfg: TreeNetConfig, levels) -> torch.Tensor:
    """Out-of-bounds theta huber penalty with a 2^depth slope."""
    max_inter = cfg.levels - 1
    total = torch.zeros((), dtype=torch.float32, device=levels[0].bounds.device)
    for l in range(max_inter):
        lth = levels[l].lthetas  # (B, K, 3)
        pen = (lth < 0) * _huber(lth) + (lth > 1) * _huber(lth - 1.0)
        slope = cfg.penalty_slope * (2.0 ** (max_inter - l + 1) - 1.0)  # sumPowerSeries(2, n)
        total = total + slope * pen.sum(-1).mean(0).sum()
    return total


def loss_fn(model: TreeNet, cfg: TreeNetConfig, clouds):
    """Training loss: MSE(pooled cost, 0) + penalty -> (loss, metrics)."""
    cost, aux = pooled_cost(model, cfg, clouds)
    tree_loss = (cost ** 2).mean()
    pen = penalty_loss(cfg, aux["levels"])
    out_of_bounds = sum(((lev.lthetas < 0) | (lev.lthetas > 1)).sum()
                        for lev in aux["levels"][:cfg.levels - 1])
    metrics = {"tree_loss": tree_loss, "pen_loss": pen, "mae": cost.mean(),
               "out_of_bounds_splits": out_of_bounds}
    return tree_loss + pen, metrics


@torch.no_grad()
def predict_tree(model: TreeNet, cfg: TreeNetConfig, clouds):
    """Hard (argmin) plane extraction -> (cost (B,), planes (B, 2^(levels-1)
    - 1, 4) as level-order [nx, ny, nz, offset])."""
    cost, aux = pooled_cost(model, cfg, clouds)
    levels, cost_axes = aux["levels"], aux["cost_axes"]
    B = clouds.shape[0]
    planes = []
    sel = torch.zeros((B, 1), dtype=torch.int64, device=clouds.device)
    for l in range(cfg.levels - 1):
        idx3 = sel[..., None].expand(-1, -1, 3)
        ca_sel = torch.gather(cost_axes[l], 1, idx3)  # (B, S, 3)
        axis = torch.argmin(ca_sel, -1)  # (B, S), the first minimum as jnp.argmin
        off_sel = torch.gather(levels[l].offsets, 1, idx3)
        off = torch.gather(off_sel, -1, axis[..., None])[..., 0]
        normal = torch.nn.functional.one_hot(axis, 3).to(torch.float32)
        planes.append(torch.cat([normal, off[..., None]], -1))
        left = 6 * sel + 2 * axis  # descend: children 6k + 2 axis + {0, 1}
        sel = torch.stack([left, left + 1], -1).reshape(B, -1)
    return cost, torch.cat(planes, 1)
