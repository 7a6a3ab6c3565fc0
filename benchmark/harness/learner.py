"""What the learner's cells make on the card from the seed: the treeNet
weights and the training clouds.

Clouds follow the learner's data rule over the bench geometry
(geometry.cloud_rule): each batch element moves a random quarter to three
quarters of the movable meshes, each along a random axis by a uniform
shift inside the scene's bounds.
"""

from __future__ import annotations

import math


def make_clouds(torch, rule: dict, n: int, gen, dev):
    """(n, pc_size, 9) clouds on `dev` by the cloud rule, drawn from `gen`."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    static, picked, lo, hi = t(rule["static"]), t(rule["picked"]), t(rule["lo"]), t(rule["hi"])
    mesh_lo, mesh_hi = t(rule["mesh_lo"]), t(rule["mesh_hi"])
    mesh_of = torch.as_tensor(rule["mesh_of"], device=dev)
    M = mesh_lo.shape[0]
    k = torch.randint(max(M // 4, 1), max(3 * M // 4, 1) + 1, (n, 1), generator=gen, device=dev)
    order = torch.argsort(torch.rand(n, M, generator=gen, device=dev), -1)
    moved = torch.zeros(n, M, dtype=torch.bool, device=dev)
    moved.scatter_(1, order, torch.arange(M, device=dev).expand(n, M) < k)
    axis = torch.randint(0, 3, (n, M), generator=gen, device=dev)
    lo_a, hi_a = lo[axis], hi[axis]
    m_lo = torch.gather(mesh_lo.expand(n, M, 3), 2, axis[..., None])[..., 0]
    m_hi = torch.gather(mesh_hi.expand(n, M, 3), 2, axis[..., None])[..., 0]
    u = torch.rand(n, M, generator=gen, device=dev)
    shift = torch.where(moved, (lo_a - m_lo) + u * ((hi_a - m_hi) - (lo_a - m_lo)), 0.0)
    delta = torch.zeros(n, M, 3, device=dev)
    delta.scatter_(2, axis[..., None], shift[..., None])
    # prim layout x1 x2 x3 | y1 y2 y3 | z1 z2 z3: each axis' shift on its 3 slots
    mov = picked + delta[:, mesh_of].repeat_interleave(3, -1)
    return torch.cat([static.expand(n, -1, -1), mov], 1)


def make_weights(torch, cfg: dict, gen, dev) -> list:
    """Per interior level a dict of the encoder's weights, drawn in one
    call on the card."""
    C = cfg["capacity"]
    shapes = {"vert": (3, C), "w1": (C, C), "w2": (C, C), "w3": (C, C), "r1": (C, C),
              "r2": (C, C // 2), "r3": (C // 2, 1)}
    per = sum(math.prod(s) for s in shapes.values())
    u = 2.0 * torch.rand(cfg["levels"] - 1, per, generator=gen, device=dev) - 1.0
    out = []
    for row in u:
        w, at = {}, 0
        for name, s in shapes.items():
            n = math.prod(s)
            fan = s[0] + s[1] if name == "r3" else s[0]
            w[name] = (row[at:at + n].reshape(s) * math.sqrt(6.0 / fan)).contiguous()
            at += n
        out.append(w)
    return out


def tree_config(treenet, cfg: dict):
    """The program's TreeNetConfig of a learner configuration file."""
    return treenet.TreeNetConfig(
        levels=cfg["levels"], capacity=cfg["capacity"], pc_size=cfg["pc_size"], epo=cfg["epo"],
        alpha=cfg["alpha"], i_isect=cfg["i_isect"], t_isect=cfg["t_isect"],
        t_soft=cfg["t_soft"], layer_gamma=cfg["layer_gamma"],
        learning_rate=cfg["learning_rate"], penalty_slope=cfg["penalty_slope"])


def run_window(step, state, first: int, seconds: float, sync):
    """Steps step(state, i) for i = first, first + 1, ... until `seconds`
    have run out, each closed by a synchronize (as the learner's data
    feed, a host-to-device copy a step, closes it) -> (state, steps,
    window seconds)."""
    import time

    t_start = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t_start < seconds:
        state = step(state, first + n)
        sync()
        n += 1
    return state, n, time.perf_counter() - t_start


def traced_steps(torch, tr, step, state, n: int) -> tuple:
    """n steps under the profiler -> (state, the trace's summary)."""
    p = tr.start()
    for i in range(n):
        state = step(state, i)
    torch.cuda.synchronize()
    return state, tr.summary(tr.stop(p))
