"""Traversal kernel lab on the CUDA card (port of tools/perf/kernel_lab.py).

    python -m nn_bvh_tpu_torch.tools.kernel_lab [--quick]

Three packet kernels (csrc/kernel_lab.cu), each with its plain torch twin in
this module, and the lab's harness. What they compute is the JAX lab's, on
the port's tables (node records of `accel.binary.pack_binary_cuda`,
triangles (N, 3, 3)):

- `lab_traverse`: binary BVH packet traversal, a packet being `rows*128`
  lanes with one 64-entry stack; a node is visited when any lane's box test
  hits it; the near child comes from the sign of the packet's summed
  direction on the split axis; `k_pop` entries popped per iteration (an
  empty slot visits the root, and counts); leaf tests compiled out with
  `leaf_mode="none"`; `cnt` (visits) and `cnt2` (leaf visits that some lane
  hit) per packet, written to every lane when `count`.
- `brless_traverse`: the branchless variant: leaf tests every iteration at
  clamped indices, masked; unconditional pushes. Its counters are zero, as
  the reference never writes them.
- `floor_bench`: a loop-floor probe on one packet: `n_iter` dependent stack
  reads, node loads and toy slab votes.

Returns are the JAX functions', padded the same way (o = 0, d = 1,
t_max = -1 on padding lanes, which vote like any other): `t, prim, cnt, cnt2`
each (Rp/128, 128); `floor_bench` (rows, 128). A miss keeps t = t_max and
prim = -1. Each wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; each launch adds one to
`accel.kernel_launch.n_launches` under the kernel's name.

The harness (`main`) runs what the JAX `main` runs, in its order, on the
bench scene: the status-quo kernel per ray class without and with counters,
the three floor variants at n_iter = 20,000 (ns/iter), the two branchless
variants per class. `--quick` keeps the bounce class. Times are CUDA events,
the median of 5 calls after a warm-up. It needs a card and exits 1 without
one; the last line of standard output is one JSON object with every number,
the card's name and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..accel import dispatch, kernel_launch
from ..accel.traverse import _slab, safe_inv, tri_isect
from ..devices import resolve_device
from ..geometry.scene import host
from ..wavefront import camera as camera_mod
from .bench_scene import build_bench_scene, median_ms

SOURCE = "kernel_lab"
LANES = 128
STACK_DEPTH = 64
MAX_LEAF = 8
MAX_THREADS = 1024
ROWS = (1, 2, 4, 8, 16, 32)
MAX_POP = 4
FLOOR_WRAP = 17000
# floor_bench's address ((node % 17000) // 128) * 128 + node % 128 reaches
# record 17,023: the 133 blocks of 128 records that 17,000 wrapped indices span
FLOOR_MIN_NODES = -(-FLOOR_WRAP // LANES) * LANES
FLOOR_SLOTS = 32

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "lab_traverse": [_VP] * 5 + [_INT] * 6 + [_VP] * 6,
    "brless_traverse": [_VP] * 5 + [_INT] * 4 + [_VP] * 6,
    "floor_bench": [_VP, _VP] + [_INT] * 4 + [_VP, _VP],
}


class StackOverflow(ValueError):
    """A packet walk needed more than the 64 entries of its stack."""


@functools.cache
def _entry(name: str):
    fn = getattr(kernels.load(SOURCE), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def block_threads(rows: int) -> int:
    """Threads of a packet's block: min(rows*128, 1024)."""
    return min(rows * LANES, MAX_THREADS)


def _check_args(rows: int, k_pop: int = 1, leaf_mode: str = "extract8"):
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows}")
    if not 1 <= k_pop <= MAX_POP:
        raise ValueError(f"k_pop must be in 1..{MAX_POP}, got {k_pop}")
    if leaf_mode not in ("extract8", "none"):
        raise ValueError(f"leaf_mode must be 'extract8' or 'none', got {leaf_mode!r}")


def _pad(o, d, t_max, rows):
    """The reference's padding to whole packets: o = 0, d = 1, t_max = -1."""
    pad = (-o.shape[0]) % (rows * LANES)
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_full((pad,), -1.0)])
    return o.contiguous(), d.contiguous(), t_max.contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def packet_neg(d: torch.Tensor, rows: int) -> torch.Tensor:
    """d (P, L, 3) -> (P, 3) bool: the sign of each packet's summed
    direction, summed in the kernel's order (each thread's lanes in lane
    order, then a halving tree over the threads)."""
    B = block_threads(rows)
    s = d[:, :B]
    for k in range(1, d.shape[1] // B):
        s = s + d[:, k * B:(k + 1) * B]
    h = B // 2
    while h:
        s = s[:, :h] + s[:, h:2 * h]
        h //= 2
    return s[:, 0] < 0.0


class _Packets:
    """Per-packet state of a plain walk: rays (P, L), the stacks, sp, and
    per packet the visits, the leaf visits some lane hit, and the triangle
    tests masked in (per lane). Every step runs on all P packets, masked
    by the packets whose walk is on, so a step makes few host syncs."""

    def __init__(self, o, d, t_max, rows):
        o, d, t_max = _pad(o, d, t_max, rows)
        L = rows * LANES
        P = o.shape[0] // L
        dev = o.device
        self.o, self.d = o.reshape(P, L, 3), d.reshape(P, L, 3)
        self.inv = safe_inv(self.d)
        self.t = t_max.reshape(P, L).clone()
        self.prim = torch.full((P, L), -1, dtype=torch.int32, device=dev)
        self.neg = packet_neg(self.d, rows)
        self.stack = torch.zeros((P, STACK_DEPTH), dtype=torch.int64, device=dev)
        self.sp = torch.where((self.t > 0.0).any(1), 0, -1)
        self.pk = torch.arange(P, device=dev)
        self.visits, self.leafs, self.tri = (torch.zeros(P, dtype=torch.int64, device=dev)
                                             for _ in range(3))
        self.overflow = torch.zeros(P, dtype=torch.bool, device=dev)

    def node(self, nodes, node, act):
        """Visit node[p] for each packet p with act[p] -> (box hit by any
        lane, offset, leaf count, near child, far child)."""
        rec = nodes[node]
        meta = rec[:, 6:8].contiguous().view(torch.int32).long()
        off, cnt_leaf, axis = meta[:, 0], meta[:, 1] % 32, meta[:, 1] // 32
        ok, _ = _slab(rec[:, None, 0:3], rec[:, None, 3:6], self.o, self.inv, self.t)
        ng = self.neg.gather(1, axis.clamp(max=2)[:, None])[:, 0]
        near = torch.where(ng, off, node + 1)
        far = torch.where(ng, node + 1, off)
        hit_any = ok.any(1)
        self.visits += act.long()
        self.leafs += (act & hit_any & (cnt_leaf > 0)).long()
        return hit_any, off, cnt_leaf, near, far

    def leaf(self, tris, off, cnt_leaf, mask):
        """The 8 triangle tests of every packet at the reference's clamped
        index (j < cnt_leaf and `mask` per packet keep a hit); the first
        smallest t wins, as the kernel's tests in order do. Skipped (one
        host sync) when no packet keeps a test: most visits are interior."""
        if not bool(mask.any()):
            return
        jj = torch.arange(MAX_LEAF, device=off.device)
        tj = off[:, None] + torch.minimum(jj[None, :], cnt_leaf[:, None] - 1)
        tj = tj.clamp(0, tris.shape[0] - 1)
        h, t, _, _ = tri_isect(self.o[:, :, None, :], self.d[:, :, None, :],
                               tris[tj][:, None], self.t[..., None])
        h = h & ((jj[None, :] < cnt_leaf[:, None]) & mask[:, None])[:, None, :]
        tm = torch.where(h, t, torch.inf)
        k = torch.argmin(tm, dim=2)
        got = h.any(2)
        self.t = torch.where(got, tm.gather(2, k[..., None])[..., 0], self.t)
        self.prim = torch.where(got, torch.gather(tj, 1, k).to(torch.int32), self.prim)
        self.tri += torch.where(mask, cnt_leaf.clamp(max=MAX_LEAF), 0)

    def push(self, sp, slot, value, mask):
        """stack[p, sp[p] + slot] = value[p] where mask[p]."""
        idx = (sp + slot).clamp(0, STACK_DEPTH - 1)
        self.stack[self.pk, idx] = torch.where(mask, value, self.stack[self.pk, idx])

    def outputs(self, name, count, counts):
        """-> t, prim, cnt, cnt2 (Rp/128, 128); `counts` (a dict or None)
        receives the lane slab tests ("slab") and lane triangle tests
        masked in ("tri") of each packet."""
        if bool(self.overflow.any()):
            raise StackOverflow(f"{name} overflowed its {STACK_DEPTH}-entry packet stack "
                                "on this tree")
        P, L = self.t.shape
        if counts is not None:
            counts["slab"], counts["tri"] = self.visits * L, self.tri * L
        shape = (P * L // LANES, LANES)
        per_lane = lambda c: (c if count else torch.zeros_like(c))[:, None].expand(P, L)
        return (self.t.reshape(shape), self.prim.reshape(shape),
                per_lane(self.visits).to(torch.int32).reshape(shape),
                per_lane(self.leafs).to(torch.int32).reshape(shape))


def lab_traverse_plain(nodes, tris, o, d, t_max, rows=32, k_pop=1, leaf_mode="extract8",
                       count=False, vec=False, counts=None):
    """The plain version of `lab_traverse`, all packets at once. `vec`
    changes how the kernel moves a node record, not what it computes."""
    _check_args(rows, k_pop, leaf_mode)
    s = _Packets(o, d, t_max, rows)
    while bool((s.sp >= 0).any()):
        act = s.sp >= 0
        sp = s.sp
        popped = [torch.where(act & (sp - k >= 0), s.stack[s.pk, (sp - k).clamp(min=0)], -1)
                  for k in range(k_pop)]
        sp = torch.where(act, sp - torch.clamp(sp + 1, max=k_pop), sp)
        pushes = []
        for n in popped:  # in order: each visit sees the t left by the one before
            hit_any, off, cnt_leaf, near, far = s.node(nodes, n.clamp(min=0), act)
            if leaf_mode == "extract8":
                s.leaf(tris, off, cnt_leaf, act & hit_any & (cnt_leaf > 0))
            pushes.append((act & hit_any & (cnt_leaf == 0) & (n >= 0), near, far))
        over = torch.zeros_like(act)
        for desc, near, far in pushes:  # an overflowing packet stops pushing
            over = over | (desc & (sp + 2 >= STACK_DEPTH))
            desc = desc & ~over
            s.push(sp, 1, far, desc)
            s.push(sp, 2, near, desc)
            sp = torch.where(desc, sp + 2, sp)
        s.overflow |= over
        s.sp = torch.where(over, -1, sp)
    return s.outputs(f"lab_traverse with k_pop={k_pop}", count, counts)


def brless_traverse_plain(nodes, tris, o, d, t_max, rows=32, leaf_when=False, counts=None):
    """The plain version of `brless_traverse`: the 8 leaf tests run for
    every packet every iteration, masked by the gate (`leaf_when` selects
    afterwards, which gives the same values)."""
    _check_args(rows)
    s = _Packets(o, d, t_max, rows)
    while bool((s.sp >= 0).any()):
        act = s.sp >= 0
        sp = s.sp
        node = torch.where(act, s.stack[s.pk, sp.clamp(min=0)], 0)
        hit_any, off, cnt_leaf, near, far = s.node(nodes, node, act)
        s.leaf(tris, off, cnt_leaf, act & hit_any & (cnt_leaf > 0))
        over = act & (sp + 1 >= STACK_DEPTH)
        s.push(sp, 0, far, act & ~over)
        s.push(sp, 1, near, act & ~over)
        s.overflow |= over
        sp = torch.where(act, torch.where(hit_any & (cnt_leaf == 0), sp + 1, sp - 1), sp)
        s.sp = torch.where(over, -1, sp)
    return s.outputs("brless_traverse", False, counts)


def floor_nodes(n_iter: int, device=None) -> torch.Tensor:
    """The node index floor_bench reads at each iteration: slot (7i+3) % 32
    of a zeroed 32-slot stack into which iteration j wrote j at slot j % 32
    -> (n_iter,) int64."""
    i = torch.arange(n_iter, device=device)
    j = i - torch.remainder(i - (7 * i + 3) % FLOOR_SLOTS, FLOOR_SLOTS)
    return torch.where(j >= 0, j, 0)


def floor_addr(node: torch.Tensor) -> torch.Tensor:
    """The reference's record address: the block of node % 17000, the lane
    of node itself."""
    return (node % FLOOR_WRAP) // LANES * LANES + node % LANES


def floor_bench_plain(nodes, ox, n_iter=5000, with_load=False, with_slab=False, rows=32):
    """The plain version of `floor_bench` -> (rows, 128) f32, every lane
    acc + n_iter, acc the float32 sum, in order, of the loaded lo.x when
    with_load and not with_slab, else 0. The slab vote changes no output
    (the reference adds it times 0), so it is not computed here."""
    _check_floor(nodes, ox, rows)
    acc = torch.zeros((), dtype=torch.float32)
    if with_load and not with_slab:
        for v in nodes[floor_addr(floor_nodes(n_iter, nodes.device)), 0].cpu():
            acc = acc + v
    out = acc + torch.tensor(float(n_iter), dtype=torch.float32)
    return out.to(ox.device).expand(rows, LANES).clone()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_traversal(nodes, tris, o, d, t_max, rows):
    dev = o.device
    R = o.shape[0]
    kernel_launch.check("nodes", nodes, (None, 8), dev)
    kernel_launch.check("tris", tris, (None, 3, 3), dev)
    kernel_launch.check("o", o, (R, 3), dev)
    kernel_launch.check("d", d, (R, 3), dev)
    kernel_launch.check("t_max", t_max, (R,), dev)
    if R + rows * LANES >= 2 ** 31:
        raise ValueError(f"{R} rays exceed the kernel's int32 lane count")


def _check_floor(nodes, ox, rows):
    _check_args(rows)
    kernel_launch.check("nodes", nodes, (None, 8), nodes.device)
    kernel_launch.check("ox", ox, (None,), nodes.device)
    if nodes.shape[0] < FLOOR_MIN_NODES:
        raise ValueError(f"floor_bench reads records up to {FLOOR_MIN_NODES - 1} "
                         f"(node % {FLOOR_WRAP}); the table has {nodes.shape[0]}")
    if ox.shape[0] < rows * LANES:
        raise ValueError(f"ox has {ox.shape[0]} values, the packet {rows * LANES}")


def _launch_traversal(name, args, nodes, tris, o, d, t_max, rows):
    """Pad, launch kernel `name` with the extra int `args`, check the
    overflow flag -> (t, prim, cnt, cnt2)."""
    o, d, t_max = _pad(o, d, t_max, rows)
    Rp = o.shape[0]
    dev = o.device
    t = torch.empty(Rp, dtype=torch.float32, device=dev)
    prim = torch.empty(Rp, dtype=torch.int32, device=dev)
    cnt = torch.empty(Rp, dtype=torch.int32, device=dev)
    cnt2 = torch.empty(Rp, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(name)(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
                          t_max.data_ptr(), Rp // (rows * LANES), rows, *args, t.data_ptr(),
                          prim.data_ptr(), cnt.data_ptr(), cnt2.data_ptr(),
                          overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    if Rp:
        kernel_launch.n_launches[name] += 1
    if int(overflow.item()):
        raise StackOverflow(f"{name} overflowed its {STACK_DEPTH}-entry packet stack "
                            "on this tree")
    shape = (Rp // LANES, LANES)
    return t.view(shape), prim.view(shape), cnt.view(shape), cnt2.view(shape)


def lab_traverse(nodes, tris, o, d, t_max, rows=32, k_pop=1, leaf_mode="extract8",
                 count=False, vec=False):
    """nodes (Nn, 8) f32 (binary.pack_binary_cuda), tris (N, 3, 3), o/d
    (R, 3), t_max (R,) f32 -> t, prim, cnt, cnt2, each (Rp/128, 128).
    rows in ROWS, 1 <= k_pop <= 4.

    Stack bound: with k_pop = 1 a packet holds at most depth + 1 entries,
    which the packer's depth check (depth < 63) keeps inside the 64; with
    k_pop > 1 each iteration pops up to k_pop and pushes up to 2*k_pop, so
    the walk can need about k_pop entries per level. No static bound under
    64 holds for the bench tree there, so the kernel checks every push and
    the call raises StackOverflow (after a sync) when one would pass the
    64th entry."""
    if o.device.type == "cpu":
        return lab_traverse_plain(nodes, tris, o, d, t_max, rows, k_pop, leaf_mode, count,
                                  vec)
    _check_args(rows, k_pop, leaf_mode)
    _check_traversal(nodes, tris, o, d, t_max, rows)
    return _launch_traversal("lab_traverse",
                             (k_pop, int(leaf_mode == "extract8"), int(vec), int(count)),
                             nodes, tris, o, d, t_max, rows)


def brless_traverse(nodes, tris, o, d, t_max, rows=32, leaf_when=False):
    """Tables and rays as `lab_traverse` -> t, prim, cnt, cnt2 (the counters
    zero). Stack bound: the walk keeps a node of depth >= p at entry p and
    writes entry sp + 1, at most depth + 1; the packer's depth check keeps
    that under 64, and the kernel checks it anyway (StackOverflow)."""
    if o.device.type == "cpu":
        return brless_traverse_plain(nodes, tris, o, d, t_max, rows, leaf_when)
    _check_args(rows)
    _check_traversal(nodes, tris, o, d, t_max, rows)
    return _launch_traversal("brless_traverse", (tris.shape[0], int(leaf_when)), nodes,
                             tris, o, d, t_max, rows)


def floor_bench(nodes, ox, n_iter=5000, with_load=False, with_slab=False, rows=32):
    """nodes (Nn, 8) f32 with Nn >= FLOOR_MIN_NODES, ox (>= rows*128,) f32
    -> (rows, 128) f32, every lane acc + n_iter."""
    if ox.device.type == "cpu":
        return floor_bench_plain(nodes, ox, n_iter, with_load, with_slab, rows)
    _check_floor(nodes, ox, rows)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=ox.device)
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream(ox.device).cuda_stream
        rc = _entry("floor_bench")(nodes.data_ptr(), ox.data_ptr(), rows, n_iter,
                                   int(with_load), int(with_slab), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"floor_bench launch failed: cudaError {rc}")
    kernel_launch.n_launches["floor_bench"] += 1
    return out


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def ray_classes(sc, dbvh, cam, R=65536, device=None):
    """The JAX lab's ray classes (kernel_lab.py:460-503), RandomState(7) in
    its order: camera rays, then diffuse-bounce and shadow rays from the
    camera hits (found by the port's binary traversal: cuda_binary on the
    card, plain_binary on the CPU), both sorted by `dispatch.ray_sort_key`
    (stable) -> {"camera"|"bounce"|"shadow": (o, d, t_max)} tensors on
    `device`."""
    device = resolve_device(device, sc)
    rs = np.random.RandomState(7)
    pixel_idx = torch.arange(R, dtype=torch.int32, device=device) % (cam.width * cam.height)
    u = torch.as_tensor(rs.rand(R, 2).astype(np.float32), device=device)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u, u)
    o, d = o.contiguous(), d.contiguous()
    backend = "cuda_binary" if device.type == "cuda" else "plain_binary"
    isect = dispatch.make_intersectors(sc, dbvh, device, backend=backend)
    hit = isect.closest(o, d, torch.full((R,), 1e30, dtype=torch.float32, device=device))
    o, d = o.cpu().numpy(), d.cpu().numpy()
    t = hit.t.cpu().numpy()
    found = (hit.prim >= 0).cpu().numpy()

    p = o + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    dirs = rs.randn(R, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ob = p + 1e-3 * dirs
    tb = np.where(found, 1e30, -1.0).astype(np.float32)
    lp = np.array([0.0, 6.0, 0.0], np.float32) + 0.5 * rs.randn(R, 3).astype(np.float32)
    sd = lp - p
    dist = np.linalg.norm(sd, axis=1, keepdims=True)
    sd = sd / np.maximum(dist, 1e-9)
    os_ = p + 1e-3 * sd
    ts = np.where(found, dist[:, 0] * 0.999, -1.0).astype(np.float32)

    bounds = np.asarray(host(sc.bounds), np.float32)
    blo = torch.as_tensor(bounds[0], device=device)
    bext = torch.as_tensor(np.maximum(bounds[1] - bounds[0], 1e-9).astype(np.float32),
                           device=device)
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    def sorted_batch(o_, d_, t_):
        o_, d_, t_ = f32(o_), f32(d_), f32(t_)
        order = torch.argsort(dispatch.ray_sort_key(o_, d_, blo, bext, t_), stable=True)
        return o_[order].contiguous(), d_[order].contiguous(), t_[order].contiguous()

    return {"camera": (f32(o), f32(d), f32(np.full((R,), 1e30, np.float32))),
            "bounce": sorted_batch(ob, dirs, tb),
            "shadow": sorted_batch(os_, sd, ts)}


def timeit(fn, *args, n=5, **kw):
    """-> (median ms of n calls by CUDA events after a warm-up, last result)."""
    out = []
    ms = median_ms(lambda: out.append(fn(*args, **kw)), n)
    return ms, out[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the bounce class only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_lab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sc, dbvh, cam = build_bench_scene()
    print(f"scene: {sc.n_tris} tris, {dbvh.n_nodes} nodes", flush=True)
    R = 65536
    rays = ray_classes(sc, dbvh, cam, R, dev)
    nodes, tris = dispatch.make_intersectors(sc, dbvh, dev, backend="cuda_binary").tables
    results = {}

    def run(tag, cls, fn=lab_traverse, **kw):
        ms, (t, prim, cnt, cnt2) = timeit(fn, nodes, tris, *rays[cls], **kw)
        hits = int((prim.reshape(-1)[:R] >= 0).sum())
        line = f"{tag:42s} {cls:7s} {ms:8.3f} ms  {R / ms / 1e3:7.2f} Mray/s  hits={hits}"
        rec = {"ms": ms, "hits": hits}
        if kw.get("count"):
            rws = kw.get("rows", 32)
            rec["iters"] = int(cnt[::rws, 0].sum())
            rec["leafs"] = int(cnt2[::rws, 0].sum())
            line += f"  iters={rec['iters']}  leafs={rec['leafs']}"
        print(line, flush=True)
        results[f"{tag} {cls}"] = rec

    classes = ["bounce"] if args.quick else ["camera", "bounce", "shadow"]
    for cls in classes:
        run("sq rows=32 k=1", cls, rows=32, k_pop=1)
    for cls in classes:
        run("sq+count rows=32 k=1", cls, rows=32, k_pop=1, count=True)

    ox = rays["bounce"][0][:, 0].repeat(2).contiguous()
    for wl, ws, tag in [(False, False, "floor: stack only"), (True, False, "floor: +load+extract"),
                        (True, True, "floor: +slab+any")]:
        n_iter = 20000
        ms, _ = timeit(floor_bench, nodes, ox, n_iter=n_iter, with_load=wl, with_slab=ws)
        ns = ms * 1e6 / n_iter
        print(f"{tag:42s} {ns:8.1f} ns/iter", flush=True)
        results[tag] = {"ms": ms, "ns_per_iter": ns}

    for cls in classes:
        for lw, tag in ((False, "brless leaf=always rows=32"), (True, "brless leaf=select rows=32")):
            run(tag, cls, brless_traverse, rows=32, leaf_when=lw)

    print(json.dumps({"kernel_lab": results, "device": torch.cuda.get_device_name(0),
                      "name_power_limit": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
