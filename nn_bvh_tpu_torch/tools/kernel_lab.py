"""Traversal kernel lab on the CUDA card (port of tools/perf/kernel_lab.py).

    python -m nn_bvh_tpu_torch.tools.kernel_lab [--quick]
    python -m nn_bvh_tpu_torch.tools.kernel_lab --source LABEL=PATH[:ABI] ... [--quick]
        [--json PATH]

Three packet kernels (csrc/kernel_lab.cu), each with its plain torch twin in
this module, and the lab's harness. What they compute is the JAX lab's, on
the lab's own tables (`lab_tables`: node records of
`accel.binary.pack_binary_cuda`, triangles (N, 3, 3)):

- `lab_traverse`: binary BVH packet traversal, a packet being `rows*128`
  lanes with one 64-entry stack; a node is visited when any lane's box test
  hits it; the near child comes from the sign of the packet's summed
  direction on the split axis; `k_pop` entries popped per iteration (an
  empty slot visits the root, and counts); leaf tests compiled out with
  `leaf_mode="none"`; `cnt` (visits) and `cnt2` (leaf visits that some lane
  hit) per packet, written to every lane when `count`. On the card a
  packet runs as a thread-block cluster (`launch_geometry`) whose vote
  crosses its blocks through distributed shared memory.
- `brless_traverse`: the branchless variant: leaf tests every iteration at
  clamped indices, masked; unconditional pushes. Its counters are zero, as
  the reference never writes them.
- `floor_bench`: a loop-floor probe on one packet: `n_iter` dependent stack
  reads, node loads and toy slab votes. On the card the packet is laid out
  as the traversals lay it out (a cluster, `launch_geometry`), so each
  variant (`FLOOR_VARIANTS`) adds one piece of a lab visit: the stack and
  its barrier, the record's load and publication, the vote.
  `floor_cycles` times those pieces alone (clock64; a probe with no plain
  version) and `floor_chain` sums the ones on each variant's chain.

Returns are the JAX functions', padded the same way (o = 0, d = 1,
t_max = -1 on padding lanes, which vote like any other): `t, prim, cnt, cnt2`
each (Rp/128, 128); `floor_bench` (rows, 128). A miss keeps t = t_max and
prim = -1. Each wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; each launch adds one to
`accel.kernel_launch.n_launches` under the kernel's name.

The harness (`main`) runs what the JAX `main` runs, in its order, on the
bench scene: the status-quo kernel per ray class without and with counters,
the three floor variants at n_iter = 20,000 at each geometry of
`FLOOR_GEOMETRIES` (ns/iter; `floor_sweep`), the two branchless
variants per class. `--quick` keeps the bounce class. Times are CUDA events,
the median of 5 calls after a warm-up. It needs a card and exits 1 without
one; the last line of standard output is one JSON object with every number,
the card's name and nvidia-smi's name and power limit.

With `--source`, the harness times the packet kernels of several sources
of csrc/kernel_lab.cu side by side instead: each PATH is built once
(`bvh4_ab.build_sources`: kernels.NVCC_FLAGS, `-I` csrc/ and the source's
own directory) and its ptxas report printed; `:block` marks a source whose
entries take no launch geometry (one packet per block, as up to commit
f002d054), `:floor-block` one whose floor_bench alone takes none (one
block, as up to commit 9a6320c6). For each class and each of `VARIANTS`,
every source runs in turns (A B ... B A; `timeit` each), its outputs must
equal the first source's bit for bit (t, prim, cnt, cnt2), and the line
gives each source's two medians, its cluster geometry and, with counters,
the microseconds per visit of the longest packet (ms / max cnt). Then
`floor_sweep` over the sources' floor_bench, each held to the plain
version, in ns an iteration. --json PATH writes the report.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..accel import binary, dispatch, kernel_launch
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
# a packet's launch geometry (launch_geometry): a cluster of at most
# MAX_CLUSTER blocks of WARP..BLOCK_THREADS threads, one lane a thread
MAX_CLUSTER = 8
BLOCK_THREADS = 512
WARP = 32
MAX_POP = 4
FLOOR_WRAP = 17000
# floor_bench's address ((node % 17000) // 128) * 128 + node % 128 reaches
# record 17,023: the 133 blocks of 128 records that 17,000 wrapped indices span
FLOOR_MIN_NODES = -(-FLOOR_WRAP // LANES) * LANES
FLOOR_SLOTS = 32
FLOOR_ITERS = 20000
FLOOR_VARIANTS = {"stack only": (False, False), "+load": (True, False), "+slab": (True, True)}
# the floor's sweep: the lab's packet (rows 32: 8 blocks of 512 threads),
# one block of 512 threads (the block OR, no exchange between blocks), 8
# blocks of 64 (the exchange with a cheap OR)
FLOOR_GEOMETRIES = {"rows=32": (32, None), "rows=4 cluster=1": (4, 1),
                    "rows=4 cluster=8": (4, 8)}
# floor_cycles' pieces, in the order of its output
FLOOR_PIECES = ("st_bar", "bar", "ld", "ldg", "pub_bar", "pub_vote", "or", "xchg", "vote")

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "lab_traverse": [_VP] * 5 + [_INT] * 8 + [_VP] * 6,
    "brless_traverse": [_VP] * 5 + [_INT] * 6 + [_VP] * 6,
    "floor_bench": [_VP, _VP] + [_INT] * 6 + [_VP, _VP],
    "floor_cycles": [_VP] + [_INT] * 4 + [_VP, _VP],
}
# the entries of a source with one packet per block (commit f002d054 and
# earlier; floor_bench also at commit 9a6320c6): no cluster and threads
# arguments
_BLOCK_ARGTYPES = {"lab_traverse": [_VP] * 5 + [_INT] * 6 + [_VP] * 6,
                   "brless_traverse": [_VP] * 5 + [_INT] * 4 + [_VP] * 6,
                   "floor_bench": [_VP, _VP] + [_INT] * 4 + [_VP, _VP]}


class StackOverflow(ValueError):
    """A packet walk needed more than the 64 entries of its stack."""


def _bind(lib, name: str, argtypes: dict):
    fn = getattr(lib, name)
    fn.argtypes = argtypes[name]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry(name: str):
    return _bind(kernels.load(SOURCE), name, _ARGTYPES)


def block_threads(rows: int) -> int:
    """Threads of the direction sums' order: min(rows*128, 1024) (the
    block of one packet per block)."""
    return min(rows * LANES, MAX_THREADS)


def launch_geometry(rows: int, cluster=None) -> tuple:
    """-> (cluster, threads) of the packet kernels: a packet of rows*128
    lanes is a cluster of C blocks of `threads` threads, one lane a thread
    (C a power of two, at most MAX_CLUSTER; WARP..BLOCK_THREADS threads).
    C is the most blocks that hold a warp's lanes each: min(8, rows*4). On
    the H100 that beat the fewest blocks that fill the 132 SMs once (rows
    16 and 8 at R = 65,536: C = 4 and 2), since several clusters then share
    an SM and hide each other's waits (PERF.md §6). `cluster` forces C
    (ValueError where no block of 32..512 threads holds its share)."""
    _check_args(rows)
    lanes = rows * LANES
    if cluster is None:
        cluster = min(MAX_CLUSTER, lanes // WARP)
    if cluster not in (1, 2, 4, 8) or not WARP <= lanes // cluster <= BLOCK_THREADS:
        raise ValueError(f"no launch geometry has a cluster of {cluster} blocks for "
                         f"rows={rows}: a block holds {WARP}..{BLOCK_THREADS} lanes")
    return cluster, lanes // cluster


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
    if nodes.data_ptr() % 16:
        raise ValueError("nodes must start on a 16-byte boundary (the kernels load records "
                         "as float4)")


def _check_floor(nodes, ox, rows):
    _check_args(rows)
    kernel_launch.check("nodes", nodes, (None, 8), nodes.device)
    kernel_launch.check("ox", ox, (None,), nodes.device)
    if nodes.shape[0] < FLOOR_MIN_NODES:
        raise ValueError(f"floor_bench reads records up to {FLOOR_MIN_NODES - 1} "
                         f"(node % {FLOOR_WRAP}); the table has {nodes.shape[0]}")
    if ox.shape[0] < rows * LANES:
        raise ValueError(f"ox has {ox.shape[0]} values, the packet {rows * LANES}")


def _launch_traversal(fn, name, args, nodes, tris, o, d, t_max, rows, cluster=None):
    """Check the tensors, pad, launch `fn` (the C entry `name`) with the
    extra int `args` after the launch geometry (launch_geometry;
    cluster="block": an entry of one packet per block, which takes none),
    check the overflow flag -> (t, prim, cnt, cnt2). Launches count under
    `name`."""
    _check_traversal(nodes, tris, o, d, t_max, rows)
    o, d, t_max = _pad(o, d, t_max, rows)
    Rp = o.shape[0]
    dev = o.device
    n_packets = Rp // (rows * LANES)
    geo = () if cluster == "block" else launch_geometry(rows, cluster)
    t = torch.empty(Rp, dtype=torch.float32, device=dev)
    prim = torch.empty(Rp, dtype=torch.int32, device=dev)
    cnt = torch.empty(Rp, dtype=torch.int32, device=dev)
    cnt2 = torch.empty(Rp, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), n_packets, rows, *geo, *args,
                t.data_ptr(), prim.data_ptr(), cnt.data_ptr(), cnt2.data_ptr(),
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
                 count=False, vec=False, cluster=None):
    """nodes (Nn, 8) f32 (binary.pack_binary_cuda), tris (N, 3, 3), o/d
    (R, 3), t_max (R,) f32 -> t, prim, cnt, cnt2, each (Rp/128, 128).
    rows in ROWS, 1 <= k_pop <= 4. On the card a packet runs as a cluster
    of `launch_geometry` blocks; `cluster` forces its size (1, 2, 4 or 8),
    which changes no result. A cluster launch that the card refuses
    raises.

    Stack bound: with k_pop = 1 a packet holds at most depth + 1 entries,
    which the packer's depth check (depth < 63) keeps inside the 64; with
    k_pop > 1 each iteration pops up to k_pop and pushes up to 2*k_pop, so
    the walk can need about k_pop entries per level. No static bound under
    64 holds for the bench tree there, so the kernel checks every push and
    the call raises StackOverflow (after a sync) when one would pass the
    64th entry."""
    if o.device.type == "cpu":
        _check_cluster(rows, cluster)
        return lab_traverse_plain(nodes, tris, o, d, t_max, rows, k_pop, leaf_mode, count,
                                  vec)
    _check_args(rows, k_pop, leaf_mode)
    return _launch_traversal(_entry("lab_traverse"), "lab_traverse",
                             lab_args(k_pop, leaf_mode, count, vec), nodes, tris, o, d, t_max,
                             rows, cluster)


def lab_args(k_pop=1, leaf_mode="extract8", count=False, vec=False) -> tuple:
    """The C entry lab_traverse's int arguments after the geometry."""
    return k_pop, int(leaf_mode == "extract8"), int(vec), int(count)


def brless_traverse(nodes, tris, o, d, t_max, rows=32, leaf_when=False, cluster=None):
    """Tables and rays as `lab_traverse` -> t, prim, cnt, cnt2 (the counters
    zero); `cluster` as there. Stack bound: the walk keeps a node of depth
    >= p at entry p and writes entry sp + 1, at most depth + 1; the
    packer's depth check keeps that under 64, and the kernel checks it
    anyway (StackOverflow)."""
    if o.device.type == "cpu":
        _check_cluster(rows, cluster)
        return brless_traverse_plain(nodes, tris, o, d, t_max, rows, leaf_when)
    _check_args(rows)
    return _launch_traversal(_entry("brless_traverse"), "brless_traverse",
                             (tris.shape[0], int(leaf_when)), nodes, tris, o, d, t_max, rows,
                             cluster)


def _check_cluster(rows, cluster):
    """A forced cluster size is checked on the CPU too (the plain walk
    has no geometry, and its result is the same for every one)."""
    if cluster is not None:
        launch_geometry(rows, cluster)


def floor_bench(nodes, ox, n_iter=5000, with_load=False, with_slab=False, rows=32,
                cluster=None):
    """nodes (Nn, 8) f32 with Nn >= FLOOR_MIN_NODES, ox (>= rows*128,) f32
    -> (rows, 128) f32, every lane acc + n_iter. On the card the probe is
    one packet laid out as the traversals lay it out, a cluster of
    `launch_geometry` blocks; `cluster` forces its size as there, which
    changes no result. A cluster launch that the card refuses raises."""
    if ox.device.type == "cpu":
        _check_cluster(rows, cluster)
        return floor_bench_plain(nodes, ox, n_iter, with_load, with_slab, rows)
    return _launch_floor(_entry("floor_bench"), "floor_bench", nodes, ox, n_iter, with_load,
                         with_slab, rows, cluster)


def _launch_floor(fn, name, nodes, ox, n_iter, with_load, with_slab, rows, cluster=None):
    """Check the tensors, launch `fn` (the C entry floor_bench; cluster=
    "block": an entry of one block, which takes no geometry) -> (rows,
    128). Launches count under `name`."""
    _check_floor(nodes, ox, rows)
    geo = () if cluster == "block" else launch_geometry(rows, cluster)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=ox.device)
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream(ox.device).cuda_stream
        rc = fn(nodes.data_ptr(), ox.data_ptr(), rows, *geo, n_iter, int(with_load),
                int(with_slab), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    kernel_launch.n_launches[name] += 1
    return out


def floor_cycles(nodes, rows=32, cluster=None, reps=1000) -> dict:
    """The pieces of a floor iteration, each timed alone on the card by
    clock64 as a chain of `reps` steps in one cluster of the floor's
    geometry (csrc/kernel_lab.cu::floor_cycles_kernel says what each is) ->
    {piece of FLOOR_PIECES: cycles a step}. Its record loads are L2 hits
    once the floor has read the table. A probe of the card, with no plain
    version: CPU tensors raise. Launches count as "floor_cycles"."""
    if nodes.device.type != "cuda":
        raise ValueError(f"floor_cycles measures the card; nodes is on {nodes.device}")
    kernel_launch.check("nodes", nodes, (None, 8), nodes.device)
    if nodes.shape[0] < FLOOR_MIN_NODES:
        raise ValueError(f"floor_cycles reads records up to {FLOOR_MIN_NODES - 1}")
    C, T = launch_geometry(rows, cluster)
    out = torch.zeros(len(FLOOR_PIECES) + 1, dtype=torch.int64, device=nodes.device)
    with torch.cuda.device(nodes.device):
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        rc = _entry("floor_cycles")(nodes.data_ptr(), rows, C, T, reps, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"floor_cycles launch failed: cudaError {rc}")
    kernel_launch.n_launches["floor_cycles"] += 1
    *cycles, dep = out.tolist()
    if dep != 0:
        raise RuntimeError(f"floor_cycles: its chains' dependences sum to {dep}, not 0")
    return {p: c / reps for p, c in zip(FLOOR_PIECES, cycles)}


def floor_chain(pieces: dict) -> dict:
    """Each variant's cycles an iteration, estimated from the pieces
    (`floor_cycles`) on its chain of dependences, one piece for each step
    as the kernel calls it. Stack only: the write and the barrier (st_bar;
    the read feeds nothing). +load: the read, the record load at its
    address, the publication and the barrier (ld + ldg + pub_bar; the
    write, of another slot, is off the chain). +slab: the read, the load,
    the publication and the vote (ld + ldg + pub_vote). An estimate, not a
    bound: pieces timed alone may overlap in the kernel, so the sum can
    exceed the kernel's own iteration."""
    head = pieces["ld"] + pieces["ldg"]
    return {"stack only": pieces["st_bar"], "+load": head + pieces["pub_bar"],
            "+slab": head + pieces["pub_vote"]}


def sm_clock_mhz() -> float:
    """The SM clock (MHz) that `nvidia-smi --query-gpu=clocks.sm` prints
    while the card spins in torch.cuda._sleep (idle, it would print the
    idle clock)."""
    torch.cuda._sleep(3_000_000_000)  # about 1.5 s
    line = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    return float(line.split()[0])


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def lab_tables(sc, dbvh, device=None) -> tuple:
    """The lab's own tables of a scene on `device` (devices.resolve_device):
    32-byte node records (`binary.pack_binary_cuda`) and (N, 3, 3) vertex
    triangles."""
    device = resolve_device(device, sc)
    n = dbvh.n_nodes
    lo, hi, meta = (host(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    return (torch.as_tensor(binary.pack_binary_cuda(lo, hi, meta), device=device),
            torch.as_tensor(np.ascontiguousarray(host(sc.tri_p), np.float32), device=device))


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


# chip_smoke phase 11's variants and the --source harness's: tag ->
# (kernel, keyword arguments); the first of each kernel is timed there
VARIANTS = {
    "lab rows=32 k=1": ("lab_traverse", dict(rows=32, count=True)),
    "lab rows=16 k=1": ("lab_traverse", dict(rows=16, count=True)),
    "lab rows=8 k=1": ("lab_traverse", dict(rows=8, count=True)),
    "lab rows=32 k=2": ("lab_traverse", dict(rows=32, k_pop=2, count=True)),
    "lab rows=32 k=4": ("lab_traverse", dict(rows=32, k_pop=4, count=True)),
    "lab rows=32 no leaf": ("lab_traverse", dict(rows=32, leaf_mode="none", count=True)),
    "lab rows=32 vec": ("lab_traverse", dict(rows=32, vec=True, count=True)),
    "brless leaf=always": ("brless_traverse", dict(rows=32, leaf_when=False)),
    "brless leaf=select": ("brless_traverse", dict(rows=32, leaf_when=True)),
}


def source_fns(lib, label: str, abi: str = "") -> dict:
    """The packet kernels of a built kernel_lab source -> {kernel name:
    fn(nodes, tris, o, d, t_max, **kw) for the traversals, fn(nodes, ox,
    n_iter, with_load, with_slab, rows, cluster) for floor_bench}, launches
    counted as "LABEL:NAME". `abi` (parse_source): "block", entries without
    launch geometry; "floor-block", floor_bench alone so (it runs one block
    of min(rows*128, 1024) threads, whatever `cluster`)."""
    argtypes = _BLOCK_ARGTYPES if abi == "block" else _ARGTYPES
    lab, brless = (_bind(lib, n, argtypes) for n in ("lab_traverse", "brless_traverse"))
    floor = _bind(lib, "floor_bench", _BLOCK_ARGTYPES if abi else _ARGTYPES)
    cluster = "block" if abi == "block" else None

    def lab_fn(nodes, tris, o, d, t_max, rows=32, k_pop=1, leaf_mode="extract8", count=False,
               vec=False):
        _check_args(rows, k_pop, leaf_mode)
        return _launch_traversal(lab, f"{label}:lab_traverse",
                                 lab_args(k_pop, leaf_mode, count, vec), nodes, tris, o, d,
                                 t_max, rows, cluster)

    def brless_fn(nodes, tris, o, d, t_max, rows=32, leaf_when=False):
        _check_args(rows)
        return _launch_traversal(brless, f"{label}:brless_traverse",
                                 (tris.shape[0], int(leaf_when)), nodes, tris, o, d, t_max,
                                 rows, cluster)

    def floor_fn(nodes, ox, n_iter=5000, with_load=False, with_slab=False, rows=32,
                 cluster=None):
        return _launch_floor(floor, f"{label}:floor_bench", nodes, ox, n_iter, with_load,
                             with_slab, rows, "block" if abi else cluster)

    return {"lab_traverse": lab_fn, "brless_traverse": brless_fn, "floor_bench": floor_fn}


def parse_source(spec: str):
    """"LABEL=PATH[:ABI]" -> (label, path, abi); ABI "block" or
    "floor-block" (source_fns), default "" (the tree's entries)."""
    label, rest = spec.split("=", 1)
    path, _, abi = rest.partition(":")
    if abi not in ("", "block", "floor-block"):
        raise ValueError(f"unknown entry signature {abi!r} (only 'block' or 'floor-block')")
    return label, path, abi


def timeit(fn, *args, n=5, **kw):
    """-> (median ms of n calls by CUDA events after a warm-up, last result)."""
    out = []
    ms = median_ms(lambda: out.append(fn(*args, **kw)), n)
    return ms, out[-1]


def floor_ox(rays):
    """The floor's lane values: the bounce class's o.x, twice over."""
    return rays["bounce"][0][:, 0].repeat(2).contiguous()


def floor_sweep(fns: dict, nodes, ox, n_iter=FLOOR_ITERS) -> dict:
    """Every floor variant (FLOOR_VARIANTS) at every geometry of
    FLOOR_GEOMETRIES through each of `fns` ({label: fn(nodes, ox, n_iter,
    with_load, with_slab, rows, cluster)}) in turns (A B ... B A; `timeit`
    each), every result held bit for bit to floor_bench_plain ->
    {(variant, geometry): {label: [ms, ms]}}."""
    labels = list(fns)
    report = {}
    for geo, (rows, cluster) in FLOOR_GEOMETRIES.items():
        for variant, (wl, ws) in FLOOR_VARIANTS.items():
            want = floor_bench_plain(nodes, ox, n_iter, wl, ws, rows)
            times = {lb: [] for lb in labels}
            for lb in labels + labels[::-1]:
                ms, out = timeit(fns[lb], nodes, ox, n_iter, wl, ws, rows, cluster)
                if not torch.equal(out, want):
                    raise AssertionError(f"floor {variant} {geo}: {lb} differs from the plain "
                                         "version")
                times[lb].append(ms)
            report[(variant, geo)] = times
    return report


def ns_per_iter(readings, n_iter=FLOOR_ITERS) -> float:
    """Floor readings (ms) -> their mean in ns an iteration."""
    return float(np.mean(readings)) * 1e6 / n_iter


def compare_sources(specs, classes, rays, nodes, tris, smi, json_path=None) -> int:
    """The --source harness (module docstring) -> exit code."""
    from .bvh4_ab import build_sources

    specs = [parse_source(s) for s in specs]
    built = build_sources([path for _, path, _ in specs])
    ptxas = {path: kernels.ptxas_lines(log) for path, (_, log) in built.items()}
    for path, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {path}: {line}", flush=True)
    fns = {label: source_fns(built[path][0], label, abi) for label, path, abi in specs}
    labels = list(fns)
    R = rays["bounce"][0].shape[0]
    report = {}
    for cls in classes:
        o, d, t_max = rays[cls]
        for tag, (kname, kw) in VARIANTS.items():
            times, outs = {lb: [] for lb in labels}, {}
            for lb in labels + labels[::-1]:
                ms, outs[lb] = timeit(fns[lb][kname], nodes, tris, o, d, t_max, **kw)
                times[lb].append(ms)
            for lb in labels[1:]:
                for a, b, what in zip(outs[lb], outs[labels[0]], ("t", "prim", "cnt", "cnt2")):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{tag} {cls}: {lb}'s {what} differs from "
                                             f"{labels[0]}'s")
            rows = kw["rows"]
            n_packets = -(-R // (rows * LANES))
            visits = int(outs[labels[0]][2].max()) if kw.get("count") else 0
            rec = {"visits_longest_packet": visits, "geometry": launch_geometry(rows)}
            line = f"{tag:22s} {cls:7s}"
            for lb in labels:
                ms = float(np.mean(times[lb]))
                rec[lb] = {"ms": ms, "readings": times[lb]}
                line += f"  {lb} {ms:9.4f} ({'/'.join(f'{x:.4f}' for x in times[lb])})"
                if visits:
                    rec[lb]["us_per_visit"] = ms * 1e3 / visits
                    line += f" {ms * 1e3 / visits:.3f} us/visit"
            line += (f"; {n_packets} packets, cluster/threads {rec['geometry']}"
                     + (f", longest packet {visits} visits" if visits else "")
                     + f"; {labels[1:]} bit-equal to {labels[0]}")
            print(line, flush=True)
            report[f"{tag} {cls}"] = rec
    floor = floor_sweep({lb: fns[lb]["floor_bench"] for lb in labels}, nodes, floor_ox(rays))
    for (variant, geo), times in floor.items():
        line = f"floor {variant:10s} {geo:16s}"
        rec = {"geometry": launch_geometry(*FLOOR_GEOMETRIES[geo])}
        for lb in labels:
            rec[lb] = {"ns_per_iter": ns_per_iter(times[lb]), "readings": times[lb]}
            line += (f"  {lb} {rec[lb]['ns_per_iter']:8.2f} ns/iter "
                     f"({'/'.join(f'{x:.4f}' for x in times[lb])} ms)")
        print(line + f"; cluster/threads {rec['geometry']} (a block source: one block); "
              "every source bit-equal to the plain version", flush=True)
        report[f"floor {variant} {geo}"] = rec
    out = {"kernel_lab_sources": report, "sources": {lb: p for lb, p, _ in specs},
           "device": torch.cuda.get_device_name(0), "name_power_limit": smi}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({**out, "ptxas": ptxas}, f, indent=1)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the bounce class only")
    ap.add_argument("--source", action="append", metavar="LABEL=PATH[:ABI]",
                    help="time these kernel_lab sources side by side (repeatable)")
    ap.add_argument("--json", help="with --source: write the report to this file")
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
    nodes, tris = lab_tables(sc, dbvh, dev)
    classes = ["bounce"] if args.quick else ["camera", "bounce", "shadow"]
    if args.source:
        return compare_sources(args.source, classes, rays, nodes, tris, smi, args.json)
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

    for cls in classes:
        run("sq rows=32 k=1", cls, rows=32, k_pop=1)
    for cls in classes:
        run("sq+count rows=32 k=1", cls, rows=32, k_pop=1, count=True)

    for (variant, geo), times in floor_sweep({"kernel": floor_bench}, nodes,
                                             floor_ox(rays)).items():
        tag = f"floor: {variant} {geo}"
        ns = ns_per_iter(times["kernel"])
        print(f"{tag:42s} {ns:8.1f} ns/iter  cluster/threads "
              f"{launch_geometry(*FLOOR_GEOMETRIES[geo])}", flush=True)
        results[tag] = {"ms": float(np.mean(times["kernel"])), "ns_per_iter": ns}

    for cls in classes:
        for lw, tag in ((False, "brless leaf=always rows=32"), (True, "brless leaf=select rows=32")):
            run(tag, cls, brless_traverse, rows=32, leaf_when=lw)

    print(json.dumps({"kernel_lab": results, "device": torch.cuda.get_device_name(0),
                      "name_power_limit": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
