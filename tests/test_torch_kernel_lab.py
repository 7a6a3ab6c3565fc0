"""The port's traversal kernel lab (nn_bvh_tpu_torch/tools/kernel_lab.py)
against the JAX lab (tools/perf/kernel_lab.py) on the CPU.

The JAX lab's functions take no `interpret=` argument; they run unchanged
under `pltpu.force_tpu_interpret_mode()`. Scene and rays are
tests/test_pallas_interpret.py's (R = 2,048, 20% dead lanes), carried across
with `geometry.scene.scene_from_numpy`; one module-scoped fixture per JAX
call. The port's CPU path is each kernel's plain version (the kernels need a
card: tests/test_torch_cuda.py and chip_smoke.py hold them against these).

Tolerance: prim equal on every live lane, t within atol 1e-4 + rtol 1e-5
(tests/test_pallas_interpret.py:65-79; XLA and torch may round t in another
last bit), and the packet counters cnt and cnt2 exactly equal on every lane.
floor_bench reads stack slots it has not written: the JAX side runs with
`InterpretParams(uninitialized_memory="zero")`, the port's stack is zeroed.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import pallas_traverse as j_ptrav
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import camera as j_camera
from nn_bvh_tpu_torch.accel import binary, kernel_launch
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.tools import bench_scene, kernel_lab
from nn_bvh_tpu_torch.wavefront import camera

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAB_CASES = {
    "rows8": dict(rows=8, count=True),
    "rows16": dict(rows=16, count=True),
    "rows8-k2": dict(rows=8, k_pop=2, count=True),
    "rows8-vec": dict(rows=8, count=True, vec=True),
    "rows8-none": dict(rows=8, leaf_mode="none", count=True),
    "rows16-nocount": dict(rows=16),
}
FLOOR_CASES = {"stack": (False, False), "load": (True, False), "slab": (True, True)}


@pytest.fixture(scope="module")
def jlab():
    """tools/perf/kernel_lab.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_lab", os.path.join(_REPO, "tools", "perf", "kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_scene():
    """tests/test_pallas_interpret.py's scene, built by the JAX package."""
    rs = np.random.RandomState(3)
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * 4 + np.array([0, 1.0, 0])
        b.add_sphere(c, 0.3 + 0.3 * rs.rand(), m, n_theta=10, n_phi=20)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    return sc, dbvh


@pytest.fixture(scope="module")
def ray_batch():
    rs = np.random.RandomState(11)
    R = 2048
    o = (rs.rand(R, 3).astype(np.float32) - 0.5) * 6
    o[:, 1] += 1.5
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((R,), 1e30, np.float32)
    t_max[::5] = -1.0  # dead lanes
    return o, d, t_max


@pytest.fixture(scope="module")
def tables(small_scene):
    """(JAX lane-major node and triangle tables, port node records and
    triangles) of the same BVH."""
    sc, dbvh = small_scene
    n = dbvh.n_nodes
    lo, hi, meta = (np.asarray(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    tri_p = np.asarray(sc.tri_p, np.float32)
    return ((jnp.asarray(j_ptrav.pack_nodes(lo, hi, meta)), jnp.asarray(j_ptrav.pack_tris(tri_p))),
            (torch.as_tensor(binary.pack_binary_cuda(lo, hi, meta)), torch.as_tensor(tri_p)))


def _np(xs):
    return tuple(np.asarray(x) for x in xs)


@pytest.fixture(scope="module", params=list(LAB_CASES))
def lab_case(request, jlab, tables, ray_batch):
    """-> (kwargs, JAX outputs, port outputs) of one lab_traverse case."""
    kw = LAB_CASES[request.param]
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jlab.lab_traverse(*tables[0], *map(jnp.asarray, ray_batch), **kw))
    port = _np(kernel_lab.lab_traverse(*tables[1], *map(torch.from_numpy, ray_batch), **kw))
    return kw, ref, port


@pytest.fixture(scope="module", params=[False, True], ids=["leaf_always", "leaf_select"])
def brless_case(request, jlab, tables, ray_batch):
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jlab.brless_traverse(*tables[0], *map(jnp.asarray, ray_batch), rows=8,
                                       leaf_when=request.param))
    port = _np(kernel_lab.brless_traverse(*tables[1], *map(torch.from_numpy, ray_batch),
                                          rows=8, leaf_when=request.param))
    return ref, port


def _check_hits(ref, port, t_max):
    (jt, jp), (t, p) = ref[:2], port[:2]
    assert t.shape == jt.shape == (len(t_max) // 128, 128)
    assert p.dtype == np.int32 and t.dtype == np.float32
    live = (t_max > 0).reshape(-1, 128)
    np.testing.assert_array_equal(p[live], jp[live])
    assert (p[~live] == -1).all()
    np.testing.assert_allclose(t, jt, atol=1e-4, rtol=1e-5)
    assert (t[~live] == t_max.reshape(-1, 128)[~live]).all()  # a miss keeps t_max


def test_lab_traverse_hits_match_jax(lab_case, ray_batch):
    _, ref, port = lab_case
    _check_hits(ref, port, ray_batch[2])
    if lab_case[0].get("leaf_mode") == "none":
        assert (port[1] == -1).all()


def test_lab_traverse_counters_match_jax(lab_case):
    """cnt and cnt2 per packet, equal on every lane (uniform in a packet)."""
    kw, ref, port = lab_case
    rows = kw["rows"]
    for c, jc in ((port[2], ref[2]), (port[3], ref[3])):
        assert c.dtype == np.int32
        np.testing.assert_array_equal(c, jc)
        per_packet = c.reshape(-1, rows * 128)
        assert (per_packet == per_packet[:, :1]).all()
    if kw.get("count"):
        assert (port[2][::rows, 0] > 0).all() and (port[3][::rows, 0] < port[2][::rows, 0]).all()
    else:
        assert not port[2].any() and not port[3].any()


def test_brless_traverse_matches_jax(brless_case, ray_batch):
    ref, port = brless_case
    _check_hits(ref, port, ray_batch[2])
    for c, jc in zip(port[2:], ref[2:]):  # never written by the reference: zeros
        np.testing.assert_array_equal(c, jc)
        assert not c.any()


def test_brless_and_lab_find_the_same_hits(brless_case, tables, ray_batch):
    lab = kernel_lab.lab_traverse(*tables[1], *map(torch.from_numpy, ray_batch), rows=8)
    for a, b in zip(brless_case[1][:2], lab[:2]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.fixture(scope="module")
def floor_table():
    """A random table of 17,100 records (one-triangle leaves, so the packer
    takes it), as JAX and port tables, and a flat ox."""
    rs = np.random.RandomState(2)
    n = 17100
    lo = rs.randn(n, 3).astype(np.float32)
    hi = lo + rs.rand(n, 3).astype(np.float32)
    meta = np.stack([rs.randint(0, 1000, n), np.ones(n, np.int64), rs.randint(0, 3, n)], 1)
    ox = rs.randn(2048).astype(np.float32)
    return (jnp.asarray(j_ptrav.pack_nodes(lo, hi, meta)),
            torch.as_tensor(binary.pack_binary_cuda(lo, hi, meta)), ox)


@pytest.mark.parametrize("variant", list(FLOOR_CASES))
def test_floor_bench_matches_jax(variant, jlab, floor_table):
    with_load, with_slab = FLOOR_CASES[variant]
    jtab, tab, ox = floor_table
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        ref = np.asarray(jlab.floor_bench(jtab, jnp.asarray(ox), n_iter=100, with_load=with_load,
                                          with_slab=with_slab, rows=8))
    out = kernel_lab.floor_bench(tab, torch.from_numpy(ox), n_iter=100, with_load=with_load,
                                 with_slab=with_slab, rows=8).numpy()
    assert out.shape == ref.shape == (8, 128) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    if not with_load or with_slab:
        assert (out == 100.0).all()


def test_floor_addresses_follow_the_reference():
    """The node read at iteration i is the last j <= i written at slot
    (7i+3) % 32 (0 before any), and its record address mixes the block of
    node % 17000 with the lane of node."""
    n_iter = 300
    stack = [0] * 32
    want = []
    for i in range(n_iter):
        stack[i % 32] = i
        want.append(stack[(7 * i + 3) % 32])
    assert kernel_lab.floor_nodes(n_iter).tolist() == want
    node = torch.tensor([0, 127, 128, 16999, 17000, 17100, 33999])
    assert kernel_lab.floor_addr(node).tolist() == [0, 127, 128, 16999, 104, 76, 16975]
    assert kernel_lab.FLOOR_MIN_NODES == 17024


@pytest.mark.parametrize("variant", list(FLOOR_CASES))
def test_floor_bench_takes_a_cluster_on_the_cpu(variant, floor_table):
    """floor_bench checks a forced cluster on the CPU as the traversals do
    (a geometry no block can hold raises) and returns the same tensor for
    every cluster that a packet of `rows` can have."""
    with_load, with_slab = FLOOR_CASES[variant]
    _, tab, ox = floor_table
    ox = torch.from_numpy(np.tile(ox, 2))  # 4,096 lanes: rows 32
    kw = dict(n_iter=60, with_load=with_load, with_slab=with_slab)
    allowed = 0
    for rows in kernel_lab.ROWS:
        ref = kernel_lab.floor_bench_plain(tab, ox, rows=rows, **kw)
        for cluster in (None, 1, 2, 3, 4, 8, 16):
            try:
                kernel_lab.launch_geometry(rows, cluster)
            except ValueError:
                with pytest.raises(ValueError, match="cluster"):
                    kernel_lab.floor_bench(tab, ox, rows=rows, cluster=cluster, **kw)
                continue
            allowed += 1
            assert torch.equal(kernel_lab.floor_bench(tab, ox, rows=rows, cluster=cluster, **kw),
                               ref)
    assert allowed == len(kernel_lab.ROWS) + 17


def test_floor_chain_adds_the_pieces_on_each_chain():
    """Stack only: the write and the barrier; +load: the read, the record
    load, the publication and its barrier; +slab: the read, the load, the
    publication and the vote. The probe measures the card: CPU tensors
    raise."""
    pieces = dict(zip(kernel_lab.FLOOR_PIECES, (50.0, 30.0, 29.0, 260.0, 90.0, 700.0, 40.0,
                                                500.0, 600.0)))
    assert len(pieces) == len(kernel_lab.FLOOR_PIECES)
    assert kernel_lab.floor_chain(pieces) == {"stack only": 50.0, "+load": 379.0,
                                              "+slab": 989.0}
    with pytest.raises(ValueError, match="card"):
        kernel_lab.floor_cycles(torch.zeros(17100, 8))
    assert [kernel_lab.launch_geometry(*g) for g in kernel_lab.FLOOR_GEOMETRIES.values()] == [
        (8, 512), (1, 512), (8, 64)]


def test_floor_bench_refuses_a_small_table(floor_table):
    _, tab, ox = floor_table
    with pytest.raises(ValueError, match="17023"):
        kernel_lab.floor_bench(tab[:17023].contiguous(), torch.from_numpy(ox), n_iter=10)


def test_wrappers_check_their_arguments(tables, ray_batch):
    o, d, t_max = map(torch.from_numpy, ray_batch)
    with pytest.raises(ValueError, match="rows"):
        kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=12)
    with pytest.raises(ValueError, match="k_pop"):
        kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=8, k_pop=5)
    with pytest.raises(ValueError, match="leaf_mode"):
        kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=8, leaf_mode="all")
    with pytest.raises(ValueError, match="rows"):
        kernel_lab.brless_traverse(*tables[1], o, d, t_max, rows=64)


@pytest.mark.parametrize("k_pop", [1, 2, 3, 4])
def test_lab_traverse_pads_and_runs_on_the_cpu(k_pop, tables, ray_batch):
    """An odd ray count is padded to whole packets as the reference pads;
    the k_pop walks find the same hits; the CPU path launches nothing."""
    R = 1500
    o, d, t_max = (torch.from_numpy(x[:R]) for x in ray_batch)
    before = dict(kernel_launch.n_launches)
    t, prim, cnt, cnt2 = kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=4, k_pop=k_pop,
                                                 count=True)
    assert dict(kernel_launch.n_launches) == before
    assert t.shape == (12, 128)  # 1500 -> 3 packets of 512 lanes
    assert (prim.reshape(-1)[R:] == -1).all() and (t.reshape(-1)[R:] == -1.0).all()
    ref = kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=4)
    assert torch.equal(prim, ref[1]) and torch.equal(t, ref[0])
    assert (cnt.reshape(3, 512) == cnt.reshape(3, 512)[:, :1]).all()


def test_packet_sign_sums_in_the_kernel_order():
    """Per-thread sums in lane order, then a halving tree: for rows=16 the
    1,024 threads each add lanes t and t+1024 first."""
    rs = np.random.RandomState(4)
    d = torch.as_tensor(rs.randn(3, 2048, 3).astype(np.float32))
    s = (d[:, :1024] + d[:, 1024:]).numpy().astype(np.float32)
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = (s[:, :h] + s[:, h:]).astype(np.float32)
    assert torch.equal(kernel_lab.packet_neg(d, 16), torch.as_tensor(s[:, 0] < 0))
    pad = torch.ones(1, 1024, 3)  # padding lanes vote with d = 1
    assert not kernel_lab.packet_neg(torch.cat([-1e-3 * pad, pad], 1), 16).any()


@pytest.mark.parametrize("k_pop", [1, 2, 4])
def test_k_pop_walk_refuses_to_overflow_its_stack(k_pop):
    """On a widening tree of depth 22 the 1- and 2-pop walks and brless fit
    the 64-entry stack; the 4-pop walk would pass it and raises."""
    o, d, t_max = (torch.as_tensor(x) for x in bench_scene.widening_tree_rays(1024))
    tri, db = bench_scene.build_widening_tree(20)
    assert binary.tree_depth(db.node_meta) == 22
    nodes = torch.as_tensor(binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta))
    tris = torch.as_tensor(tri)
    if k_pop == 4:
        with pytest.raises(kernel_lab.StackOverflow, match="k_pop=4"):
            kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=4)
        return
    t, prim, cnt, _ = kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=k_pop,
                                              count=True)
    assert (prim >= 0).all()
    assert int(cnt[0, 0]) >= db.n_nodes  # every node visited
    bt, bprim, _, _ = kernel_lab.brless_traverse(nodes, tris, o, d, t_max, rows=8)
    assert torch.equal(bprim, prim) and torch.equal(bt, t)


@pytest.fixture(scope="module")
def classes(jlab, small_scene):
    """ray_classes of both labs at R = 2,048 on a 32x24 camera."""
    sc, dbvh = small_scene
    eye, target, up = (0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)
    jcam = j_camera.make_perspective(j_xf.look_at(eye, target, up), fov=50.0, width=32,
                                     height=24)
    ref = jlab.ray_classes(sc, dbvh, jcam, R=2048)
    psc, pbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    cam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=32, height=24)
    port = kernel_lab.ray_classes(psc, pbvh, cam, R=2048, device="cpu")
    return ref, port


@pytest.mark.parametrize("cls", ["camera", "bounce", "shadow"])
def test_ray_classes_match_jax(cls, classes):
    """Same draws, same sorted order, rays within 1e-6. The two cameras'
    directions differ by up to 2e-7, which a hit point carries over its
    distance (under 20 here): origins from hits within 1e-6 per unit."""
    ref, port = classes
    o, d, t = (x.numpy() for x in port[cls])
    jo, jd, jt = ref[cls]
    assert o.shape == (2048, 3) and t.shape == (2048,) and o.dtype == np.float32
    if cls == "bounce":  # directions straight from the shared draws: same order
        np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(t > 0, jt > 0)
    np.testing.assert_allclose(o, jo, atol=1e-6 if cls == "camera" else 2e-5, rtol=0)
    np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t, jt, atol=0, rtol=1e-6)
    if cls != "camera":
        assert 0.2 < float((t > 0).mean()) < 1.0


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab.main(["--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_lab_builds_its_own_tables(small_scene, tables):
    """kernel_lab.lab_tables: the 32-byte node records and (N, 3, 3) vertex
    triangles of the lab (not the traversal backends' tables), the same
    bits as the tables these tests hand the lab."""
    sc, dbvh = small_scene
    psc, pbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    nodes, tris = kernel_lab.lab_tables(psc, pbvh, "cpu")
    assert nodes.shape == (dbvh.n_nodes, 8) and tris.shape == (len(sc.tri_p), 3, 3)
    for a, b in zip((nodes, tris), tables[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n_packets", [1, 16, 64, 132, 600])
@pytest.mark.parametrize("rows", kernel_lab.ROWS)
def test_launch_geometry_covers_every_lane_once(rows, n_packets):
    """A packet is a cluster of C blocks (a power of two, at most 8, at
    most rows*128/32: no block under a warp's lanes) of `threads` threads
    with one lane each (threads x 1 x C = rows*128); the n_packets x C
    blocks hold every lane of the batch exactly once, in the kernel's
    mapping (packet, block rank, thread); C is the most blocks of at least
    a warp."""
    C, T = kernel_lab.launch_geometry(rows)
    P = rows * 128
    assert C in (1, 2, 4, 8) and C <= P // 32 and (C == 8 or P // (2 * C) < 32)
    assert T * 1 * C == P and 32 <= T <= 512 and T % 32 == 0
    lanes = np.zeros(n_packets * P, np.int64)
    for packet in range(n_packets):
        for rank in range(C):
            lanes[packet * P + rank * T + np.arange(T)] += 1
    assert (lanes == 1).all()


def test_launch_geometry_refuses_what_no_kernel_runs():
    assert [kernel_lab.launch_geometry(r) for r in kernel_lab.ROWS] == [
        (4, 32), (8, 32), (8, 64), (8, 128), (8, 256), (8, 512)]
    assert kernel_lab.launch_geometry(8, cluster=2) == (2, 512)
    assert kernel_lab.launch_geometry(4, cluster=1) == (1, 512)
    for rows, cluster in ((32, 4), (16, 2), (8, 1), (1, 8), (8, 3), (8, 16)):
        with pytest.raises(ValueError, match="cluster"):
            kernel_lab.launch_geometry(rows, cluster)
    with pytest.raises(ValueError, match="rows"):
        kernel_lab.launch_geometry(12)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_every_block_sums_the_packet_in_the_kernel_order(cluster):
    """Each block of a packet's cluster sums the whole packet's d as the
    kernel's prologue does: its threads take the old min(rows*128, 1024)
    virtual threads vt = tid, tid + T, ..., each summing its lanes in lane
    order, then the halving tree with the same loop. Every block gets
    packet_neg's signs, bit for bit."""
    rs = np.random.RandomState(5)
    for rows in kernel_lab.ROWS:
        P = rows * 128
        try:
            C, T = kernel_lab.launch_geometry(rows, cluster)
        except ValueError:
            continue
        d = rs.randn(2, P, 3).astype(np.float32) * rs.choice([1e-3, 1.0, 1e3], (2, P, 1))
        d = d.astype(np.float32)
        want = kernel_lab.packet_neg(torch.as_tensor(d), rows).numpy()
        V = min(P, 1024)
        for p in range(2):
            for _rank in range(C):  # every block repeats the same sums
                red = np.zeros((V, 3), np.float32)
                for tid in range(T):
                    for vt in range(tid, V, T):
                        s = d[p, vt].copy()
                        for i in range(1, P // V):
                            s = (s + d[p, vt + i * V]).astype(np.float32)
                        red[vt] = s
                h = V // 2
                while h:
                    for tid in range(T):
                        for vt in range(tid, h, T):
                            red[vt] = (red[vt] + red[vt + h]).astype(np.float32)
                    h //= 2
                np.testing.assert_array_equal(red[0] < 0, want[p])


def test_forced_cluster_is_checked_on_the_cpu(tables, ray_batch):
    """The plain walk takes no geometry: a forced cluster that a packet of
    `rows` can have gives the same result; one it cannot raises."""
    o, d, t_max = map(torch.from_numpy, ray_batch)
    ref = kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=8, count=True)
    out = kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=8, count=True, cluster=2)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="cluster"):
        kernel_lab.lab_traverse(*tables[1], o, d, t_max, rows=32, cluster=4)
    with pytest.raises(ValueError, match="cluster"):
        kernel_lab.brless_traverse(*tables[1], o, d, t_max, rows=8, cluster=3)


def test_source_specs_and_variants():
    assert kernel_lab.parse_source("pr7=build/ab/kernel_lab.cu:block") == (
        "pr7", "build/ab/kernel_lab.cu", "block")
    assert kernel_lab.parse_source("pr8=build/ab/pr8.cu:floor-block") == (
        "pr8", "build/ab/pr8.cu", "floor-block")
    assert kernel_lab.parse_source("tree=nn_bvh_tpu_torch/csrc/kernel_lab.cu") == (
        "tree", "nn_bvh_tpu_torch/csrc/kernel_lab.cu", "")
    with pytest.raises(ValueError, match="signature"):
        kernel_lab.parse_source("x=a.cu:cluster")
    kinds = [k for k, _ in kernel_lab.VARIANTS.values()]
    assert kinds.count("lab_traverse") == 7 and kinds.count("brless_traverse") == 2
    assert all(kw["rows"] in kernel_lab.ROWS for _, kw in kernel_lab.VARIANTS.values())
