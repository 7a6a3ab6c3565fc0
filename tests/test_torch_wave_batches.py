"""The measurement helpers of nn_bvh_tpu_torch/tools/bench_scene.py on the
CPU: the traversal batches of one bench wave (`wave_batches`), the per-warp
work of a batch (`warp_work`), the kernels' hit contract (`check_hits`), a
call's bound (`traversal_bound`) with the table records the plain walks
count, the ptxas report helpers of nn_bvh_tpu_torch/kernels.py, and the
timing helpers, which need a card and must raise without one.

The wave runs on a reduced bench scene (6 coarse spheres, 1,348 triangles) at
32x24 through the plain traversal: the batches must come in the integrator's
order (camera closest, then shadow any-hit and bounce closest per depth),
and recording them must not change the film by a bit.
"""

import types

import numpy as np
import pytest
import torch

from nn_bvh_tpu_torch import accel, kernels
from nn_bvh_tpu_torch.accel import bvh8, dispatch, traverse
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene, transform
from nn_bvh_tpu_torch.tools import bench_scene as bs
from nn_bvh_tpu_torch.wavefront import camera, integrator

torch.set_num_threads(1)


def _small_bench():
    rs = np.random.RandomState(42)
    b = scene.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        b.add_sphere(c, 0.25 + 0.45 * rs.rand(), metal if i % 3 == 0 else diffuse,
                     n_theta=8, n_phi=16)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera.make_perspective(transform.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)),
                                  fov=50.0, width=32, height=24)
    return sc, dbvh, cam


@pytest.fixture(scope="module")
def small_bench():
    return _small_bench()


@pytest.fixture(scope="module")
def batches(small_bench):
    return bs.wave_batches(*small_bench, "cpu")


def test_wave_batches_order(small_bench, batches):
    R = 32 * 24
    assert len(batches) == 2 * bs.BENCH_DEPTH + 1
    assert [b[3] for b in batches] == [False] + [True, False] * bs.BENCH_DEPTH
    assert bs.wave_batch_names(batches)[:3] == ["camera closest", "shadow d0 any",
                                                "bounce d1 closest"]
    assert bs.wave_batch_names(batches)[-1] == "bounce d4 closest"
    for o, d, t_max, _ in batches:
        assert o.shape == d.shape == (R, 3) and t_max.shape == (R,)
        assert o.dtype == d.dtype == t_max.dtype == torch.float32
    # the first batch is the camera rays of sample 0, every lane live
    sc, dbvh, cam = small_bench
    pix = torch.arange(R, dtype=torch.int32)
    sid = torch.zeros(R, dtype=torch.int32)
    scfg = bs.bench_config()[1]
    u_pix = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_PIXEL), -1)
    u_lens = torch.stack(samplers.get_2d(scfg, pix, sid, integrator.DIM_LENS), -1)
    o, d = camera.generate_rays(cam, pix, u_pix, u_lens)
    assert torch.equal(batches[0][0], o) and torch.equal(batches[0][1], d)
    assert bool((batches[0][2] == 1e30).all())
    # later batches carry dead lanes
    assert bool((batches[2][2] < 0).any())


def test_recording_leaves_film_bit_equal(small_bench):
    sc, dbvh, cam = small_bench
    isect = dispatch.make_intersectors(sc, dbvh, "cpu")
    rec = bs.RecordingIntersectors(isect)
    plain = bs.bench_wave(sc, dbvh, cam, isect)
    recorded = bs.bench_wave(sc, dbvh, cam, rec)
    assert torch.equal(plain.xyz, recorded.xyz)
    assert len(rec.batches) == rec.n_calls == isect.n_calls == 2 * bs.BENCH_DEPTH + 1
    assert float(plain.xyz.mean()) > 0


def test_recorded_batches_replay(small_bench, batches):
    """Each batch traverses as it did inside the wave (the recording is a
    copy, not a view the integrator changed afterwards)."""
    sc, dbvh, _ = small_bench
    isect = dispatch.make_intersectors(sc, dbvh, "cpu")
    o, d, t_max, _ = batches[0]
    hit = isect.closest(o, d, t_max)
    assert float((hit.prim >= 0).float().mean()) > 0.5
    o, d, t_max, any_hit = batches[1]
    occ = isect.any_hit(o, d, t_max)
    assert any_hit and bool(occ[t_max < 0].all())


def test_warp_work_hand_made():
    # 40 lanes: warp 0 = lanes 0-31, warp 1 = lanes 32-39 (padded)
    nodes = np.zeros(40, np.int64)
    tris = np.zeros(40, np.int64)
    nodes[:4] = [1, 2, 3, 10]      # live lanes of warp 0
    tris[:4] = [0, 4, 1, 8]
    nodes[32:34] = [5, 1]          # live lanes of warp 1
    tris[32:34] = [2, 30]
    counts = {"slab": torch.as_tensor(nodes * 4), "tri": torch.as_tensor(tris)}
    w = bs.warp_work(counts)
    assert w["lanes"] == 40 and w["live"] == 6
    assert w["nodes_mean"] == pytest.approx(22 / 6) and w["nodes_max"] == 10
    assert w["tris_mean"] == pytest.approx(45 / 6) and w["tris_max"] == 30
    assert w["nodes_p99"] == 10 and w["tris_p99"] == 30
    assert w["warp_nodes"] == pytest.approx((10 + 5) / 2)
    assert w["warp_tris"] == pytest.approx((8 + 30) / 2)
    # width 1: one box test per node visit
    assert bs.warp_work(counts, width=1)["nodes_max"] == 40
    dead = bs.warp_work({"slab": torch.zeros(64, dtype=torch.int64),
                         "tri": torch.zeros(64, dtype=torch.int64)})
    assert dead["live"] == 0 and dead["warp_nodes"] == 0.0


def test_warp_work_of_a_wave_batch(small_bench, batches):
    sc, dbvh, _ = small_bench
    isect = dispatch.make_intersectors(sc, dbvh, "cpu")
    o, d, t_max, any_hit = batches[2]
    counts = {}
    isect.fn(*isect.tables, o, d, t_max, any_hit, counts=counts)
    w = bs.warp_work(counts)
    assert w["live"] == int((t_max > 0).sum())
    assert 1 <= w["nodes_mean"] <= w["nodes_p99"] <= w["nodes_max"]
    assert w["nodes_mean"] <= w["warp_nodes"] <= w["nodes_max"]
    assert w["tris_mean"] <= w["warp_tris"] <= w["tris_max"]


def _hit(t, prim, b1=None, b2=None):
    t = torch.tensor(t, dtype=torch.float32)
    z = torch.zeros_like(t)
    return traverse.Hit(t=t, prim=torch.tensor(prim, dtype=torch.int32),
                        b1=z if b1 is None else torch.tensor(b1), b2=z if b2 is None
                        else torch.tensor(b2))


def test_check_hits_contract():
    inf = float("inf")
    t_max = torch.tensor([1e30, 1e30, 1e30, -1.0])
    ref = _hit([1.0, 2.0, inf, inf], [3, 5, -1, -1], [0.1, 0.2, 0, 0], [0.3, 0.4, 0, 0])
    assert bs.check_hits(ref, ref, t_max, False, "same") == 0
    tie = _hit([1.0, 2.0, inf, inf], [3, 6, -1, -1], [0.1, 0.7, 0, 0], [0.3, 0.1, 0, 0])
    assert bs.check_hits(tie, ref, t_max, False, "tie") == 1
    bad_t = _hit([1.0, 2.0000002, inf, inf], [3, 5, -1, -1], [0.1, 0.2, 0, 0], [0.3, 0.4, 0, 0])
    with pytest.raises(AssertionError, match="t differs"):
        bs.check_hits(bad_t, ref, t_max, False, "t")
    bad_b = _hit([1.0, 2.0, inf, inf], [3, 5, -1, -1], [0.1, 0.25, 0, 0], [0.3, 0.4, 0, 0])
    with pytest.raises(AssertionError, match="b1 / b2"):
        bs.check_hits(bad_b, ref, t_max, False, "b")
    occ = torch.tensor([True, False, False, True])
    assert bs.check_hits(occ, occ.clone(), t_max, True, "any") == 0
    with pytest.raises(AssertionError, match="occlusion"):
        bs.check_hits(~occ, occ, t_max, True, "any")


def test_cold_device_ms_raises_without_card(monkeypatch):
    """The L2-flushed reading, like the warm one, needs a card: nothing is
    timed on the host instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        bs.device_ms(lambda: calls.append(1), cold=True)
    assert not calls


@pytest.mark.parametrize("fn", ["device_ms", "host_us", "profiler_us"])
def test_timing_raises_without_card(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(bs, fn)(lambda: calls.append(1))
    assert not calls  # nothing was timed on the host instead


def test_device_event_us_counts_each_kernel_once():
    # a host op whose device time is its kernel's, the kernel, a copy
    ev = lambda name, dev, t0, t1: types.SimpleNamespace(
        name=name, device_type=types.SimpleNamespace(name=dev),
        time_range=types.SimpleNamespace(elapsed_us=lambda: t1 - t0))
    events = [ev("aten::mm", "CPU", 0.0, 50.0), ev("sm90_sgemm_traverse", "CUDA", 10.0, 40.0),
              ev("Memcpy HtoD", "CUDA", 40.0, 45.0)]
    assert bs.device_event_us(events) == 35.0
    assert bs.device_event_us(events, "traverse") == 30.0


def test_traversal_bound_charges_records_read():
    # 3 lanes, one dead; 2 node records of 128 bytes and 5 triangles read
    counts = {"slab": torch.tensor([8, 4, 0]), "tri": torch.tensor([3, 2, 0]),
              "node_records": 2, "tri_records": 5}
    nodes = torch.zeros((10, 4, 8))
    t_max = torch.tensor([1e30, 1e30, -1.0])
    ms, by, work = bs.traversal_bound(counts, t_max, False, nodes)
    assert work["ray_bytes"] == 2 * 24 + 3 * 4 + 3 * 16
    assert work["table_bytes"] == 2 * 128 + 5 * bs.TRI_BYTES
    assert work["flops"] == 12 * bs.FLOPS_SLAB + 5 * bs.FLOPS_TRI
    assert by == "bytes"
    assert ms == pytest.approx((work["ray_bytes"] + work["table_bytes"]) / bs.PEAK_BYTES * 1e3)
    # any-hit: a lane with t_max = 0 is live, only prim is written
    _, _, work = bs.traversal_bound(counts, torch.tensor([0.0, 1e30, -1.0]), True, nodes)
    assert work["ray_bytes"] == 2 * 24 + 3 * 4 + 3 * 4


@pytest.mark.parametrize("backend,width", [("plain", 4), ("plain_binary", 2),
                                           ("plain_bvh8", 8)])
def test_plain_walk_counts_records_read(small_bench, batches, backend, width):
    """A single ray visits a node and tests a triangle at most once, so its
    distinct records equal its tests; a batch reads at most every record and
    no more than its tests; a batch of dead lanes reads nothing."""
    sc, dbvh, _ = small_bench
    isect = dispatch.make_intersectors(sc, dbvh, "cpu", backend=backend)
    nodes, tris = isect.tables
    o, d, t_max, any_hit = batches[2]
    hit_lane = int(torch.nonzero(t_max > 0)[0])
    for any_hit in (False, True):
        counts = {}
        isect.fn(nodes, tris, o[hit_lane:hit_lane + 1], d[hit_lane:hit_lane + 1],
                 t_max[hit_lane:hit_lane + 1], any_hit, counts=counts)
        assert counts["node_records"] == int(counts["slab"].sum()) // width > 0
        assert counts["tri_records"] == int(counts["tri"].sum())
        counts = {}
        isect.fn(nodes, tris, o, d, t_max, any_hit, counts=counts)
        assert 0 < counts["node_records"] <= min(nodes.shape[0],
                                                 int(counts["slab"].sum()) // width)
        assert 0 < counts["tri_records"] <= min(tris.shape[0], int(counts["tri"].sum()))
        counts = {}
        isect.fn(nodes, tris, o, d, torch.full_like(t_max, -1.0), any_hit, counts=counts)
        assert counts["node_records"] == counts["tri_records"] == 0


def test_ptxas_report_helpers():
    log = ("ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z6kernelv\n"
           "    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 55 registers, used 0 barriers, 256 bytes cumulative stack size\n")
    assert len(kernels.ptxas_lines(log)) == 3
    assert kernels.spill_bytes(log) == 0
    spilled = log.replace("0 bytes spill stores, 0 bytes spill loads",
                          "8 bytes spill stores, 12 bytes spill loads")
    assert kernels.spill_bytes(log + spilled) == 20
    with pytest.raises(ValueError, match="no spill lines"):
        kernels.spill_bytes("nvcc: nothing to report")


def test_ab_tool_specs():
    from nn_bvh_tpu_torch.tools import bvh4_ab

    assert bvh4_ab.parse_spec("pr2=build/x.cu:binary_traverse:binary32/33") == (
        "pr2", "build/x.cu", "binary_traverse", "binary32/33")
    assert bvh4_ab.parse_spec("t=a.cu") == ("t", "a.cu", "bvh4_traverse", "bvh4")
    assert bvh4_ab.parse_spec("t=a.cu:binary_traverse_deep") == (
        "t", "a.cu", "binary_traverse_deep", "binary")
    assert bvh4_ab.parse_spec("t=a.cu:bvh8_traverse")[3] == "bvh8"
    assert bvh4_ab.parse_spec("pr2=b.cu:bvh8_traverse:bvh8/33")[3] == "bvh8/33"
    for bad in ("t=a.cu:bvh4_traverse:binary64", "t=a.cu:bvh4_traverse:bvh4/34"):
        with pytest.raises(ValueError, match="layout"):
            bvh4_ab.parse_spec(bad)


@pytest.mark.parametrize("layout,node_shape,tri_shape,backend", [
    ("bvh4", (4, 8), (3, 4), "cuda_bvh4"), ("bvh4/33", (4, 8), (3, 3), None),
    ("bvh8/33", (8, 8), (3, 3), None), ("binary", (16,), (3, 4), "plain_binary"),
    ("binary32/33", (8,), (3, 3), None), ("binary32", (8,), (3, 4), None),
    ("bvh8", (8, 8), (3, 4), "plain_bvh8")])
def test_ab_tool_layout_tables(small_bench, layout, node_shape, tri_shape, backend):
    """Each table layout the A/B tool names: its shapes, and the backend's
    own tables where one reads it."""
    from nn_bvh_tpu_torch.tools import bvh4_ab

    sc, dbvh, _ = small_bench
    nodes, tris = bvh4_ab.layout_tables(layout, sc, dbvh, "cpu")
    assert tuple(nodes.shape[1:]) == node_shape and tuple(tris.shape[1:]) == tri_shape
    bits = lambda x: torch.as_tensor(x).view(torch.int32)  # entries may read as NaN
    if backend == "cuda_bvh4":
        assert torch.equal(bits(nodes), bits(dispatch._node_table("bvh4", dbvh)))
    elif backend:
        for a, b in zip((nodes, tris), dispatch.make_intersectors(sc, dbvh, "cpu",
                                                                  backend=backend).tables):
            assert torch.equal(bits(a), bits(b))
    if layout == "bvh8/33":  # the collapse's own leaf entries
        ref = dispatch._node_table("bvh8", dbvh)
        assert torch.equal(nodes[..., :6], torch.as_tensor(ref[..., :6]))
        n = dbvh.n_nodes
        wm = bvh8.collapse_bvh8(*(np.asarray(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi,
                                                               dbvh.node_meta)))[2]
        assert torch.equal(bits(nodes[..., 6]), torch.as_tensor(wm.astype(np.int32)))


def test_ab_tool_needs_a_card(monkeypatch, capsys):
    from nn_bvh_tpu_torch.tools import bvh4_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bvh4_ab.main(["t=nn_bvh_tpu_torch/csrc/binary_traverse.cu:binary_traverse"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
