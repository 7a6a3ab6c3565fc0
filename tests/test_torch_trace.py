"""The port's tracing (nn_bvh_tpu_torch/utils/stats.py) and its span sites:
the Path wave's stages and counters, the render entry, render_sharded's
band gather, and the learner's forward, backward and update.

This file imports no JAX, so its `cuda` tests also run on a card:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_trace.py

The CPU tests hold the spans' nesting and units, the counters against the
wave's own per-lane stats, the off switch (the shared null context, no
tensor op, host read or CUDA event beyond the uninstrumented wave's) and
the clock that host spans share with kineto's events.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.dist import multihost, sharding
from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
from nn_bvh_tpu_torch.learn import joint, trainer, treenet
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.utils import stats
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(__file__), "..")
RES = 8
CFG = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=1)

SCENE_SRC = r'''
def make_scene(scene_mod, accel, xf, camera_mod, res):
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0, width=res, height=res)
    return sc, dbvh, cam
'''
exec(SCENE_SRC)


@pytest.fixture(autouse=True)
def tracing_off():
    stats.disable()
    stats.clear()
    yield
    stats.disable()
    stats.clear()


@pytest.fixture(scope="module")
def tiny():
    sc, dbvh, cam = make_scene(scene_mod, accel, xf, camera, RES)
    return dict(sc=sc, dbvh=dbvh, cam=cam, tsc=scene_mod.to_device(sc, "cpu"),
                lst=lightsamplers.build(sc, CFG.light_sampler, "cpu"),
                isect=dispatch.make_intersectors(sc, dbvh, "cpu"),
                scfg=samplers.make_sampler("independent", seed=3, spp=2),
                pix=torch.arange(RES * RES, dtype=torch.int32))


def _wave(t, cfg=CFG, sample=0):
    return integrator.trace_wave(t["tsc"], None, t["cam"], t["scfg"], cfg, t["pix"], sample,
                                 t["lst"], t["isect"])


def test_spans_nest_with_parent_unit_and_attributes():
    stats.enable(cuda=False)
    stats.advance("image")
    stats.set_unit(wave=3, rank=1)
    with stats.span("outer"):
        with stats.span("inner", depth=2):
            pass
        with stats.span("read", sync=True):
            pass
    stats.advance("step")
    with stats.span("later"):
        pass
    got = stats.collect()["spans"]
    assert [s["name"] for s in got] == ["outer", "inner", "read", "later"]
    assert [s["parent"] for s in got] == [-1, 0, 0, -1]
    assert got[1]["depth"] == 2 and got[2]["sync"] and not got[0]["sync"]
    assert (got[0]["image"], got[0]["wave"], got[0]["rank"], got[0]["step"]) == (0, 3, 1, -1)
    assert (got[3]["image"], got[3]["wave"], got[3]["step"]) == (0, None, 0)
    for s in got:
        assert s["t0_ns"] <= s["t1_ns"] and s["device_ms"] is None
    assert got[0]["t0_ns"] <= got[1]["t0_ns"] and got[2]["t1_ns"] <= got[0]["t1_ns"]
    stats.clear()
    assert stats.collect() == {"spans": [], "counters": []}


def test_off_returns_the_shared_null_and_records_nothing():
    assert not stats._on
    a, b = stats.span("x"), stats.span("y", sync=True, depth=1)
    assert a is b is stats._NULL
    with a:
        stats.count("rays/camera rays", torch.ones(4, dtype=torch.bool))
        stats.advance("image")
        stats.set_unit(wave=1)
    assert stats.collect() == {"spans": [], "counters": []}
    stats.enable(cuda=False)
    with pytest.raises(KeyError):
        stats.count("rays/no such counter", 1)


def test_path_image_is_bit_identical_with_tracing_on(tiny):
    kw = dict(spp=2, sampler="independent", seed=5, cfg=CFG, device="cpu")
    off = integrator.render(tiny["sc"], tiny["dbvh"], tiny["cam"], **kw)
    stats.enable(cuda=False)
    on = integrator.render(tiny["sc"], tiny["dbvh"], tiny["cam"], **kw)
    got = stats.collect()["spans"]
    assert torch.equal(off, on)
    names = {s["name"] for s in got}
    # bounce.resort runs on the CUDA backends only
    assert {"image.setup", "image.develop", "wave.tables", "wave.camera", "bounce.emission",
            "bounce.material", "bounce.light", "bounce.bsdf", "wave.tail", "wave.film",
            "sync.alive", "sync.tail", "isect.closest", "isect.any"} <= names
    assert {s["wave"] for s in got if s["name"] == "wave.film"} == {0, 1}
    setup = [s for s in got if s["name"] == "image.setup"]
    assert len(setup) == 1 and setup[0]["wave"] is None and setup[0]["image"] == 0
    by_idx = {i: s for i, s in enumerate(got)}
    for s in got:
        if s["name"].startswith("isect."):
            assert by_idx[s["parent"]]["name"] in ("bounce.emission", "bounce.light",
                                                   "wave.tail")
        if s["name"].startswith("bounce."):
            assert s["parent"] == -1 and s["depth"] in (0, 1, 2)
        if s["name"] == "sync.material_kinds":
            assert by_idx[s["parent"]]["name"] == "wave.tables"


def test_wave_counters_are_the_column_sums_of_its_lane_stats(tiny):
    stats.enable(cuda=False)
    L, _, _, _, st = _wave(tiny, CFG._replace(collect_stats=True))
    col = st.sum(0).tolist()
    c = stats.totals(stats.collect())
    R = RES * RES
    assert c["rays/camera rays"] == R
    assert c["rays/camera rays"] + c["rays/indirect rays"] == col[0]
    assert c["rays/shadow rays"] == col[1] > 0
    assert c["intersections/hits"] == col[2] > 0
    assert c["paths/terminated by RR"] == col[3] > 0
    bounces = c["lanes/processed"] / R
    assert bounces == int(bounces) and 1 <= bounces <= CFG.max_depth
    assert 0 <= c["paths/reached max depth"] <= R
    # the report names every counter
    report = stats.render_report(c)
    assert "lanes" in report and "camera rays" in report and "64" in report


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_adds_no_tensor_op_host_read_or_cuda_event(tiny, monkeypatch):
    """The wave with tracing off makes the same aten ops (host reads among
    them: _local_scalar_dense, is_nonzero) as the wave with every stats
    call made a no-op, creates no CUDA event and records nothing."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created")

    monkeypatch.setattr(torch.cuda, "Event", no_event)

    def log():
        with _OpLog() as m:
            _wave(tiny, sample=1)
        return m.ops

    off = log()
    assert stats._spans == [] and stats._counts == {} and stats._open == []
    with monkeypatch.context() as mp:
        mp.setattr(stats, "span", lambda *a, **k: stats._NULL)
        for fn in ("count", "advance", "set_unit"):
            mp.setattr(stats, fn, lambda *a, **k: None)
        bare = log()
    assert off == bare and len(off) > 100
    assert any("_local_scalar_dense" in o or "is_nonzero" in o for o in off)
    # on, the counters' sums are ops of their own: the log can see them
    stats.enable(cuda=False)
    assert len(log()) > len(off)


def test_span_holds_its_op_on_kinetos_clock():
    from torch.profiler import ProfilerActivity, profile

    stats.enable(cuda=False)
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with stats.span("mm"):
            a @ a
    (s,) = stats.collect()["spans"]
    ops = [e for e in p.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops
    for e in ops:
        assert s["t0_ns"] <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s["t1_ns"]


WORKER = SCENE_SRC + r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.set_num_threads(1)
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.dist import multihost, sharding
from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
from nn_bvh_tpu_torch.utils import stats
from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

assert multihost.initialize(timeout_s=120)
mesh = sharding.make_mesh(device="cpu")
sc, dbvh, cam = make_scene(scene_mod, accel, xf, camera_mod, 8)
cfg = integrator.IntegratorConfig(max_depth=1, mis=True)
stats.enable(cuda=False)
sharding.render_sharded(sc, dbvh, cam, mesh, spp=2, sampler="independent", cfg=cfg)
with open(os.path.join(sys.argv[1], f"spans{mesh.rank}.json"), "w") as f:
    json.dump(stats.collect(), f)
torch.distributed.barrier()
'''


def test_render_sharded_records_the_band_gather_on_each_rank(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = multihost.run_local([sys.executable, str(script), str(tmp_path)], 2, timeout_s=300,
                               env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=REPO)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    for r in range(2):
        got = json.loads((tmp_path / f"spans{r}.json").read_text())
        sp = got["spans"]
        names = [s["name"] for s in sp]
        for n in ("image.setup", "band.to_host", "band.all_gather", "image.develop"):
            assert names.count(n) == 1, (r, n, names)
        assert all(s["rank"] == r and s["image"] == 0 for s in sp)
        to_host = sp[names.index("band.to_host")]
        assert to_host["sync"] and to_host["t1_ns"] <= sp[names.index("band.all_gather")][
            "t0_ns"] <= sp[names.index("image.develop")]["t0_ns"]
        assert {s["wave"] for s in sp if s["name"] == "wave.film"} == {0, 1}
        c = stats.totals(got)
        assert c["rays/camera rays"] == 2 * RES * RES // 2


def _steps(spans):
    top = [s for s in spans if s["parent"] == -1]
    return [(s["name"], s["step"]) for s in top]


def test_train_step_records_forward_backward_update():
    cfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
    state = trainer.make_train_state(cfg, seed=1, device="cpu")
    step = trainer.make_train_step(cfg)
    clouds = torch.rand(2, cfg.pc_size, 9, generator=torch.Generator().manual_seed(0))
    stats.enable(cuda=False)
    for _ in range(2):
        state, m = step(state, clouds)
    assert np.isfinite(float(m["loss"]))
    assert _steps(stats.collect()["spans"]) == [
        ("step.forward", 0), ("step.backward", 0), ("step.update", 0),
        ("step.forward", 1), ("step.backward", 1), ("step.update", 1)]


def test_joint_step_records_its_branches_and_phases(tiny):
    tcfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
    model = trainer.make_train_state(tcfg, seed=2, device="cpu").model
    st = joint.JointState(model, tiny["tsc"].mat_coeffs.detach().clone().requires_grad_(True))
    step = joint.make_joint_step(tcfg, tiny["cam"], tiny["scfg"],
                                 integrator.IntegratorConfig(max_depth=1, mis=True))
    clouds = torch.as_tensor(joint.scene_cloud(tiny["sc"], tcfg.pc_size, batch=2))
    stats.enable(cuda=False)
    st, m = step(st, tiny["tsc"], None, tiny["lst"], clouds, tiny["pix"], 0, tiny["isect"])
    assert float(m["gnorm_mat"]) > 0
    sp = stats.collect()["spans"]
    assert _steps(sp) == [("step.forward", 0), ("step.backward", 0), ("step.update", 0)]
    names = [s["name"] for s in sp]
    fwd = names.index("step.forward")
    for branch in ("joint.render", "joint.tree"):
        assert sp[names.index(branch)]["parent"] == fwd
    render = names.index("joint.render")
    assert sp[names.index("wave.camera")]["parent"] == render
    assert sp[names.index("bounce.emission")]["parent"] == render


def test_cli_stats_prints_the_counters(tmp_path, capsys):
    from nn_bvh_tpu_torch.cli import render as cli

    pbrt = tmp_path / "s.pbrt"
    pbrt.write_text(PBRT)
    cli.main([str(pbrt), "--device", "cpu", "--outfile", str(tmp_path / "o.pfm"), "--stats"])
    err = capsys.readouterr().err
    assert "Statistics:" in err and "camera rays" in err and "lanes" in err
    line = next(ln for ln in err.splitlines() if "camera rays" in ln)
    assert line.split()[-1] == f"{8 * 8 * 2:,}"
    assert not stats._on and stats.collect() == {"spans": [], "counters": []}


PBRT = """LookAt 0 1.5 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8] "string filename" "out.pfm"
Sampler "independent" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 3 -1 1 3 -1 1 3 1 -1 3 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.6 0.4 0.3]
Shape "trianglemesh" "point3 P" [-4 0 -4 4 0 -4 4 0 4 -4 0 4] "integer indices" [0 1 2 0 2 3]
"""


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA events and device activity)")


def _card_scene(res):
    rs = np.random.RandomState(3)
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    for i in range(6):
        c = (rs.rand(3) - 0.5) * 4 + np.array([0, 1.0, 0])
        b.add_sphere(c, 0.3 + 0.3 * rs.rand(), metal if i % 2 else m, n_theta=10, n_phi=20)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=10.0)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera.make_perspective(xf.look_at((0, 2.5, -7), (0, 1, 0), (0, 1, 0)), fov=45.0,
                                  width=res, height=res)
    return sc, dbvh, cam


@pytest.mark.cuda
def test_wave_stage_stretches_add_up_to_the_wave():
    """The wave's top-level spans cover it: what they miss is the host's
    time between one span's exit event and the next one's entry event
    where the stream has run dry (a few tens of us each), so the wave is
    large enough to keep the stream fed, as a rendered frame's is."""
    _need_card()
    dev = torch.device("cuda")
    sc, dbvh, cam = _card_scene(1024)
    cfg = integrator.IntegratorConfig(max_depth=4, rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=1, spp=4)
    wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, device=dev)
    f = wave(film.make_film(cam.height, cam.width, dev), 0)
    torch.cuda.synchronize()
    stats.enable()
    for s in (1, 2):
        stats.clear()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        f = wave(f, s)
        e1.record()
        torch.cuda.synchronize()
        wave_ms = e0.elapsed_time(e1)
        top = [x for x in stats.collect()["spans"] if x["parent"] == -1]
        stages = sum(x["device_ms"] for x in top)
        print(f"wave {s}: {wave_ms:.3f} ms by events, {stages:.3f} ms in {len(top)} stages")
        assert abs(stages - wave_ms) <= 0.01 * wave_ms


@pytest.mark.cuda
def test_span_holds_its_kernel_on_kinetos_clock():
    """A span around one kernel launch and a synchronize holds the
    kernel's device interval on kineto's clock, to 50 us."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device="cuda")
    a @ a
    torch.cuda.synchronize()
    stats.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            with stats.span("mm"):
                a @ a
                torch.cuda.synchronize()
            time.sleep(0.01)
    spans = stats.collect()["spans"]
    kern = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in p.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    assert len(kern) >= 3
    slack = 50_000
    for s in spans:
        inside = [k for k in kern if s["t0_ns"] - slack <= k[0] <= s["t1_ns"] + slack]
        assert inside, (s, kern)
        k0, k1 = inside[0][0], inside[-1][1]
        print(f"span {s['t0_ns']}..{s['t1_ns']}: kernel starts {(k0 - s['t0_ns']) / 1e3:.1f} us "
              f"after, ends {(s['t1_ns'] - k1) / 1e3:.1f} us before its end")
        assert s["t0_ns"] - slack <= k0 and k1 <= s["t1_ns"] + slack
