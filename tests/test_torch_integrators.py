"""The port's integrator options and simple integrators against the JAX
package on the CPU: MLT's TABLE sampler, the reconstruction filters,
RandomWalk, AO, `sample_lights=False`, the stats counters of Path and
VolPath and `render_pixel_stats`, and the re-sort of a wave whose lanes
carry their own sample indices. The scene (`emitter_scene`) is
tests/test_torch_render.py's reduced bench scene (1,348 triangles), its
emissive quad black, a pure emitter, built by the JAX package and carried
across with `scene_from_numpy`, 16x16, depth 3. A path that hits the quad
samples the quad's own light from a point on its plane: a spherical
triangle of no solid angle, whose pdf and direction are float noise in
both packages (a reference fault, ROADMAP queue 3). With the floor's
material on the quad that noise moved three of 256 VolPath lanes here by
up to 2.4; black, the quad reflects nothing, so the noise reaches no
radiance, but it still decides whether such a lane counts a shadow ray.

Tolerances: the TABLE sampler bit for bit; filters: evaluate_np and
evaluate within atol 1e-6 + rtol 1e-6 (float32 ops in another order);
sample's offsets within atol 2e-5 and its weights f / pdf within rtol 1e-3
(the sampling table's float32 sums round in another order, an offset moves
by a cdf difference times the bin count, and a weight by f's slope times
that: up to 5e-4 relative on mitchell's and lanczos' negative lobes);
wavelengths within rtol 1e-6; per-lane L of a wave: mean within 0.5% and
>= 99% of lanes within atol 1e-3 + rtol 1e-2, tests/test_torch_render.py's
rule (the JAX CPU anchor intersects watertight, the port Moller-Trumbore,
so a lane that flips at an edge diverges); film weights and camera-
dependent counters the same rule; stats counters (small integers) equal on
>= 99% of lanes (the shadow-ray counter on >= 98%: the singular light
sample above flips it on three of 256 lanes of one sample) and their
totals within 1%. The re-sort test: the wave with the forced re-sort
equals the unsorted wave lane by lane, bit for bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from functools import partial

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import samplers as j_samplers
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import (camera as j_camera, filters as j_filters,
                                  integrator as j_integrator, volpath as j_volpath)
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.wavefront import camera, film, filters, integrator, volpath

from test_torch_render import EYE, TARGET, UP

torch.set_num_threads(1)

W = H = 16
R = W * H
DEPTH = 3
FILTER_KINDS = ["box", "triangle", "gaussian", "mitchell", "lanczossinc"]


def emitter_scene(mod, extra=None):
    """reduced_bench_scene with a black emissive quad (see the module doc);
    extra(builder) adds more before the build."""
    rs = np.random.RandomState(42)
    b = mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    black = b.add_material("diffuse", reflectance=(0.0, 0.0, 0.0))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=8, n_phi=16)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), black,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    if extra is not None:
        extra(b)
    return b.build()


@pytest.fixture(scope="module")
def setup():
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=W, height=H)
    return sc, dbvh, jcam, tsc, tbvh, tcam


def close_lanes(got, want, frac=0.99):
    """test_torch_render.py's rule on per-lane rows."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert abs(got.mean() - want.mean()) <= 0.005 * max(abs(want.mean()), 1e-6)
    ok = np.isclose(got, want, atol=1e-3, rtol=1e-2).reshape(got.shape[0], -1).all(-1)
    assert ok.mean() >= frac, ok.mean()


def counters_agree(got, want):
    """[bounces, shadow rays, hits, RR terminations] per lane or pixel."""
    got, want = np.asarray(got), np.asarray(want)
    same = got == want
    assert same[:, [0, 2, 3]].all(-1).mean() >= 0.99, (~same).any(-1).mean()
    assert same[:, 1].mean() >= 0.98, (~same[:, 1]).mean()
    np.testing.assert_allclose(got.sum(0), want.sum(0), rtol=0.01, atol=1)


# --- the TABLE sampler ------------------------------------------------------

def test_table_sampler_bit_identical():
    rs = np.random.RandomState(3)
    table = rs.rand(64, 12).astype(np.float32)
    sample = rs.randint(0, 64, 500).astype(np.int32)
    pixel = rs.randint(0, 1000, 500).astype(np.int32)
    jc = j_samplers.SamplerConfig(j_samplers.TABLE, 0, 4, 8, jnp.asarray(table))
    tc = samplers.SamplerConfig(samplers.TABLE, 0, 4, 8, table=torch.from_numpy(table))
    jp, js = jnp.asarray(pixel), jnp.asarray(sample)
    tp, ts = torch.from_numpy(pixel), torch.from_numpy(sample)
    for dim in (-3, 0, 5, 10, 11, 40):  # dims past either end clip
        np.testing.assert_array_equal(samplers.get_1d(tc, tp, ts, dim).numpy(),
                                      np.asarray(j_samplers.get_1d(jc, jp, js, dim)))
        for a, b in zip(samplers.get_2d(tc, tp, ts, dim), j_samplers.get_2d(jc, jp, js, dim)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    moved = samplers.to_device(tc, "cpu")
    assert moved.table is not None and moved.kind == samplers.TABLE


def test_table_kind_has_no_name():
    with pytest.raises(NotImplementedError, match="TABLE kind is built by wavefront/mlt.py"):
        samplers.make_sampler("table")


# --- filters ------------------------------------------------------------------

@pytest.mark.parametrize("kind", FILTER_KINDS)
def test_filter_evaluate_and_sample(kind):
    jf, tf = j_filters.make_filter(kind), filters.make_filter(kind)
    assert (tf.kind, tf.radius, tf.p0, tf.p1) == (jf.kind, jf.radius, jf.p0, jf.p1)
    assert tf.integral == pytest.approx(jf.integral, rel=1e-12)
    rs = np.random.RandomState(7)
    r = tf.radius[0]
    x, y = (rs.rand(2, 400) * 2.4 - 1.2) * r
    np.testing.assert_allclose(filters.evaluate_np(tf, x, y), j_filters.evaluate_np(jf, x, y),
                               atol=1e-6, rtol=1e-6)
    p = np.stack([x, y], -1).astype(np.float32)
    np.testing.assert_allclose(filters.evaluate(tf, torch.from_numpy(p)).numpy(),
                               np.asarray(j_filters.evaluate(jf, jnp.asarray(p))),
                               atol=1e-6, rtol=1e-6)
    u2 = rs.rand(400, 2).astype(np.float32)
    (to, tw), (jo, jw) = filters.sample(tf, torch.from_numpy(u2)), j_filters.sample(
        jf, jnp.asarray(u2))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-3)


# --- RandomWalk with a filter, sample_lights=False, its counters --------------

def _jax_trace(setup, cfg, fn=j_integrator.trace_wave, sampler="sobol", spp=2):
    sc, dbvh, jcam = setup[:3]
    scfg = j_samplers.make_sampler(sampler, seed=0, spp=spp, width=W)
    trace = jax.jit(partial(fn, sc, dbvh, jcam, scfg, cfg))
    return [np.asarray(x) for x in trace(jnp.arange(R, dtype=jnp.int32), jnp.int32(1))]


def _port_trace(setup, cfg, fn=integrator.trace_wave, sampler="sobol", spp=2):
    _, _, _, tsc, tbvh, tcam = setup
    scfg = samplers.make_sampler(sampler, seed=0, spp=spp, width=W)
    return [x.numpy() for x in fn(tsc, tbvh, tcam, scfg, cfg,
                                  torch.arange(R, dtype=torch.int32), 1)]


@pytest.fixture(scope="module")
def randomwalk(setup):
    kw = dict(max_depth=DEPTH, mis=False, kind="randomwalk", rr_depth=99, sample_lights=False,
              collect_stats=True)
    j = _jax_trace(setup, j_integrator.IntegratorConfig(
        **kw, filt=j_filters.make_filter("gaussian")))
    t = _port_trace(setup, integrator.IntegratorConfig(
        **kw, filt=filters.make_filter("gaussian")))
    return j, t


def test_randomwalk_wave_matches_jax(randomwalk):
    (jL, jlam, _, jfw, _), (tL, tlam, _, tfw, _) = randomwalk
    close_lanes(tL, jL)
    np.testing.assert_allclose(tlam, jlam, rtol=1e-6)
    close_lanes(tfw[:, None], jfw[:, None])  # the gaussian filter's weights
    assert np.ptp(tfw) > 0


def test_randomwalk_counters_without_light_sampling(randomwalk):
    jst, tst = randomwalk[0][4], randomwalk[1][4]
    counters_agree(tst, jst)
    assert tst[:, 1].sum() == 0 and tst[:, 3].sum() == 0  # no NEE, no RR
    assert tst[:, 0].sum() > R and tst[:, 2].sum() > 0


def test_sample_lights_off_drops_nee(setup):
    """Path with sample_lights=False: no shadow ray, and every hit emitter
    weighs 1, so the image changes but stays positive."""
    cfg = integrator.IntegratorConfig(max_depth=DEPTH, rr_depth=2, collect_stats=True)
    on = _port_trace(setup, cfg)
    off = _port_trace(setup, cfg._replace(sample_lights=False))
    assert on[4][:, 1].sum() > 0 and off[4][:, 1].sum() == 0
    np.testing.assert_array_equal(on[4][:, 0], off[4][:, 0])  # the same bounces
    assert off[0].mean() > 0 and not np.allclose(off[0], on[0])


# --- AO ------------------------------------------------------------------------

def test_ao_wave_matches_jax(setup):
    j = _jax_trace(setup, j_integrator.IntegratorConfig(kind="ao", mis=False,
                                                        sample_lights=False, ao_max_dist=2.0),
                   fn=j_integrator.trace_ao)
    t = _port_trace(setup, integrator.IntegratorConfig(kind="ao", mis=False,
                                                       sample_lights=False, ao_max_dist=2.0),
                    fn=integrator.trace_ao)
    close_lanes(t[0], j[0])
    assert 0 < (t[0][:, 0] > 0).mean() < 1  # some lanes occluded within 2, some not


def test_ao_and_randomwalk_through_make_wave_fn(setup):
    """make_wave_fn dispatches kind="ao" to trace_ao and "randomwalk" to
    trace_wave; the film is their samples added with their weights."""
    _, _, _, tsc, tbvh, tcam = setup
    scfg = samplers.make_sampler("sobol", seed=0, spp=2, width=W)
    pix = torch.arange(R, dtype=torch.int32)
    for kind, fn in (("ao", integrator.trace_ao), ("randomwalk", integrator.trace_wave)):
        cfg = integrator.IntegratorConfig(kind=kind, mis=False, sample_lights=False,
                                          max_depth=DEPTH)
        got = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, cfg)(film.make_film(H, W, "cpu"), 1)
        L, lam, lam_pdf, fw = fn(tsc, tbvh, tcam, scfg, cfg, pix, 1)
        want = film.add_samples(film.make_film(H, W, "cpu"), pix, L, lam, lam_pdf,
                                filter_weight=fw, sequential=True)
        np.testing.assert_array_equal(got.xyz.numpy(), want.xyz.numpy())
        assert float(got.xyz.mean()) > 0


# --- stats counters: Path (render_pixel_stats) and VolPath --------------------

def test_render_pixel_stats_matches_jax(setup):
    sc, dbvh, jcam, tsc, tbvh, tcam = setup
    kw = dict(max_depth=DEPTH, mis=True, rr_depth=1)
    jimgs, jtot = j_integrator.render_pixel_stats(sc, dbvh, jcam, spp=2,
                                                  cfg=j_integrator.IntegratorConfig(**kw))
    timgs, ttot = integrator.render_pixel_stats(tsc, tbvh, tcam, spp=2,
                                                cfg=integrator.IntegratorConfig(**kw))
    assert sorted(timgs) == sorted(jimgs) == sorted(integrator.STAT_NAMES)
    stack = lambda imgs: np.stack([imgs[n].reshape(-1) for n in integrator.STAT_NAMES], -1)
    assert all(timgs[n].shape == (H, W) for n in timgs)
    counters_agree(stack(timgs) * 2, stack(jimgs) * 2)
    for k, v in jtot.items():
        assert ttot[k] == pytest.approx(v, rel=0.01, abs=1), k
    assert all(ttot[f"stats/{n}"] > 0 for n in integrator.STAT_NAMES)


def test_volpath_counters_match_jax(setup):
    kw = dict(max_depth=DEPTH, kind="volpath", rr_depth=1, collect_stats=True)
    j = _jax_trace(setup, j_integrator.IntegratorConfig(**kw), fn=j_volpath.trace_wave_vol)
    t = _port_trace(setup, integrator.IntegratorConfig(**kw), fn=volpath.trace_wave_vol)
    close_lanes(t[0], j[0])
    counters_agree(t[4], j[4])
    assert t[4][:, 1].sum() > 0 and t[4][:, 3].sum() > 0


# --- the re-sort with per-lane sample indices -----------------------------------

class SortingPlain(dispatch.Intersectors):
    """The plain traversal under a CUDA backend's name: the Path wave
    re-sorts its lanes each bounce by the backend's name alone."""

    def __init__(self, plain):
        super().__init__(**{**plain.like(), "backend": "cuda_bvh4"})
        self.plain = plain

    def _call(self, o, d, t_max, any_hit):
        self.n_calls += 1
        return self.plain._call(o, d, t_max, any_hit)


def test_resort_carries_per_lane_sample_index(setup):
    """A wave whose lanes have their own sample indices (as MLT's chains
    do), traced unsorted and with the per-bounce re-sort forced: the same
    L on every lane. Before the sample index rode with the lane state, the
    re-sorted lanes drew their samples with other lanes' indices."""
    _, _, _, tsc, tbvh, tcam = setup
    cfg = integrator.IntegratorConfig(max_depth=DEPTH, rr_depth=1)
    scfg = samplers.make_sampler("independent", seed=0, spp=64, width=W)
    pix = torch.arange(R, dtype=torch.int32)
    sidx = torch.from_numpy(np.random.RandomState(5).randint(0, 64, R).astype(np.int32))
    plain = dispatch.make_intersectors(tsc, tbvh, "cpu")
    sorting = SortingPlain(plain)
    want = integrator.trace_wave(tsc, tbvh, tcam, scfg, cfg, pix, sidx, isect=plain)
    got = integrator.trace_wave(tsc, tbvh, tcam, scfg, cfg, pix, sidx, isect=sorting)
    assert sorting.n_calls > DEPTH
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert want[0].numpy().mean() > 0


def test_phased_wave_counts_and_samples_lights_off(setup):
    """VolPath's phased wave (make_wave_fn's choice on a CUDA backend, here
    the plain traversal under a CUDA backend's name) with collect_stats:
    `wave.stats` equal to trace_wave_vol's counters over the plain
    traversal on every pixel, and its film within atol/rtol 1e-5; with
    sample_lights=False no shadow ray is counted."""
    _, _, _, tsc, tbvh, tcam = setup
    scfg = samplers.make_sampler("sobol", seed=0, spp=2, width=W)
    pix = torch.arange(R, dtype=torch.int32)
    plain = dispatch.make_intersectors(tsc, tbvh, "cpu")
    for nee in (True, False):
        cfg = integrator.IntegratorConfig(max_depth=DEPTH, kind="volpath", rr_depth=1,
                                          collect_stats=True, sample_lights=nee)
        wave = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, cfg, isect=SortingPlain(plain))
        got = wave(film.make_film(H, W, "cpu"), 1)
        assert wave.phases and wave.stats.shape == (R, 4)
        L, lam, lam_pdf, fw, st = volpath.trace_wave_vol(tsc, tbvh, tcam, scfg, cfg, pix, 1,
                                                         isect=plain)
        np.testing.assert_array_equal(wave.stats.numpy(), st.numpy())
        want = film.add_samples(film.make_film(H, W, "cpu"), pix, L, lam, lam_pdf,
                                filter_weight=fw, sequential=True)
        np.testing.assert_allclose(got.xyz.numpy(), want.xyz.numpy(), atol=1e-5, rtol=1e-5)
        assert (st[:, 1].sum() > 0) == nee and st[:, 0].sum() > R


def test_light_sample_from_the_emitters_plane_is_singular(setup):
    """A reference fault the port mirrors: next-event estimation from a
    point on an area light's own plane (a path that hit the emitter)
    samples a triangle of no solid angle, and the sample comes back valid
    with a pdf and a direction (in the plane) that are float noise;
    pbrt's Triangle::Sample would return no sample there."""
    from nn_bvh_tpu_torch.scatter import lights

    _, _, _, tsc, _, _ = setup
    types = lights.light_types(tsc)
    lid = torch.tensor([i for i, t in enumerate(types) if t == scene.LIGHT_AREA_TRI][:1] * 64)
    rs = np.random.RandomState(4)
    p = torch.from_numpy(np.stack([rs.uniform(-1.9, 1.9, 64), np.full(64, 6.0),
                                   rs.uniform(-1.9, 1.9, 64)], -1).astype(np.float32))
    lam = torch.full((64, 4), 550.0)
    ls = lights.sample_li(tsc, lights.light_records(tsc), lid, p, lam,
                          torch.from_numpy(rs.rand(64, 2).astype(np.float32)))
    assert bool(ls.valid.all()) and bool((ls.pdf > 0).all())
    # the directions lie in the light's plane (bar the odd lane of pure noise)
    assert float((ls.wi[:, 1].abs() < 1e-3).float().mean()) >= 0.9
