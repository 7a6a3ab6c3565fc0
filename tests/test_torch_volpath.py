"""The torch port's VolPath (media, the medium-event loop, the phased wave)
against the JAX package on the CPU.

- Media functions against nn_bvh_tpu.scatter.media on inputs drawn with
  numpy from a seed: HG phase value, phase sampling, trilinear density,
  segment bounds, the majorant DDA on a sparse grid, temperature emission,
  the majorant grid (rtol 1e-5 + atol 1e-6; integer state and the majorant
  grid equal).
- The VolPath hash stream: bit-identical to the JAX package's `_rand`
  (volpath.py:98-104: rng.hash_float of pixel, sample, seed, salts).
- Whole images against JAX `integrator.render(kind="volpath")`
  (use_pallas=False, as tests/test_media.py renders) at 16x16, Sobol 4 spp,
  seed 0, with the thresholds of tests/test_torch_render.py: image mean
  within 0.5%, >= 99% of pixels within atol 1e-3 + rtol 1e-2. The scenes
  carry across with `scene_from_numpy`: a homogeneous scattering slab with
  medium emission, a grid slab (tests/test_media.py:82-125), and the
  media-free scene of tests/test_media.py:195, whose VolPath mean must also
  be within 5% of the port's own Path mean (that test's rule, at its 24x24,
  48 spp).
  On the media-free scene the pixel rule is applied to each sample (>= 99%
  of the 1,024 lanes within atol 1e-3 + rtol 1e-2), because rounding
  decides a few samples there: the emissive quad is itself diffuse, and a
  path that bounces onto it samples the light from a point in the light's
  own plane (spherical-triangle sampling of a triangle seen edge-on). 7 of
  the 1,024 samples differ at 16x16, 4 spp, which spoils 4 of 256 pixels;
  the port's Path wave on the same scene spoils 7 of 256 the same way, and
  the JAX package's jitted and eager runs differ on such samples too.
- The port's phased wave against its plain trace on the fog-sphere scene of
  tests/test_phased_wave.py, 24x24, phase_len 2, atol and rtol 1e-5.

One JAX VolPath compile per image fixture (module scope): three in all.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import rng as j_rng
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.scatter import media as j_media
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import media
from nn_bvh_tpu_torch.tools import bench_scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator, volpath

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def both(arr):
    """numpy -> (torch tensor, jnp array) of the same values."""
    return torch.from_numpy(np.ascontiguousarray(arr)), jnp.asarray(arr)


# ---------------------------------------------------------------------------
# media functions
# ---------------------------------------------------------------------------

def media_scene(mod):
    """A homogeneous medium and a sparse grid medium with a temperature grid
    (a dense blob in a mostly empty volume, as test_dda_majorant_sparse_grid
    builds it)."""
    d = np.zeros((32, 32, 32), np.float32)
    d[12:20, 12:20, 12:20] = 8.0
    d += np.random.RandomState(3).rand(32, 32, 32).astype(np.float32) * (d > 0)
    b = mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quad((-9, -9, 9), (9, -9, 9), (9, 9, 9), (-9, 9, 9), m)
    b.add_medium(sigma_a=(0.3, 0.2, 0.1), sigma_s=(0.5, 0.6, 0.7), g=0.4)
    b.add_medium("grid", sigma_a=(1.0, 0.8, 0.6), sigma_s=(0.2, 0.3, 0.4), g=-0.3,
                 density=d, bounds=np.array([[0, 0, 0], [1, 1, 1]], np.float32),
                 temperature=300.0 + 600.0 * d, Le_scale=2.0)
    return b.build()


@pytest.fixture(scope="module")
def med():
    sc = media_scene(j_scene)
    tsc = scene.to_device(media_scene(scene), "cpu")
    jsc = jax.tree.map(jnp.asarray, sc)
    rs = np.random.RandomState(0)
    n = 512
    med_id = rs.randint(0, 2, n).astype(np.int32)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    tm, jm = both(med_id)
    tl, jl = both(lam)
    return dict(sc=jsc, tsc=tsc, rs=rs, n=n, tctx=media.gather_medium(tsc, tm, tl),
                jctx=j_media.gather_medium(jsc, jm, jl), lam=(tl, jl))


def test_media_scene_tables_match_jax():
    a, b = media_scene(j_scene), media_scene(scene)
    for k in scene.CompiledScene._fields:
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            assert np.array_equal(np.asarray(va), np.asarray(vb)), k


def test_bvh_reorder_keeps_medium_interfaces():
    """The port's BVH build reorders the medium columns with the triangles,
    and tri_shade's columns 26-27 follow them."""
    sc, _, _ = bench_scene.build_fog_scene(8, interface=True)
    n = sc.n_tris
    shade = np.asarray(sc.tri_shade)
    assert np.array_equal(shade[:, 26], np.asarray(sc.tri_med_inside, np.float32))
    assert np.array_equal(shade[:, 27], np.asarray(sc.tri_med_outside, np.float32))
    # the fog sphere's triangles are the interfaces (material -1, inside 0)
    assert np.array_equal(shade[:n, 24] < 0, shade[:n, 26] == 0)


def test_majorant_grid_matches_jax():
    rs = np.random.RandomState(1)
    d = rs.rand(40, 24, 33).astype(np.float32) * (rs.rand(40, 24, 33) > 0.7)
    assert np.array_equal(scene.majorant_grid(d), j_scene.majorant_grid(d))
    assert np.array_equal(scene.majorant_grid(d, 5), j_scene.majorant_grid(d, 5))


def test_gather_medium_matches_jax(med):
    for name in ("sigma_a", "sigma_s", "le", "g", "blo", "bhi", "sigma_maj"):
        close(getattr(med["tctx"], name), getattr(med["jctx"], name))
    for name in ("med_type", "grid_id", "temp_grid_id", "valid"):
        assert np.array_equal(getattr(med["tctx"], name).numpy(),
                              np.asarray(getattr(med["jctx"], name))), name


@pytest.mark.parametrize("g", [-0.7, 0.0, 0.4, 0.95])
def test_phase_functions_match_jax(g):
    rs = np.random.RandomState(2)
    n = 2048
    wo = rs.randn(n, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rs.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u2 = rs.rand(n, 2).astype(np.float32)
    gg = np.full(n, g, np.float32)
    (two, jwo), (twi, jwi), (tu, ju), (tg, jg) = map(both, (wo, wi, u2, gg))
    close(media.hg_p(tu[:, 0] * 2 - 1, tg), j_media.hg_p(ju[:, 0] * 2 - 1, jg))
    close(media.phase_p(two, twi, tg), j_media.phase_p(jwo, jwi, jg))
    t_wi, t_pdf = media.phase_sample(two, tu, tg)
    j_wi, j_pdf = j_media.phase_sample(jwo, ju, jg)
    close(t_wi, j_wi, atol=1e-5)
    close(t_pdf, j_pdf, rtol=1e-4)


def test_density_and_segment_bounds_match_jax(med):
    rs, n = med["rs"], med["n"]
    p = rs.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    o = rs.uniform(-2, 3, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_hit = np.where(rs.rand(n) < 0.5, 1e30, rs.uniform(0.1, 5, n)).astype(np.float32)
    (tp, jp), (to, jo), (td, jd), (tt, jt) = map(both, (p, o, d, t_hit))
    dens = media.density(med["tsc"], med["tctx"], tp)
    close(dens, j_media.density(med["sc"], med["jctx"], jp), atol=1e-5)
    grid = med["tctx"].med_type.numpy() == scene.MED_GRID
    assert (dens.numpy()[grid] > 0).any() and (dens.numpy()[grid] == 0).any()
    for a, b in zip(media.segment_bounds(med["tctx"], to, td, tt),
                    j_media.segment_bounds(med["jctx"], jo, jd, jt)):
        close(a, b)


def test_le_at_temperature_matches_jax(med):
    """Temperature emission lane by lane: the JAX le_at converts the
    blackbody peak to one Python float, so it takes one lane a call."""
    rs, n = med["rs"], 64
    p = rs.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    tl, jl = med["lam"]
    out = media.le_at(med["tsc"], med["tctx"]._replace(**{
        k: getattr(med["tctx"], k)[:n] for k in media.MediumCtx._fields}),
        torch.from_numpy(p), tl[:n])
    grid = med["tctx"].med_type.numpy()[:n] == scene.MED_GRID
    assert grid.any() and (out.numpy()[grid].std(-1) > 0).any()
    for i in range(n):
        jctx = jax.tree.map(lambda x: x[i:i + 1], med["jctx"])
        want = j_media.le_at(med["sc"], jctx, jnp.asarray(p[i:i + 1]), jl[i:i + 1])
        close(out[i:i + 1], want, rtol=1e-4)


def test_dda_matches_jax_on_sparse_grid(med):
    """dda_init then dda_advance steps (random lanes crossing) on rays
    through the sparse grid: every state field, integer fields equal."""
    rs, n = med["rs"], med["n"]
    o = rs.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    tgt = rs.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    (to, jo), (td, jd) = both(o), both(d)
    t_big = np.full(n, 10.0, np.float32)
    tt, jt = both(t_big)
    tl, jl = med["lam"]
    tctx = media.gather_medium(med["tsc"], torch.ones(n, dtype=torch.int32), tl)
    jctx = j_media.gather_medium(med["sc"], jnp.ones((n,), jnp.int32), jl)
    t0, t1 = media.segment_bounds(tctx, to, td, tt)
    j0, j1 = j_media.segment_bounds(jctx, jo, jd, jt)
    st = media.dda_init(med["tsc"], tctx, to, td, t0, t1)
    sj = j_media.dda_init(med["sc"], jctx, jo, jd, j0, j1)
    for step in range(12):
        for name in media.DDAState._fields:
            a, b = getattr(st, name), getattr(sj, name)
            if a.dtype == torch.int32:
                assert np.array_equal(a.numpy(), np.asarray(b)), (step, name)
            else:
                close(a, b, rtol=1e-5, atol=1e-5)
        act = rs.rand(n) < 0.7
        st = media.dda_advance(med["tsc"], tctx, st, t1, torch.from_numpy(act))
        sj = j_media.dda_advance(med["sc"], jctx, sj, j1, jnp.asarray(act))
    assert (st.maj_dens.numpy() == 0).any() and (st.maj_dens.numpy() > 8).any()


def test_vol_hash_stream_bit_identical():
    rs = np.random.RandomState(4)
    pix = rs.randint(0, 2 ** 31 - 1, 4096).astype(np.int32)
    sidx = rs.randint(0, 1024, 4096).astype(np.int32)
    ctx = volpath.VolCtx(*([None] * len(volpath.VolCtx._fields)))._replace(
        sampler_cfg=samplers.make_sampler("sobol", seed=77, spp=4))
    for salts in [(0, 11), (3, 5, 101), (99, 63, 404, 3), (7, 31)]:
        t = volpath._rand(ctx, torch.from_numpy(pix), torch.from_numpy(sidx), *salts)
        j = j_rng.hash_float(jnp.asarray(pix), jnp.asarray(sidx), jnp.uint32(77),
                             *[jnp.asarray(s, jnp.uint32) for s in salts])
        assert np.array_equal(t.numpy(), np.asarray(j)), salts


# ---------------------------------------------------------------------------
# whole images against JAX
# ---------------------------------------------------------------------------

RES = 16
SPP = 4
VCFG = dict(kind="volpath", max_depth=5, rr_depth=2)


def slab_scene(mod, grid=False):
    """tests/test_media.py's slab: camera at the origin looking +z, a medium
    between the interface quads at z = 0.5 and 1.5, an emissive wall at
    z = 3; here scattering (albedo 0.6, g 0.3) with medium emission."""
    b = mod.SceneBuilder()
    black = b.add_material("diffuse", reflectance=(0, 0, 0))
    kw = dict(sigma_a=(0.5,) * 3, sigma_s=(0.8,) * 3, Le=(1, 1, 1), Le_scale=1.0, g=0.3)
    if grid:
        rs = np.random.RandomState(5)
        med = b.add_medium("grid", density=0.5 + rs.rand(4, 4, 4).astype(np.float32),
                           bounds=np.array([[-20, -20, 0.5], [20, 20, 1.5]], np.float32),
                           **kw)
    else:
        med = b.add_medium("homogeneous", **kw)
    b.add_quad((-20, -20, 1.5), (20, -20, 1.5), (20, 20, 1.5), (-20, 20, 1.5), -1,
               med_inside=med, med_outside=-1)
    b.add_quad((-20, 20, 0.5), (20, 20, 0.5), (20, -20, 0.5), (-20, -20, 0.5), -1,
               med_inside=med, med_outside=-1)
    b.add_quad((-20, 20, 3.0), (20, 20, 3.0), (20, -20, 3.0), (-20, -20, 3.0), black,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    return b.build(), j_xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), 8.0


def media_free_scene(mod):
    """tests/test_media.py:195's scene."""
    b = mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    return b.build(), j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), 45.0


def render_both(built, res=RES):
    """The same JAX-built scene through both packages' render(kind=volpath)
    -> (JAX image, port image, port scene, port BVH, port camera)."""
    sc, cam_to_world, fov = built
    sc, dbvh, _ = j_accel.build_scene_bvh(sc)
    jcam = j_camera.make_perspective(cam_to_world, fov=fov, width=res, height=res)
    img_j = np.asarray(j_integrator.render(
        sc, dbvh, jcam, spp=SPP, sampler="sobol", seed=0,
        cfg=j_integrator.IntegratorConfig(use_pallas=False, **VCFG)))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(cam_to_world), fov=fov, width=res, height=res)
    img_t = integrator.render(tsc, tbvh, tcam, spp=SPP, sampler="sobol", seed=0,
                              cfg=integrator.IntegratorConfig(**VCFG)).numpy()
    return img_j, img_t, tsc, tbvh, tcam


def assert_images_match(img_j, img_t):
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


@pytest.fixture(scope="module")
def homogeneous_images():
    return render_both(slab_scene(j_scene))


@pytest.fixture(scope="module")
def grid_images():
    return render_both(slab_scene(j_scene, grid=True))


@pytest.fixture(scope="module")
def media_free_lanes():
    """The media-free scene, wave by wave through both packages'
    trace_wave_vol -> (JAX L per lane, port L per lane, JAX image, port
    image, port scene, port BVH, port camera)."""
    from nn_bvh_tpu.core import samplers as j_samplers
    from nn_bvh_tpu.wavefront import film as j_film, volpath as j_volpath

    sc, cam_to_world, fov = media_free_scene(j_scene)
    sc, dbvh, _ = j_accel.build_scene_bvh(sc)
    jcam = j_camera.make_perspective(cam_to_world, fov=fov, width=RES, height=RES)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, **VCFG)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    R = RES * RES
    jpix = jnp.arange(R, dtype=jnp.int32)
    jwave = jax.jit(lambda s: j_volpath.trace_wave_vol(sc, dbvh, jcam, jscfg, jcfg, jpix, s))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(cam_to_world), fov=fov, width=RES, height=RES)
    tscfg = samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    tpix = torch.arange(R, dtype=torch.int32)
    jf, tf = j_film.make_film(RES, RES), film.make_film(RES, RES, "cpu")
    lj, lt = [], []
    for s in range(SPP):
        jout = jwave(jnp.int32(s))
        tout = volpath.trace_wave_vol(tsc, tbvh, tcam, tscfg, integrator.IntegratorConfig(**VCFG),
                                      tpix, s)
        jf = j_film.add_samples(jf, jpix, *jout[:3], filter_weight=jout[3], sequential=True)
        tf = film.add_samples(tf, tpix, *tout[:3], filter_weight=tout[3], sequential=True)
        lj.append(np.asarray(jout[0]))
        lt.append(tout[0].numpy())
    return (np.concatenate(lj), np.concatenate(lt), np.asarray(j_film.develop(jf)),
            film.develop(tf).numpy(), tsc, tbvh, tcam)


def test_homogeneous_slab_matches_jax(homogeneous_images):
    assert_images_match(*homogeneous_images[:2])


def test_grid_slab_matches_jax(grid_images):
    assert_images_match(*grid_images[:2])


def test_media_free_matches_jax_and_path(media_free_lanes):
    lane_j, lane_t, img_j, img_t, tsc, tbvh, _ = media_free_lanes
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    lane_ok = np.isclose(lane_t, lane_j, atol=1e-3, rtol=1e-2).all(-1)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    # test_media.py:195's statistical rule on the port alone: VolPath's mean
    # within 5% of Path's (24x24, independent sampler, seed 3, 48 spp)
    cam = camera.make_perspective(j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)),
                                  fov=45.0, width=24, height=24)
    mean = lambda kind: float(integrator.render(
        tsc, tbvh, cam, spp=48, sampler="independent", seed=3,
        cfg=integrator.IntegratorConfig(kind=kind, max_depth=5)).mean())
    a, v = mean("path"), mean("volpath")
    assert abs(a - v) / a < 0.05, (a, v)


def test_simplevolpath_is_volpath(media_free_lanes):
    """render(kind=simplevolpath) gives VolPath's image (the JAX package
    reads no MIS flag in VolPath)."""
    *_, img_t, tsc, tbvh, tcam = media_free_lanes
    img = integrator.render(tsc, tbvh, tcam, spp=SPP, sampler="sobol", seed=0,
                            cfg=integrator.IntegratorConfig(**dict(VCFG, kind="simplevolpath")))
    np.testing.assert_allclose(img.numpy(), img_t, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the phased wave
# ---------------------------------------------------------------------------

def fog_scene(interface=False):
    """tests/test_phased_wave.py:29-38's scene (bench_scene.build_fog_scene;
    its diffuse sphere is opaque, so no ray reaches the fog inside), or with
    the sphere as a pure medium boundary, so rays scatter in the fog."""
    sc, dbvh, cam = bench_scene.build_fog_scene(24, interface)
    return sc, dbvh, cam


@pytest.mark.parametrize("interface", [False, True], ids=["opaque_sphere", "fog_boundary"])
def test_phased_wave_matches_plain_trace(interface, monkeypatch):
    sc, dbvh, cam = fog_scene(interface)
    scattered = []
    events = volpath.medium_events

    def counted(*a, **kw):
        out = events(*a, **kw)
        scattered.append(int(out[0].sum()))
        return out

    monkeypatch.setattr(volpath, "medium_events", counted)
    cfg = integrator.IntegratorConfig(max_depth=6, kind="volpath", rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=2, width=24)
    img_plain = integrator.render(sc, dbvh, cam, spp=2, cfg=cfg, device="cpu")

    wave = volpath.make_phased_wave(sc, dbvh, cam, scfg, cfg, phase_len=2, device="cpu")
    f = film.make_film(cam.height, cam.width, "cpu")
    for s in range(2):
        f = wave(f, s)
        depths = [p[0] for p in wave.phases]
        assert depths == sorted(depths)
        assert wave.phases[-1][2] == 0 or depths[-1] == cfg.max_depth
    img_ph = film.develop(f)
    assert float(img_ph.mean()) > 0
    np.testing.assert_allclose(img_ph.numpy(), img_plain.numpy(), atol=1e-5, rtol=1e-5)
    # only the boundary sphere lets rays scatter in the fog
    assert (sum(scattered) > 0) == interface, sum(scattered)


def test_checked_intersectors_hold_each_batch():
    """bench_scene.CheckedIntersectors (which holds the kernel against the
    plain traversal on VolPath's own batches on the card) sees every batch
    of the phased wave, the padded 4,096 lanes among them, returns the
    traversal's hits, and raises where a batch's hits disagree."""
    sc, dbvh, cam = fog_scene(interface=True)
    cfg = integrator.IntegratorConfig(max_depth=6, kind="volpath", rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    plain = dispatch.make_intersectors(sc, dbvh, "cpu")
    films = []
    for isect in (plain, bench_scene.CheckedIntersectors(plain, plain, "fog")):
        wave = volpath.make_phased_wave(sc, dbvh, cam, scfg, cfg, phase_len=2, isect=isect,
                                        device="cpu")
        films.append(wave(film.make_film(cam.height, cam.width, "cpu"), 0).xyz)
    assert torch.equal(films[0], films[1])
    assert isect.ties == 0 and len(isect.sizes) > 6 and isect.sizes[0] == (4096, False)

    bad = dispatch.make_intersectors(sc, dbvh, "cpu")
    fn = bad.fn
    bad.fn = lambda *a: fn(*a)._replace(t=fn(*a).t + 1.0)
    wave = volpath.make_phased_wave(sc, dbvh, cam, scfg, cfg, phase_len=2, device="cpu",
                                    isect=bench_scene.CheckedIntersectors(plain, bad, "fog"))
    with pytest.raises(AssertionError, match="fog, batch 0 of 4096 lanes: t differs"):
        wave(film.make_film(cam.height, cam.width, "cpu"), 0)


def test_resort_off_traces_through_the_sorted_intersector():
    """VolPath's cfg.resort=False (the JAX package's switch) traces every
    batch through the sorted intersector instead; the image is the same.
    The Path wave always re-sorts and refuses the switch."""
    sc, dbvh, cam = fog_scene(interface=True)
    cam = cam._replace(width=12, height=12)
    imgs = [integrator.render(sc, dbvh, cam, spp=1, device="cpu", cfg=integrator.IntegratorConfig(
                kind="volpath", max_depth=4, resort=resort)).numpy() for resort in (True, False)]
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="resort=False"):
        integrator.render(sc, dbvh, cam, spp=1, device="cpu",
                          cfg=integrator.IntegratorConfig(max_depth=4, resort=False))


def test_phased_ladder_cuts_lanes():
    """A wave of 160,000 lanes runs on _align's ladder (the JAX package's):
    163,840 lanes, then halving to 4,096."""
    sizes = volpath.ladder(400 * 400)
    assert sizes[0] == 163840 and sizes[-1] == 4096
    assert all(s % 4096 == 0 and s > t for s, t in zip(sizes, sizes[1:]))


def test_wave_dispatch_rule():
    """make_wave_fn takes the phased wave only for VolPath with compact and
    early_exit on a CUDA backend; the CPU's plain traversal traces the whole
    wave. (The CUDA intersectors here are never called.)"""
    sc, dbvh, cam = fog_scene()
    tsc = scene.to_device(sc, "cpu")
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    plain = dispatch.make_intersectors(tsc, dbvh, "cpu")
    fake_cuda = dispatch.Intersectors("cuda_bvh4", plain.tables, plain.device)
    cfg = integrator.IntegratorConfig(kind="volpath")
    phased = lambda c, i: hasattr(integrator.make_wave_fn(tsc, dbvh, cam, scfg, c, isect=i),
                                  "phases")
    assert phased(cfg, fake_cuda)
    assert not phased(cfg, plain)
    assert not phased(cfg._replace(compact=False), fake_cuda)
    assert not phased(cfg._replace(early_exit=False), fake_cuda)
    assert not phased(cfg._replace(kind="path"), fake_cuda)


@pytest.mark.parametrize("extra", ["none", "env_map", "sphere_light", "quadric"])
def test_scene_check_takes_media_refuses_the_rest(extra):
    """scene_from_numpy carries media across, and with them image env maps,
    sphere area lights, analytic quadrics and a goniometric light (which
    reads the texture atlas); a light tag the port does not know still
    raises."""
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse")
    fog = b.add_medium(sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.5, 0.5, 0.5))
    b.add_sphere((0, 1, 0), 0.8, -1, n_theta=6, n_phi=12, med_inside=fog)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    if extra == "env_map":
        b.set_environment_map(np.ones((8, 8, 3), np.float32))
    elif extra == "sphere_light":
        b.add_sphere((0, 3, 0), 0.3, m, n_theta=6, n_phi=12, emission_rgb=(1, 1, 1))
    elif extra == "quadric":
        b.add_quadric("sphere", (2, 1, 0), 0.5, m)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    if extra == "none":
        tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
        assert tsc.n_media == 1 and tsc.camera_medium == -1
        assert np.array_equal(tsc.tri_shade[:, 26:28].numpy(), np.asarray(sc.tri_shade)[:, 26:28])
        assert (tsc.tri_shade[:, 26] == fog).any()
    else:
        tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
        assert tsc.n_media == 1
        np.testing.assert_array_equal(tsc.env_luminance.numpy(), np.asarray(sc.env_luminance))
        np.testing.assert_array_equal(tsc.light_type.numpy(), np.asarray(sc.light_type))
        assert tsc.n_quadrics == (extra == "quadric")
        np.testing.assert_array_equal(tsc.tri_shade.numpy(), np.asarray(sc.tri_shade))
    b.add_goniometric_light((0, 2, 0), np.ones((4, 4, 3), np.float32))
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    assert tsc.n_media == 1 and scene.LIGHT_GONIOMETRIC in tsc.light_type.tolist()
    np.testing.assert_array_equal(tsc.tex_atlas.numpy(), np.asarray(sc.tex_atlas))
    bad = dict(sc._asdict(), light_type=np.full_like(np.asarray(sc.light_type),
                                                     scene.LIGHT_SPHERE_AREA + 1))
    with pytest.raises(ValueError, match="unknown"):
        scene.scene_from_numpy(bad, dbvh._asdict(), "cpu")
