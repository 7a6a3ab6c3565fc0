"""The film surface and the cameras of the torch port against the JAX
package on the CPU: measured sensors (three named sensors x white balance
None, 3000, 6460 and 6540 K, which straddles the D65 branch at |wb - 6500|
< 51: 1e-5), make_sensor's white balance x the four output spaces (1e-6),
add_samples with response curves, develop with a MeasuredSensor and the
spectral film, sequential and scattered (1e-5); generate_rays of every
camera kind at 16x12 and 12x16 with and without camera motion (1e-5; a
realistic camera's vignetted lanes, sent from (0, 0, -1e9) along +z, held
apart: the same lanes in both, rtol 1e-6), the focused lens table (1e-4
mm); render_gbuffer's AOVs on tests/test_film_camera.py:113's quad and a
textured scene (1e-4, masks equal); one Path render each through the
orthographic, equal-area spherical and realistic cameras within
tests/test_torch_render.py's thresholds (mean within 0.5%, >= 99% of pixels
within atol 1e-3 + rtol 1e-2): three JAX Path compiles; LightPath and BDPT
refuse a non-perspective camera."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import colorspace as j_colorspace, named_spectra as j_named
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import (camera as j_camera, film as j_film,
                                  integrator as j_integrator)
from nn_bvh_tpu_torch.core import colorspace
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.wavefront import bdpt, camera, film, integrator, lightpath

torch.set_num_threads(1)

SENSORS = ("canon_eos_5d_mkiv", "nikon_d850", "sony_ilce_7m3")
SPACES = ("srgb", "dci-p3", "rec2020", "aces2065-1")


def close(j, t, tol, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=0, **kw)


# ---------------------------------------------------------------------------
# color spaces and sensors
# ---------------------------------------------------------------------------

def test_color_spaces_match_jax():
    for name in SPACES:
        np.testing.assert_array_equal(colorspace.RGB_TO_XYZ[name], j_colorspace.RGB_TO_XYZ[name])
        np.testing.assert_array_equal(colorspace.XYZ_TO_RGB[name], j_colorspace.XYZ_TO_RGB[name])
    rgb = np.random.RandomState(3).rand(64, 3).astype(np.float32)
    t = torch.from_numpy(rgb)
    close(j_colorspace.linear_srgb_to_xyz(jnp.asarray(rgb)), colorspace.linear_srgb_to_xyz(t), 1e-6)
    close(j_colorspace.srgb_decode(jnp.asarray(rgb)), colorspace.srgb_decode(t), 1e-6)
    close(j_colorspace.luminance(jnp.asarray(rgb)), colorspace.luminance(t), 1e-6)


def test_named_sensors_are_present():
    names = {n[:-2] for n in j_named.names() if n.endswith("_r")}
    assert len(names) == 17 and set(SENSORS) <= names


@pytest.mark.parametrize("wb", [None, 3000.0, 6460.0, 6540.0])
@pytest.mark.parametrize("name", SENSORS)
def test_measured_sensor_matches_jax(name, wb):
    j = j_film.make_measured_sensor(name, wb, iso=200.0, exposure=0.5)
    t = film.make_measured_sensor(name, wb, iso=200.0, exposure=0.5)
    close(j.xyz_from_rgb, t.xyz_from_rgb, 1e-5)
    close(j.curves, t.curves, 1e-5)
    assert t.imaging_ratio == j.imaging_ratio == 1.0
    assert film.make_measured_sensor("no_such_camera", wb) is None


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("temp", [3000.0, 5000.0, 9000.0])
def test_make_sensor_matches_jax(temp, space):
    j = j_film.make_sensor(temp, iso=400.0, output_space=space)
    t = film.make_sensor(temp, iso=400.0, output_space=space)
    close(j.xyz_to_rgb, t.xyz_to_rgb, 1e-6)
    assert t.imaging_ratio == j.imaging_ratio == 4.0
    close(j_film.make_sensor(output_space=space).xyz_to_rgb,
          film.make_sensor(output_space=space).xyz_to_rgb, 1e-6)


def samples(R, seed=5):
    rs = np.random.RandomState(seed)
    L = (rs.rand(R, 4) * 3).astype(np.float32)
    L[3] = np.inf  # a non-finite sample is dropped
    lam = (360.0 + rs.rand(R, 4) * 470.0).astype(np.float32)
    lam[0, 0], lam[1, 1] = 359.0, 831.0  # outside the grid: clamped
    pdf = (rs.rand(R, 4) * 0.01 + 1e-3).astype(np.float32)
    pdf[2, 2] = 0.0
    w = (rs.rand(R) + 0.5).astype(np.float32)
    return L, lam, pdf, w


@pytest.mark.parametrize("sequential", [True, False], ids=["sequential", "scatter"])
def test_sensor_film_matches_jax(sequential):
    """add_samples with a measured sensor's curves, then develop with it and
    with a white-balanced PixelSensor."""
    H, W = 3, 4
    R = H * W
    L, lam, pdf, w = samples(R if sequential else 3 * R)
    pix = (np.arange(R) if sequential
           else np.random.RandomState(1).randint(0, R, 3 * R)).astype(np.int32)
    js = j_film.make_measured_sensor("canon_eos_5d_mkiv", 5000.0)
    ts = film.make_measured_sensor("canon_eos_5d_mkiv", 5000.0)
    jf = j_film.add_samples(j_film.make_film(H, W), jnp.asarray(pix), jnp.asarray(L),
                            jnp.asarray(lam), jnp.asarray(pdf), jnp.asarray(w), sequential,
                            sensor_curves=jnp.asarray(js.curves))
    tf = film.add_samples(film.make_film(H, W, "cpu"), torch.from_numpy(pix),
                          torch.from_numpy(L), torch.from_numpy(lam), torch.from_numpy(pdf),
                          torch.from_numpy(w), sequential,
                          sensor_curves=film.sensor_curves(ts, "cpu"))
    close(jf.xyz, tf.xyz, 1e-5)
    close(jf.weight, tf.weight, 1e-5)
    close(j_film.develop(jf, sensor=js), film.develop(tf, sensor=ts), 1e-5)
    pj, pt = j_film.make_sensor(3000.0), film.make_sensor(3000.0)
    close(j_film.develop(jf, sensor=pj), film.develop(tf, sensor=pt), 1e-5)
    assert film.sensor_curves(pt, "cpu") is None


@pytest.mark.parametrize("sequential", [True, False], ids=["sequential", "scatter"])
def test_spectral_film_matches_jax(sequential):
    H, W = 2, 5
    R = H * W
    L, lam, pdf, w = samples(R if sequential else 4 * R, seed=9)
    pix = (np.arange(R) if sequential
           else np.random.RandomState(2).randint(0, R, 4 * R)).astype(np.int32)
    jf = j_film.add_samples_spectral(j_film.make_spectral_film(H, W, n_buckets=12),
                                     jnp.asarray(pix), jnp.asarray(L), jnp.asarray(lam),
                                     jnp.asarray(pdf), jnp.asarray(w), sequential)
    tf = film.add_samples_spectral(film.make_spectral_film(H, W, n_buckets=12, device="cpu"),
                                   torch.from_numpy(pix), torch.from_numpy(L),
                                   torch.from_numpy(lam), torch.from_numpy(pdf),
                                   torch.from_numpy(w), sequential)
    close(jf.buckets, tf.buckets, 1e-5)
    close(jf.bweight, tf.bweight, 1e-5)
    close(j_film.develop_spectral(jf), film.develop_spectral(tf), 1e-5)
    assert film.develop_spectral(tf).shape == (H, W, 12)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

M0 = j_xf.look_at((0.3, 1.0, -4.0), (0.0, 0.5, 0.0), (0, 1, 0))
M1 = j_xf.look_at((1.1, 1.3, -3.6), (0.2, 0.4, 0.0), (0, 1, 0))
LENS = dict(focus_500=dict(focus_distance=500.0),
            focus_2000_f4=dict(focus_distance=2000.0, aperture_diameter=12.0))


def make_cameras(mod, kind, W, H):
    if kind == "perspective":
        return mod.make_perspective(M0, 40.0, W, H)
    if kind == "thin_lens":
        return mod.make_perspective(M0, 40.0, W, H, lens_radius=0.2, focal_distance=3.0)
    if kind == "orthographic":
        return mod.make_orthographic(M0, 1.5, W, H)
    if kind in ("equirect", "equalarea"):
        return mod.make_spherical(M0, W, H, mapping=kind)
    return mod.make_realistic(M0, W, H, **LENS[kind])


_CAMS = {}


def cameras(kind, W, H):
    """(JAX camera, port camera), built once (the focus bisections take a
    second of eager JAX)."""
    if (kind, W, H) not in _CAMS:
        _CAMS[kind, W, H] = (make_cameras(j_camera, kind, W, H),
                             make_cameras(camera, kind, W, H))
    return _CAMS[kind, W, H]


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("size", [(16, 12), (12, 16)], ids=["16x12", "12x16"])
@pytest.mark.parametrize("kind", ["perspective", "thin_lens", "orthographic", "equirect",
                                  "equalarea", "focus_500", "focus_2000_f4"])
def test_generate_rays_match_jax(kind, size, motion):
    W, H = size
    jcam, tcam = cameras(kind, W, H)
    if motion:
        jcam, tcam = j_camera.with_motion(jcam, M1), camera.with_motion(tcam, M1)
    R = W * H
    rs = np.random.RandomState(R + len(kind))
    u_pix, u_lens = rs.rand(2, R, 2).astype(np.float32)
    u_time = rs.rand(R).astype(np.float32)
    oj, dj = j_camera.generate_rays(jcam, jnp.arange(R, dtype=jnp.int32), jnp.asarray(u_pix),
                                    jnp.asarray(u_lens), jnp.asarray(u_time))
    ot, dt = camera.generate_rays(tcam, torch.arange(R, dtype=torch.int32),
                                  torch.from_numpy(u_pix), torch.from_numpy(u_lens),
                                  torch.from_numpy(u_time))
    oj, dj, ot, dt = map(np.asarray, (oj, dj, ot, dt))
    far_j = np.abs(oj).max(-1) > 1e6
    far_t = np.abs(ot).max(-1) > 1e6
    np.testing.assert_array_equal(far_t, far_j)  # the vignetted lanes
    if kind.startswith("focus"):
        assert 0 < (~far_t).sum() and far_t.sum() > 0, far_t.sum()
    else:
        assert not far_t.any()
    np.testing.assert_allclose(ot[far_t], oj[far_j], rtol=1e-6)
    close(oj[~far_j], ot[~far_t], 1e-5)
    close(dj, dt, 1e-5)
    if not motion:  # lerped keyframes are not orthonormal
        np.testing.assert_allclose(np.linalg.norm(dt, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", list(LENS))
def test_focused_lens_table_matches_jax(kind):
    jcam, tcam = cameras(kind, 16, 12)
    assert tcam.kind == camera.REALISTIC and tcam.film_diag == 35.0
    close(jcam.lens_elements, tcam.lens_elements, 1e-4)
    # the focus moved the rear gap; the aperture resized the stop
    assert tcam.lens_elements[0, 1] != camera._BICONVEX[0, 1]
    stop = tcam.lens_elements[2, 3]
    assert stop == (6.0 if "aperture_diameter" in LENS[kind] else 9.0)


# ---------------------------------------------------------------------------
# G-buffer
# ---------------------------------------------------------------------------

def quad_scene(mod):
    b = mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.8, 0.2, 0.1))
    b.add_quad((-5, -5, 2), (5, -5, 2), (5, 5, 2), (-5, 5, 2), m)
    return b.build(), j_xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), 30.0


def textured_scene(mod):
    """A checkerboard floor, an image-textured quad and a sphere, partly
    against the void."""
    b = mod.SceneBuilder()
    rs = np.random.RandomState(11)
    chk = b.add_texture_checker((0.1, 0.2, 0.7), (0.9, 0.8, 0.2), uscale=6.0)
    img = b.add_texture_image(rs.rand(16, 16, 3).astype(np.float32))
    b.add_quad((-4, 0, -2), (4, 0, -2), (4, 0, 6), (-4, 0, 6),
               b.add_material("diffuse", texture=chk))
    b.add_quad((-1.5, 0.2, 3), (1.5, 0.2, 3), (1.5, 2.5, 3), (-1.5, 2.5, 3),
               b.add_material("diffuse", texture=img))
    b.add_sphere((1.2, 0.6, 1.0), 0.5, b.add_material("conductor", reflectance=(0.9, 0.7, 0.4)),
                 n_theta=8, n_phi=16)
    return b.build(), j_xf.look_at((0, 1.6, -3), (0, 0.6, 2), (0, 1, 0)), 60.0


@pytest.mark.parametrize("make", [quad_scene, textured_scene], ids=["quad", "textured"])
def test_gbuffer_matches_jax(make):
    sc, cam_to_world, fov = make(j_scene)
    sc, dbvh, _ = j_accel.build_scene_bvh(sc)
    W, H = 12, 10
    gj = j_integrator.render_gbuffer(sc, dbvh, j_camera.make_perspective(cam_to_world, fov, W, H))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    gt = integrator.render_gbuffer(tsc, tbvh, camera.make_perspective(cam_to_world, fov, W, H))
    assert set(gt) == set(gj)
    np.testing.assert_array_equal(gt["mask"].numpy(), np.asarray(gj["mask"]))
    for k in gj:
        assert gt[k].shape == gj[k].shape and gt[k].dtype == torch.float32, k
        close(gj[k], gt[k], 1e-4, err_msg=k)
    m = gt["mask"].numpy()[..., 0] > 0
    if make is quad_scene:
        assert m.all()
    else:
        assert 0.3 < m.mean() < 1.0, m.mean()  # some rays miss
        assert (gt["albedo"].numpy()[m] > 0).all()


# ---------------------------------------------------------------------------
# renders through the other cameras
# ---------------------------------------------------------------------------

RW = RH = 16
RSPP = 2


def camera_scene(mod):
    """Colored diffuse and metal spheres off the axis of a camera at
    (0, 0.5, -5) looking along +z, a floor, an emissive quad above and a
    dim sky; the optical axis ends on a black quad, so that a realistic
    camera's vignetted rays (sent along the axis from far behind) gather
    no light."""
    b = mod.SceneBuilder()
    black = b.add_material("diffuse", reflectance=(0, 0, 0))
    red = b.add_material("diffuse", reflectance=(0.7, 0.2, 0.15))
    blue = b.add_material("diffuse", reflectance=(0.15, 0.3, 0.7))
    metal = b.add_material("conductor", reflectance=(0.9, 0.8, 0.6), roughness=0.2)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for c, m in (((-1.4, 0.6, 1.0), red), ((1.5, 0.9, 0.0), blue), ((0.2, 2.0, 2.5), metal),
                 ((-0.6, -0.3, -1.5), blue)):
        b.add_sphere(c, 0.55, m, n_theta=8, n_phi=16)
    b.add_quad((-8, -1, -8), (8, -1, -8), (8, -1, 8), (-8, -1, 8), floor)
    b.add_quad((-0.6, -0.1, 4), (0.6, -0.1, 4), (0.6, 1.1, 4), (-0.6, 1.1, 4), black)
    b.add_quad((-2, 5, -2), (2, 5, -2), (2, 5, 2), (-2, 5, 2), black,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=12.0, two_sided=True)
    b.add_uniform_infinite_light((0.2, 0.25, 0.3), scale=1.0)
    return b.build()


CAM_M = j_xf.look_at((0, 0.5, -5), (0, 0.5, 0), (0, 1, 0))


@pytest.fixture(scope="module")
def camera_scenes():
    sc, dbvh, _ = j_accel.build_scene_bvh(camera_scene(j_scene))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return sc, dbvh, tsc, tbvh


def render_kind(mod, kind):
    if kind == "orthographic":
        return mod.make_orthographic(CAM_M, 3.0, RW, RH)
    if kind == "equalarea":
        return mod.make_spherical(CAM_M, RW, RH, mapping="equalarea")
    return mod.make_realistic(CAM_M, RW, RH, focus_distance=5000.0)


@pytest.mark.parametrize("kind", ["orthographic", "equalarea", "realistic"])
def test_camera_render_matches_jax(camera_scenes, kind):
    sc, dbvh, tsc, tbvh = camera_scenes
    cfg = dict(max_depth=3, mis=True, rr_depth=2)
    img_j = np.asarray(j_integrator.render(sc, dbvh, render_kind(j_camera, kind), spp=RSPP,
                                           sampler="sobol", seed=0,
                                           cfg=j_integrator.IntegratorConfig(**cfg)))
    img_t = integrator.render(tsc, tbvh, render_kind(camera, kind), spp=RSPP, sampler="sobol",
                              seed=0, cfg=integrator.IntegratorConfig(**cfg)).numpy()
    assert img_t.shape == img_j.shape == (RH, RW, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


def test_camera_spread_rule():
    """The texture cone's spread: the perspective fov, else 60 degrees."""
    from nn_bvh_tpu_torch.geometry import texture

    persp = camera.make_perspective(M0, 35.0, 8, 8)
    assert integrator.camera_spread(persp) == texture.camera_spread(35.0, 8)
    for cam in (camera.make_orthographic(M0, 1.0, 8, 8), camera.make_spherical(M0, 8, 8)):
        assert integrator.camera_spread(cam) == texture.camera_spread(60.0, 8)


@pytest.mark.parametrize("render", [lightpath.render_lightpath, bdpt.render_bdpt],
                         ids=["lightpath", "bdpt"])
def test_light_tracers_refuse_other_cameras(camera_scenes, render):
    """LightPath and BDPT splat through a pinhole projection: the port
    refuses another camera kind (the JAX package reads its fov 0)."""
    _, _, tsc, tbvh = camera_scenes
    for kind in ("orthographic", "equalarea"):
        with pytest.raises(ValueError, match="perspective camera"):
            render(tsc, tbvh, render_kind(camera, kind), spp=1)
