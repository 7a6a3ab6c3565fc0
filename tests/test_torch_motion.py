"""Motion blur in the port: object motion (shutter-end vertex tables lerped
once a wave, the triangle table rebuilt on the device, one BVH over the
union of both keyframes' bounds) and camera motion (pre-slerped keyframes,
one shutter time a lane).

- The animated wave equals the static scene built at the wave's shutter
  time (the port's own, as tests/test_motion.py:50 holds the JAX package):
  atol 2e-3, rtol 1e-3.
- interpolate_motion and with_motion against the JAX package: rtol 1e-6.
- A moving quad under a moving camera, 16x16, 2 spp, depth 2: the image
  against JAX's render, with tests/test_torch_render.py's thresholds.
- The per-wave triangle records equal bvh4.pack_tris_cuda of the lerped
  vertices bit for bit.
- The reference's VolPath draws no shutter time (nn_bvh_tpu/wavefront/
  volpath.py:114-115): the port's VolPath renders a moving camera at shutter
  open, bit for bit the static camera's image.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import bvh4, dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene, transform as xf
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

RES = 16
EYE, TARGET = (0, 1.4, -3.5), (0, 1.4, 0)


def moving_quad(mod, xfm, offset: float, to: float | None = None):
    """tests/test_motion.py's scene: a quad at x = offset (moving to x = to
    over the shutter), a floor and an emissive quad."""
    b = mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.8, 0.2, 0.2))
    floor = b.add_material("diffuse", reflectance=(0.4, 0.4, 0.4))
    v = np.array([[-0.4, 1.0, 0], [0.4, 1.0, 0], [0.4, 1.8, 0], [-0.4, 1.8, 0]], np.float32)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]]), m, transform=xfm.translate([offset, 0, 0]),
               transform_end=None if to is None else xfm.translate([to, 0, 0]))
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), floor)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), floor,
               emission_rgb=(1, 1, 1), emission_scale=12.0, two_sided=True)
    return b.build()


def cam(mod, size: int = RES):
    return mod.make_perspective(j_xf.look_at(EYE, TARGET, (0, 1, 0)), fov=45.0, width=size,
                                height=size)


def end_pose():
    return j_xf.look_at((0.3, 1.5, -3.4), (0.2, 1.4, 0), (0, 1, 0))


def test_animated_wave_equals_static_at_wave_time():
    """spp 1: the wave's one shutter time t reproduces the static scene
    built at lerp(t)."""
    t = float(integrator.shutter_time(0, 1, "cpu"))
    cfg = integrator.IntegratorConfig(max_depth=2)
    imgs = []
    for sc in (moving_quad(scene, xf, -0.8, 0.8), moving_quad(scene, xf, -0.8 + t * 1.6)):
        sc, dbvh, _ = accel.build_scene_bvh(sc)
        imgs.append(integrator.render(sc, dbvh, cam(camera, 32), spp=1, cfg=cfg,
                                      device="cpu").numpy())
    np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-3, rtol=1e-3)


def test_shutter_time_matches_jax():
    from nn_bvh_tpu.core import rng as j_rng

    for s, spp in ((0, 1), (3, 16), (15, 16)):
        u = j_rng.hash_float(jnp.asarray([0], jnp.int32), jnp.asarray([s], jnp.int32),
                             jnp.uint32(0x51))[0]
        t = (jnp.asarray(s, jnp.float32) + u) / spp
        assert float(integrator.shutter_time(s, spp, "cpu")) == float(t)


def test_camera_motion_matches_jax():
    jc = j_camera.with_motion(cam(j_camera), end_pose())
    tc = camera.with_motion(cam(camera), end_pose())
    np.testing.assert_allclose(tc.motion_keys, np.asarray(jc.motion_keys), rtol=1e-6, atol=1e-7)
    u = np.random.RandomState(0).rand(4096).astype(np.float32)
    u[:3] = (0.0, 0.999999, 0.5)
    np.testing.assert_allclose(
        camera.interpolate_motion(tc, torch.from_numpy(u)).numpy(),
        np.asarray(j_camera.interpolate_motion(jc, jnp.asarray(u))), rtol=1e-6, atol=1e-6)


def test_union_bounds_bvh():
    """One tree over both keyframes: every leaf box holds its triangles at
    shutter open and close, and the root box is the union of both."""
    sc, dbvh, _ = accel.build_scene_bvh(moving_quad(scene, xf, -0.8, 0.8))
    n = sc.n_tris
    lo, hi, meta = dbvh.node_lo, dbvh.node_hi, dbvh.node_meta
    for tab in (sc.tri_p[:n], sc.tri_p_end[:n]):
        np.testing.assert_array_less(lo[0] - 1e-6, tab.reshape(-1, 3).min(0))
        np.testing.assert_array_less(tab.reshape(-1, 3).max(0), hi[0] + 1e-6)
    both = np.concatenate([sc.tri_p[:n], sc.tri_p_end[:n]]).reshape(-1, 3)
    np.testing.assert_allclose(lo[0], both.min(0), atol=1e-6)
    np.testing.assert_allclose(hi[0], both.max(0), atol=1e-6)
    for k in np.nonzero(meta[:dbvh.n_nodes, 1] > 0)[0]:
        off, cnt = int(meta[k, 0]), int(meta[k, 1])
        for tab in (sc.tri_p, sc.tri_p_end):
            pts = tab[off:off + cnt].reshape(-1, 3)
            assert (pts >= lo[k] - 1e-6).all() and (pts <= hi[k] + 1e-6).all()
    # tri_shade_end follows the reordered end vertices
    np.testing.assert_array_equal(sc.tri_shade_end[:n, 0:9], sc.tri_p_end[:n].reshape(n, 9))


@pytest.mark.parametrize("backend", ["plain", "cuda_bvh4"])
def test_wave_records_equal_host_packing(backend):
    """set_triangles' records of the lerped vertices against
    bvh4.pack_tris_cuda's, bit for bit ("plain" keeps the vertices)."""
    sc, _, _ = accel.build_scene_bvh(moving_quad(scene, xf, -0.8, 0.8))
    tsc = scene.to_device(sc, "cpu")
    lerped = integrator.scene_at_shutter(tsc, 5, 16).tri_p
    assert not torch.equal(lerped, tsc.tri_p)
    out = dispatch.tri_table_device(backend, lerped)
    ref = lerped.numpy() if backend == "plain" else bvh4.pack_tris_cuda(lerped.numpy())
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))


def test_motion_render_matches_jax():
    sc, dbvh, _ = j_accel.build_scene_bvh(moving_quad(j_scene, j_xf, -0.6, 0.6))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    np.testing.assert_array_equal(tsc.tri_shade_end.numpy(), np.asarray(sc.tri_shade_end))
    jcam = j_camera.with_motion(cam(j_camera), end_pose())
    tcam = camera.with_motion(cam(camera), end_pose())
    img_j = np.asarray(j_integrator.render(
        sc, dbvh, jcam, spp=2, cfg=j_integrator.IntegratorConfig(max_depth=2, rr_depth=1)))
    img_t = integrator.render(tsc, tbvh, tcam, spp=2,
                              cfg=integrator.IntegratorConfig(max_depth=2, rr_depth=1)).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    assert np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1).mean() >= 0.99


def test_volpath_renders_a_moving_camera_at_shutter_open():
    sc, dbvh, _ = accel.build_scene_bvh(moving_quad(scene, xf, -0.6))
    scfg = samplers.make_sampler("sobol", seed=0, spp=2)
    imgs = {}
    for kind in ("volpath", "path"):
        cfg = integrator.IntegratorConfig(kind=kind, max_depth=2, rr_depth=1)
        for moving in (False, True):
            c = camera.with_motion(cam(camera), end_pose()) if moving else cam(camera)
            wave = integrator.make_wave_fn(sc, dbvh, c, scfg, cfg, device="cpu")
            f = film.make_film(RES, RES, "cpu")
            imgs[kind, moving] = film.develop(wave(wave(f, 0), 1))
    assert torch.equal(imgs["volpath", True], imgs["volpath", False])
    assert not torch.allclose(imgs["path", True], imgs["path", False])
