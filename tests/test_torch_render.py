"""The whole slice: the torch port's Path integrator against JAX
`integrator.render` on the CPU, on a reduced bench scene (bench.py's
materials, floor and emissive quad, 6 spheres at n_theta=8, n_phi=16: 1,348
triangles), 24x24, Sobol 2 spp, depth 4, rr_depth 2, seed 0, with MIS (Path)
and without (SimplePath). The scene
and BVH are built by the JAX package and carried across with
`scene_from_numpy`, so both render the very same tables.

Thresholds: camera rays atol 1e-5; first-hit prim equal on >= 99.9% of
lanes; image mean within 0.5% and >= 99% of pixels within atol 1e-3 +
rtol 1e-2. The JAX CPU anchor intersects with the watertight
`triangle.intersect`, the port (like the TPU kernel) with Moller-Trumbore:
a ray that flips at an edge makes its whole path diverge.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import traverse as j_traverse
from nn_bvh_tpu.core import samplers as j_samplers
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

W = H = 24
SPP = 2
EYE, TARGET, UP = (0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)


def reduced_bench_scene(mod):
    rs = np.random.RandomState(42)
    b = mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=8, n_phi=16)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    return b.build()


@pytest.fixture(scope="module")
def setup():
    sc, dbvh, _ = j_accel.build_scene_bvh(reduced_bench_scene(j_scene))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0,
                                     width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0,
                                   width=W, height=H)
    return sc, dbvh, jcam, tsc, tbvh, tcam


@pytest.fixture(scope="module", params=[True, False], ids=["path_mis", "simplepath"])
def images(setup, request):
    """Path (MIS + RR) and SimplePath (mis=False) through both packages."""
    sc, dbvh, jcam, tsc, tbvh, tcam = setup
    jcfg = j_integrator.IntegratorConfig(max_depth=4, mis=request.param, rr_depth=2)
    tcfg = integrator.IntegratorConfig(max_depth=4, mis=request.param, rr_depth=2)
    img_j = np.asarray(j_integrator.render(sc, dbvh, jcam, spp=SPP, sampler="sobol",
                                           seed=0, cfg=jcfg))
    img_t = integrator.render(tsc, tbvh, tcam, spp=SPP, sampler="sobol", seed=0, cfg=tcfg)
    return img_j, img_t


def _camera_rays(setup, s):
    _, _, jcam, _, _, tcam = setup
    pix = np.arange(W * H, dtype=np.int32)
    smp = np.full(W * H, s, np.int32)
    jc = j_samplers.make_sampler("sobol", seed=0, spp=SPP)
    tc = samplers.make_sampler("sobol", seed=0, spp=SPP)
    jp, js = jnp.asarray(pix), jnp.asarray(smp)
    tp, ts = torch.from_numpy(pix), torch.from_numpy(smp)
    ju = [jnp.stack(j_samplers.get_2d(jc, jp, js, dim), -1)
          for dim in (j_integrator.DIM_PIXEL, j_integrator.DIM_LENS)]
    tu = [torch.stack(samplers.get_2d(tc, tp, ts, dim), -1)
          for dim in (integrator.DIM_PIXEL, integrator.DIM_LENS)]
    return j_camera.generate_rays(jcam, jp, *ju), camera.generate_rays(tcam, tp, *tu)


@pytest.mark.parametrize("sample", [0, 1])
def test_camera_ray_stage(setup, sample):
    (jo, jd), (to, td) = _camera_rays(setup, sample)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def test_first_hit_stage(setup):
    sc, dbvh, _, tsc, tbvh, _ = setup
    (jo, jd), (to, td) = _camera_rays(setup, 0)
    t_max = np.full(W * H, 1e30, np.float32)
    jh = j_traverse.intersect_closest(jax.tree.map(jnp.asarray, dbvh),
                                      jnp.asarray(sc.tri_p), jo, jd, jnp.asarray(t_max))
    th = dispatch.make_intersectors(tsc, tbvh, "cpu").closest(to, td, torch.from_numpy(t_max))
    agree = (np.asarray(jh.prim) == th.prim.numpy()).mean()
    assert agree >= 0.999, agree
    assert (th.prim.numpy() >= 0).mean() > 0.5  # the view is mostly geometry


def test_image_matches_jax(images):
    img_j, img_t = images
    img_t = img_t.numpy()
    assert img_t.shape == img_j.shape == (H, W, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


@pytest.mark.parametrize("backend", ["plain_binary", "plain_binary_deep", "plain_bvh8"])
def test_backend_image_matches_jax(setup, images, backend, request):
    """Each new traversal backend's plain version through the whole wave,
    against the same JAX image as test_image_matches_jax, same thresholds."""
    _, _, _, tsc, tbvh, tcam = setup
    mis = request.node.callspec.params["images"]
    cfg = integrator.IntegratorConfig(max_depth=4, mis=mis, rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=SPP, width=W)
    isect = dispatch.make_intersectors(tsc, tbvh, "cpu", backend=backend)
    wave = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, cfg, isect=isect)
    f = film.make_film(H, W, "cpu")
    for s in range(SPP):
        f = wave(f, s)
    assert isect.n_calls > 0
    img_j, img_t = images[0], film.develop(f).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


def test_outputs_are_float32(setup, images):
    _, _, _, tsc, tbvh, tcam = setup
    assert images[1].dtype == torch.float32
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=1)
    scfg = samplers.make_sampler("sobol", seed=0, spp=SPP)
    out = integrator.trace_wave(tsc, tbvh, tcam, scfg, cfg,
                                torch.arange(W * H, dtype=torch.int32), 0)
    assert [x.dtype for x in out] == [torch.float32] * 4
    assert out[0].shape == (W * H, 4)
    f = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, cfg)(film.make_film(H, W, "cpu"), 1)
    assert f.xyz.dtype == f.weight.dtype == torch.float32


def test_port_built_scene_renders():
    """The port's own builder + numpy SAH BVH through the public render."""
    sc, dbvh, _ = accel.build_scene_bvh(reduced_bench_scene(scene))
    cam = camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0,
                                  width=16, height=16)
    img = integrator.render(sc, dbvh, cam, spp=1, device="cpu",
                            cfg=integrator.IntegratorConfig(max_depth=3, rr_depth=1))
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0


def test_host_scene_defaults_to_cuda(monkeypatch):
    """A host (numpy) scene with no device= asks for the card; without one
    every entry point raises instead of rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc, dbvh, _ = accel.build_scene_bvh(reduced_bench_scene(scene))
    cam = camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0,
                                  width=8, height=8)
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    calls = [lambda: integrator.render(sc, dbvh, cam, spp=1),
             lambda: integrator.make_wave_fn(sc, dbvh, cam, scfg, integrator.IntegratorConfig()),
             lambda: dispatch.make_intersectors(sc, dbvh),
             lambda: film.make_film(8, 8)]
    for call in calls:
        with pytest.raises(ValueError, match="no CUDA device"):
            call()
    # a scene of CPU tensors keeps its device
    tsc = scene.to_device(sc, "cpu")
    assert dispatch.make_intersectors(tsc, dbvh).device == torch.device("cpu")


def test_unported_integrators_raise(setup):
    _, _, _, tsc, tbvh, tcam = setup
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        integrator.make_wave_fn(tsc, tbvh, tcam, scfg,
                                integrator.IntegratorConfig(kind="bdpt"))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import importlib, pkgutil\n"
            "import nn_bvh_tpu_torch\n"
            "for m in pkgutil.walk_packages(nn_bvh_tpu_torch.__path__, 'nn_bvh_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'nn_bvh_tpu_torch.tools.trav_prof' in sys.modules\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'nn_bvh_tpu' or m.startswith('nn_bvh_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    with open(os.path.join(repo, "chip_smoke.py")) as f:  # its imports inside functions too
        assert not re.search(r"^\s*(from|import)\s+(jax|nn_bvh_tpu)(\.|\s|$)", f.read(), re.M)
