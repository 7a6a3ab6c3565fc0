"""The port's SPPM (wavefront/sppm.py) against the JAX package on the CPU:
the cell hash, one iteration's state and develop.

The scene is test_torch_lightpath.py's (the reduced bench scene with a
black emissive quad, a point light and an analytic sphere light), 16x16,
depth 3, 8,192 photons, radius 1, k_cap 2 (small enough that cells
overflow and photons are dropped).

Tolerances: the cell hash bit for bit; the iteration's state per pixel:
r2, n and the direct term ld (XYZ) within atol 1e-3 + rtol 1e-2 on >= 99%
of pixels, tau within atol 1e-3 + rtol 1e-2 on >= 97% of pixels and its
sum within 2% (the JAX anchor intersects watertight and the port
Moller-Trumbore: a photon that flips at an edge lands elsewhere and moves
every pixel that gathers it), `dropped` within 5%; develop within atol
1e-6 on the same state.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from functools import partial

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.scatter import lightsamplers as j_ls
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator, sppm as j_sppm
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.wavefront import camera, integrator, sppm

from test_torch_integrators import emitter_scene
from test_torch_lightpath import add_lights
from test_torch_render import EYE, TARGET, UP

torch.set_num_threads(1)

W = H = 16
R = W * H
DEPTH = 3
K_CAP = 2
RADIUS = 1.0
P = 8192


def test_cell_hash_bit_identical():
    rs = np.random.RandomState(0)
    c = rs.randint(-2 ** 31, 2 ** 31 - 1, size=(3, 2000), dtype=np.int64).astype(np.int32)
    c[:, :50] = rs.randint(-4, 4, size=(3, 50))  # small coordinates of both signs
    want = np.asarray(j_sppm._cell_hash(*(jnp.asarray(x) for x in c)))
    got = sppm._cell_hash(*(torch.from_numpy(x) for x in c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2 ** sppm.HASH_BITS


@pytest.fixture(scope="module")
def states():
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene, add_lights))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=W, height=H)
    jcfg = j_integrator.IntegratorConfig(max_depth=DEPTH)
    tcfg = integrator.IntegratorConfig(max_depth=DEPTH)
    it = jax.jit(partial(j_sppm.sppm_iteration, sc, dbvh, jcam, jcfg, n_photons=P,
                         ls_tables=j_ls.build(sc, jcfg.light_sampler), seed=2, k_cap=K_CAP))
    j = it(j_sppm.make_state(R, RADIUS), jnp.int32(1))
    t = sppm.sppm_iteration(tsc, tbvh, tcam, tcfg, sppm.make_state(R, RADIUS, "cpu"), 1, P,
                            lightsamplers.build(tsc, tcfg.light_sampler, "cpu"), seed=2,
                            k_cap=K_CAP)
    return j, t


def test_iteration_state_matches_jax(states):
    j, t = states
    close = lambda a, b: np.isclose(np.asarray(a), np.asarray(b), atol=1e-3,
                                    rtol=1e-2).reshape(R, -1).all(-1)
    for name in ("r2", "n", "ld"):
        ok = close(getattr(t, name).numpy(), getattr(j, name))
        assert ok.mean() >= 0.99, (name, ok.mean())
    assert (t.n.numpy() > 0).mean() > 0.3 and (t.r2.numpy() < RADIUS ** 2).any()
    tau_t, tau_j = t.tau.numpy(), np.asarray(j.tau)
    assert close(tau_t, tau_j).mean() >= 0.97
    assert abs(tau_t.sum() - tau_j.sum()) <= 0.02 * tau_j.sum()
    drop_t, drop_j = int(t.dropped), int(j.dropped)
    assert drop_j > 0 and abs(drop_t - drop_j) <= 0.05 * drop_j, (drop_t, drop_j)


def test_develop_matches_jax(states):
    j = states[0]
    want = np.asarray(j_sppm.develop(j, 1, R, H, W))
    got = sppm.develop(sppm.SPPMState(*(torch.from_numpy(np.array(x)) for x in j)), 1, R,
                       H, W).numpy()
    assert got.shape == (H, W, 3) and got.mean() > 0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_render_sppm_renders(states):
    """render_sppm end to end (two iterations of 4,096 photons): finite,
    positive, and brighter than its direct term alone."""
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene, add_lights))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=8, height=8)
    cfg = integrator.IntegratorConfig(max_depth=DEPTH)
    kw = dict(n_iterations=2, photons_per_iter=4096, initial_radius=RADIUS, cfg=cfg)
    st = sppm.run_sppm(tsc, tbvh, tcam, **kw)
    img = sppm.render_sppm(tsc, tbvh, tcam, **kw)
    np.testing.assert_array_equal(img.numpy(), sppm.develop(st, 2, 4096, 8, 8).numpy())
    direct = sppm.develop(st._replace(tau=torch.zeros_like(st.tau)), 2, 4096, 8, 8)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > float(direct.mean()) > 0
