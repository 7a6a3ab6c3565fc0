"""The port's MLT (wavefront/mlt.py) against the JAX package on the CPU, at
the least chain count: 16x16, 8 spp, depth 3 gives C = 256 chains, K = 8
mutation steps and 129 bootstrap batches (mlt.chain_counts). The scene is
test_torch_integrators.py's (the reduced bench scene, its emissive quad
black). Both renders run once; wrappers read the bootstrap's categorical
draw (searchsorted) and the film's scale b R / (K C) out of each.

Tolerances: the bootstrap's b within 1%; each chain's resampled start
(the bootstrap lane it draws) equal on >= 99% of chains; the image mean
within 2%. No per-pixel rule: the JAX anchor intersects watertight, the
port Moller-Trumbore, and one edge flip changes an acceptance, after
which that chain walks elsewhere for every later step.
"""

import numpy as np
import pytest
import torch

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator, mlt as j_mlt
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.wavefront import camera, integrator, mlt

from test_torch_integrators import emitter_scene
from test_torch_render import EYE, TARGET, UP

torch.set_num_threads(1)

W = H = 16
SPP = 8
DEPTH = 3


class _Spy:
    """A module stand-in that records what `searchsorted` returns and
    passes every other attribute through."""

    def __init__(self, mod, picks):
        self._mod, self._picks = mod, picks

    def searchsorted(self, *a, **kw):
        out = self._mod.searchsorted(*a, **kw)
        self._picks.append(np.asarray(out))
        return out

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _render(mp, mod, array_mod_name, render):
    picks, scales = [], []
    mp.setattr(mod, array_mod_name, _Spy(getattr(mod, array_mod_name), picks))
    develop = mod.film_mod.develop

    def spy_develop(film, splat_scale=1.0, **kw):
        scales.append(splat_scale)
        return develop(film, splat_scale=splat_scale, **kw)

    mp.setattr(mod.film_mod, "develop", spy_develop)
    img = np.asarray(render())
    return img, picks, scales


@pytest.fixture(scope="module")
def runs():
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        j = _render(mp, j_mlt, "jnp", lambda: j_mlt.render_mlt(
            sc, dbvh, jcam, spp=SPP, seed=4, cfg=j_integrator.IntegratorConfig(max_depth=DEPTH)))
    with pytest.MonkeyPatch.context() as mp:
        t = _render(mp, mlt, "torch", lambda: mlt.render_mlt(
            tsc, tbvh, tcam, spp=SPP, seed=4,
            cfg=integrator.IntegratorConfig(max_depth=DEPTH)).numpy())
    return j, t


def test_chain_counts():
    assert mlt.chain_counts(SPP, W * H) == (256, 8, 129)
    assert mlt.chain_counts(1, 400 * 400) == (4096, 39, 9)


def test_bootstrap_matches_jax(runs):
    (_, jpicks, jscales), (_, tpicks, tscales) = runs
    assert len(tscales) == len(jscales) == 1
    assert abs(tscales[0] - jscales[0]) <= 0.01 * jscales[0]  # b R / (K C): b within 1%
    assert len(tpicks) == len(jpicks) == 1
    tp, jp = tpicks[0], np.clip(jpicks[0], 0, 255)
    assert tp.shape == jp.shape == (256,)
    assert (tp == jp).mean() >= 0.99, (tp == jp).mean()
    assert len(np.unique(tp)) > 20  # the draw spreads over many bootstrap lanes


def test_image_mean_matches_jax(runs):
    img_j, img_t = runs[0][0], runs[1][0]
    assert img_t.shape == img_j.shape == (H, W, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.02 * img_j.mean()
