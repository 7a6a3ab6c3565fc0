"""The port's BDPT (wavefront/bdpt.py) against the JAX package on the CPU:
the MIS weight of every (s, t) strategy per lane, each wave's per-pixel L
and camera splats, and render_bdpt's image.

The scene is test_torch_lightpath.py's (the reduced bench scene with a
black emissive quad, a point light and an analytic sphere light), 16x16,
depth 2, 2 spp, the independent sampler. Both packages' renders run once:
the JAX one jitted, each MIS weight, per-pixel L and splat batch read out
of the jitted wave by jax.debug.callback from wrappers of `_mis_weight`,
`film.add_samples` and `film.add_splats`; the port's through the same
wrappers in Python.

Tolerances: a strategy's MIS weight within atol 1e-4 + rtol 1e-3 (torch's
rsqrt and XLA's may differ by an ulp) on >= 99% of the lanes whose two
connected vertices are real in both packages (the vertices' active flags
equal on >= 98% of lanes: a next-event sample's flag includes the singular
light sample of tests/test_torch_integrators.py's doc; the weight of a
lane without them is never used), leaving out the lanes where a pdf the
weight reads lies in (0, 1e-10) in either package: remap0 maps a pdf of
exactly 0 to 1 and keeps 1e-19 as it is, and a connection at a grazing or
back-facing angle gives 0 in one package and 1e-19 in the other (up to 17%
of a strategy's lanes here, lanes the strategy adds nothing to); per-pixel
L and splat L within atol 1e-3 + rtol 1e-2 on >= 99% of lanes (splat
pixels equal there), their sums within 0.5%; the image: mean within 0.5%,
>= 99% of pixels within atol 1e-3 + rtol 1e-2
(tests/test_torch_render.py's rule: the JAX anchor intersects watertight,
the port Moller-Trumbore, and a lane that flips at an edge diverges).
"""

import numpy as np
import pytest
import torch
import jax

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import (bdpt as j_bdpt, camera as j_camera,
                                  integrator as j_integrator)
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.wavefront import bdpt, camera, integrator

from test_torch_integrators import emitter_scene
from test_torch_lightpath import add_lights
from test_torch_render import EYE, TARGET, UP

torch.set_num_threads(1)

W = H = 16
R = W * H
DEPTH = 2
SPP = 2


def _recording(mp, mod, jax_side: bool):
    """Wrap mod._mis_weight and mod.film_mod's add_samples / add_splats so
    that each call's result (the weight) or arguments (the samples) land in
    the returned dict of lists, in call order."""
    rec = {"w": [], "samples": [], "splats": []}

    def keep(key, *arrays):
        if jax_side:
            jax.debug.callback(lambda *a: rec[key].append([np.asarray(x) for x in a]), *arrays,
                               ordered=True)
        else:
            rec[key].append([x.detach().numpy() for x in arrays])

    mis, add_samples, add_splats = mod._mis_weight, mod.film_mod.add_samples, \
        mod.film_mod.add_splats

    def mis_weight(cam, lig, t_s, s, cam_rev, lig_rev, light_delta0):
        w = mis(cam, lig, t_s, s, cam_rev, lig_rev, light_delta0)
        # the pdfs the weight reads, as _mis_weight reads them
        pdfs = ([cam_rev.get(i, cam[i].pdf_rev) for i in range(t_s)]
                + [cam[i].pdf_fwd for i in range(t_s)]
                + [lig_rev.get(i, lig[i].pdf_rev) for i in range(s)]
                + [lig[i].pdf_fwd for i in range(s)])
        cliff = sum(((p > 0) & (p < 1e-10)) * 1 for p in pdfs) > 0
        # the lanes whose two connected vertices are real
        live = (cam[t_s - 1].active if t_s else True) & (lig[s - 1].active if s else True)
        keep("w", w, cliff, live)
        return w

    def samples(f, pix, L, lam, lam_pdf, **kw):
        keep("samples", L)
        return add_samples(f, pix, L, lam, lam_pdf, **kw)

    def splats(f, pix, L, lam, lam_pdf):
        keep("splats", pix, L)
        return add_splats(f, pix, L, lam, lam_pdf)

    mp.setattr(mod, "_mis_weight", mis_weight)
    mp.setattr(mod.film_mod, "add_samples", samples)
    mp.setattr(mod.film_mod, "add_splats", splats)
    return rec


@pytest.fixture(scope="module")
def runs():
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene, add_lights))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        jrec = _recording(mp, j_bdpt, True)
        img_j = np.asarray(j_bdpt.render_bdpt(
            sc, dbvh, jcam, spp=SPP, seed=1, cfg=j_integrator.IntegratorConfig(max_depth=DEPTH)))
        jax.effects_barrier()
        trec = _recording(mp, bdpt, False)
        img_t = bdpt.render_bdpt(tsc, tbvh, tcam, spp=SPP, seed=1,
                                 cfg=integrator.IntegratorConfig(max_depth=DEPTH)).numpy()
    return jrec, trec, img_j, img_t


def lanes_close(got, want):
    return np.isclose(got, want, atol=1e-3, rtol=1e-2).reshape(got.shape[0], -1).all(-1)


def test_every_strategy_weight_matches_jax(runs):
    jrec, trec = runs[:2]
    assert len(trec["w"]) == len(jrec["w"]) > SPP * 6
    n_lanes = 0
    for k, ((jw, jcliff, jlive), (tw, tcliff, tlive)) in enumerate(zip(jrec["w"], trec["w"])):
        assert tw.shape == jw.shape == (R,)
        assert np.isfinite(tw).all() and ((tw > 0) & (tw <= 1)).all()
        assert (tlive == jlive).mean() >= 0.98, (k, (tlive == jlive).mean())
        lanes = tlive & jlive & ~(jcliff | tcliff)
        assert lanes.sum() >= 4, (k, lanes.sum())
        n_lanes += lanes.sum()
        ok = np.isclose(tw, jw, atol=1e-4, rtol=1e-3)[lanes]
        assert ok.mean() >= 0.99, (k, ok.mean())
    assert n_lanes >= 500
    # the weights are not all 1: the strategies share their paths
    assert min(float(w[live].min()) for w, _, live in trec["w"]) < 0.5


def test_wave_pixels_and_splats_match_jax(runs):
    jrec, trec = runs[:2]
    assert len(trec["samples"]) == len(jrec["samples"]) == SPP
    for (jL,), (tL,) in zip(jrec["samples"], trec["samples"]):
        assert lanes_close(tL, jL).mean() >= 0.99
        assert abs(tL.sum() - jL.sum()) <= 0.005 * jL.sum()
    assert len(trec["splats"]) == len(jrec["splats"]) == SPP
    for (jpix, jL), (tpix, tL) in zip(jrec["splats"], trec["splats"]):
        assert tpix.shape == jpix.shape == (R * DEPTH,)
        same = (tpix == jpix) & lanes_close(tL, jL)
        assert same.mean() >= 0.99, same.mean()
        assert abs(tL.sum() - jL.sum()) <= 0.005 * jL.sum()
        assert (tL > 0).any() and (tpix[~(tL > 0).any(-1)] == 0).all()


def test_render_bdpt_matches_jax(runs):
    img_j, img_t = runs[2:]
    assert img_t.shape == img_j.shape == (H, W, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


def test_infinite_lights_start_no_light_subpath():
    """A reference fault the port mirrors: an infinite light starts no
    light subpath (sample_le gives it no throughput), so in a scene lit
    only by the sky BDPT splats nothing and its light comes from the
    camera subpath's escaped rays and next-event samples alone."""
    b = scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_sphere((0, 1, 0), 1.0, m, n_theta=8, n_phi=16)
    b.add_uniform_infinite_light((0.8, 0.9, 1.0))
    from nn_bvh_tpu_torch import accel

    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    tsc = scene.to_device(sc, "cpu")
    cam = camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=8, height=8)
    from nn_bvh_tpu_torch.core import samplers

    out = bdpt.trace_bdpt_wave(tsc, dbvh, cam, samplers.make_sampler("independent", spp=1),
                               integrator.IntegratorConfig(max_depth=DEPTH),
                               torch.arange(64, dtype=torch.int32), 0)
    L, splat_L = out[0], out[4]
    assert float(L.mean()) > 0 and splat_L.shape[0] == 64 * DEPTH
    assert float(splat_L.abs().max()) == 0.0
