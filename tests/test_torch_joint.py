"""The port's joint render+train step (nn_bvh_tpu_torch/learn/joint.py) on
the CPU.

The scene of tests/test_joint.py:18-33 (a diffuse sphere on a floor under
a two-sided area light, 8x8), built by the JAX package and carried across
as numpy, and its tree configuration (levels 2, capacity 8, a cloud of 32
primitives) with weights carried from JAX's init_params.

- scene_cloud: bit-identical to the JAX package's.
- rebuild_scene_with_predicted_tree: JAX's prim_order for the same weights.
- The joint step: the tree branch's gradients against jax.grad of the JAX
  treenet.loss_fn on the same clouds (within 1e-3 of each tensor's largest
  |g|, test_torch_learn's rule); the render branch's gradient equal (rtol
  1e-6) to the port's own torch.autograd.grad through trace_wave, which
  tests/test_torch_grad.py holds against jax.grad; the update is plain SGD
  with those gradients; over a mesh of one rank it is the same step. No
  JAX joint program is compiled: it takes minutes on the CPU
  (tests/test_torch_dp.py holds the two-rank step).
- An image through a plane tree's BVH (greedy planes, and planes predicted
  by the carried weights) within 1e-4 of the SAH BVH's
  (tests/test_learn.py:281-323, tests/test_joint.py:67-82).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.learn import joint as j_joint, treenet as j_treenet
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene, transform as xf
from nn_bvh_tpu_torch.learn import data, export, joint, tree_eval, treenet
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

J_CFG = j_treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
CFG = treenet.TreeNetConfig(**J_CFG._asdict())
RES = 8


def host_scene(jsc):
    """A JAX CompiledScene -> the port's host CompiledScene (numpy)."""
    f = {k: (None if v is None else v if np.isscalar(v) else np.asarray(v))
         for k, v in jsc._asdict().items()}
    scene.check_slice(f)
    return scene.CompiledScene(**{k: f[k] for k in scene.CompiledScene._fields})


@pytest.fixture(scope="module")
def tiny():
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    jsc, _, _ = j_accel.build_scene_bvh(b.build())
    cam = camera.make_perspective(j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)),
                                  fov=45.0, width=RES, height=RES)
    jp = j_treenet.init_params(J_CFG, jax.random.PRNGKey(0))
    model = treenet.params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return dict(jsc=jsc, sc=host_scene(jsc), cam=cam, jp=jp, model=model)


def test_scene_cloud_is_bit_identical(tiny):
    for pc, batch, seed in ((32, 2, 0), (256, 3, 5)):
        np.testing.assert_array_equal(joint.scene_cloud(tiny["sc"], pc, batch, seed),
                                      j_joint.scene_cloud(tiny["jsc"], pc, batch, seed))


@pytest.fixture(scope="module")
def rebuilt(tiny):
    return joint.rebuild_scene_with_predicted_tree(tiny["sc"], tiny["model"], CFG,
                                                   pc_size=CFG.pc_size)


def test_rebuild_gives_jax_prim_order(tiny, rebuilt):
    _, _, jbvh = j_joint.rebuild_scene_with_predicted_tree(tiny["jsc"], tiny["jp"], J_CFG,
                                                           pc_size=J_CFG.pc_size)
    np.testing.assert_array_equal(rebuilt[2].prim_order, np.asarray(jbvh.prim_order))
    assert sorted(rebuilt[2].prim_order.tolist()) == list(range(tiny["sc"].n_tris))


@pytest.fixture(scope="module")
def joint_setup(tiny, rebuilt):
    sc2, dbvh2, _ = rebuilt
    tsc = scene.to_device(sc2, "cpu")
    return dict(
        tsc=tsc, dbvh=dbvh2, lst=lightsamplers.build(tsc, "power", "cpu"),
        scfg=samplers.make_sampler("independent", seed=0, spp=2),
        rcfg=integrator.IntegratorConfig(max_depth=1, mis=True),
        clouds=joint.scene_cloud(sc2, CFG.pc_size, batch=2),
        pix=torch.arange(RES * RES, dtype=torch.int32))


def joint_grads(tiny, js, model, mc):
    loss_fn = joint.make_joint_loss(CFG, tiny["cam"], js["scfg"], js["rcfg"])
    state = joint.JointState(model, mc)
    loss, aux = loss_fn(state, js["tsc"], js["dbvh"], js["lst"], torch.as_tensor(js["clouds"]),
                        js["pix"], 0)
    return loss, aux, torch.autograd.grad(loss, list(model.parameters()) + [mc])


def test_joint_gradients(tiny, joint_setup):
    js = joint_setup
    model = tiny["model"]
    mc = js["tsc"].mat_coeffs.detach().clone().requires_grad_(True)
    loss, aux, grads = joint_grads(tiny, js, model, mc)
    assert np.isfinite(loss.item()) and aux["image_loss"].item() > 0
    g_tree, g_mat = grads[:-1], grads[-1]

    # tree branch: jax.grad of the JAX package's treenet.loss_fn
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, c: j_treenet.loss_fn(p, J_CFG, c), has_aux=True))(
        tiny["jp"], jnp.asarray(js["clouds"]))
    np.testing.assert_allclose(aux["tree_loss"].item(), float(j_loss), rtol=1e-4)
    names = [(l, n) for l, e in enumerate(model.encoders) for n in
             ("vert", "w1", "w2", "w3", "r1", "r2", "r3") if getattr(e, n) is not None]
    for (l, n), g in zip(names, g_tree):
        want = np.asarray(getattr(j_grads[l], n))
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-3 * float(np.abs(want).max()), (l, n, err)
    assert sum(float(g.abs().sum()) for g in g_tree) > 0

    # render branch: the port's own gradient through trace_wave
    mc2 = js["tsc"].mat_coeffs.detach().clone().requires_grad_(True)
    cam = tiny["cam"]
    L, lam, pdf, fw = integrator.trace_wave(js["tsc"].replace(mat_coeffs=mc2), js["dbvh"], cam,
                                            js["scfg"], js["rcfg"], js["pix"], 0, js["lst"])
    f = film.add_samples(film.make_film(RES, RES, "cpu"), js["pix"], L, lam, pdf,
                         filter_weight=fw)
    (want,) = torch.autograd.grad(f.xyz.sum() / (RES * RES), mc2)
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(g_mat.numpy(), want.numpy(), rtol=1e-6, atol=0)


def test_joint_step_updates_both_branches(tiny, joint_setup):
    js = joint_setup
    model = treenet.params_from_jax(jax.tree.map(np.asarray, tiny["jp"]), CFG, device="cpu")
    mc = js["tsc"].mat_coeffs.detach().clone().requires_grad_(True)
    _, _, grads = joint_grads(tiny, js, model, mc)
    before = [p.detach().clone() for p in model.parameters()]
    lr = 1e-3
    step = joint.make_joint_step(CFG, tiny["cam"], js["scfg"], js["rcfg"], lr=lr)
    new, m = step(joint.JointState(model, mc), js["tsc"], js["dbvh"], js["lst"],
                  torch.as_tensor(js["clouds"]), js["pix"], 0)
    m = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in m.values()), m
    assert m["image_loss"] > 0 and m["gnorm_tree"] > 0 and m["gnorm_mat"] > 0, m
    np.testing.assert_allclose(m["gnorm_tree"], float(torch.sqrt(sum(
        (g * g).sum() for g in grads[:-1]))), rtol=1e-6)
    for p, p0, g in zip(new.model.parameters(), before, grads[:-1]):
        np.testing.assert_allclose(p.detach().numpy(), (p0 - lr * g).numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert any(not torch.equal(p, p0) for p, p0 in zip(new.model.parameters(), before))
    np.testing.assert_allclose(new.mat_coeffs.detach().numpy(),
                               (mc - lr * grads[-1]).detach().numpy(), rtol=1e-6)
    assert new.mat_coeffs.requires_grad and new.mat_coeffs.is_leaf
    assert float((new.mat_coeffs - mc).detach().abs().max()) > 0
    # over a mesh of one rank (dist.sharding) the step is the same step
    from nn_bvh_tpu_torch.dist import sharding

    model1 = treenet.params_from_jax(jax.tree.map(np.asarray, tiny["jp"]), CFG, device="cpu")
    mc1 = js["tsc"].mat_coeffs.detach().clone().requires_grad_(True)
    step1 = joint.make_joint_step(CFG, tiny["cam"], js["scfg"], js["rcfg"], lr=lr,
                                  mesh=sharding.make_mesh(device="cpu"))
    new1, m1 = step1(joint.JointState(model1, mc1), js["tsc"], js["dbvh"], js["lst"],
                     torch.as_tensor(js["clouds"]), js["pix"], 0)
    assert {k: float(v) for k, v in m1.items()} == m
    assert all(torch.equal(a, b) for a, b in zip(new1.model.parameters(), new.model.parameters()))
    assert torch.equal(new1.mat_coeffs, new.mat_coeffs)
    with pytest.raises(ValueError, match="one axis"):
        joint.make_joint_step(CFG, tiny["cam"], js["scfg"], js["rcfg"], axis="batch")


def render(sc, dbvh, cam, cfg):
    return integrator.render(sc, dbvh, cam, spp=2, sampler="independent", cfg=cfg,
                             device="cpu").numpy()


def test_predicted_tree_renders_identically(tiny, rebuilt):
    """tests/test_joint.py's test_rebuild_through_predicted_tree_renders:
    the SAH scene and the predicted tree's scene give the same image."""
    sc, dbvh, _ = accel.build_scene_bvh(tiny["sc"])
    sc2, dbvh2, _ = rebuilt
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True)
    img_a, img_b = render(sc, dbvh, tiny["cam"], cfg), render(sc2, dbvh2, tiny["cam"], cfg)
    assert img_a.mean() > 0
    np.testing.assert_allclose(img_a, img_b, atol=1e-4, rtol=1e-4)


def test_plane_tree_bvh_renders_identically():
    """tests/test_learn.py's test_predicted_tree_renders_identically through
    the port: a blob field under a quad light, greedy planes (the plane
    tree format treeNet predicts) -> planes_to_bvh -> the same image as the
    SAH BVH, atol 1e-4."""
    blobs = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=21)
    tris = data.prims_to_tris(blobs.base_cloud())
    b = scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    verts = tris.reshape(-1, 3)
    b.add_mesh(verts, np.arange(len(verts)).reshape(-1, 3), m)
    b.add_quad((1, 3.5, 1), (2, 3.5, 1), (2, 3.5, 2), (1, 3.5, 2), m,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    sc = b.build()
    cam = camera.make_perspective(xf.look_at((1.5, 1.5, -2.0), (1.5, 1.5, 1.5), (0, 1, 0)),
                                  fov=50.0, width=16, height=16)
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=99)
    sc_sah, dbvh_sah, _ = accel.build_scene_bvh(sc)
    all_tris = np.asarray(sc.tri_p[:sc.n_tris])
    planes = tree_eval.greedy_tree(data.tris_to_prims(all_tris), levels=4)
    sc_l, dbvh_l, bvh_l = accel.apply_bvh_to_scene(sc, export.planes_to_bvh(all_tris, planes))
    assert not np.array_equal(bvh_l.prim_order, np.arange(sc.n_tris))
    img_sah = integrator.render(sc_sah, dbvh_sah, cam, spp=2, cfg=cfg, device="cpu").numpy()
    img_l = integrator.render(sc_l, dbvh_l, cam, spp=2, cfg=cfg, device="cpu").numpy()
    assert img_sah.mean() > 0
    np.testing.assert_allclose(img_l, img_sah, atol=1e-4)
