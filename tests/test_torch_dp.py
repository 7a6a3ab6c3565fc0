"""Data-parallel learning over torch.distributed on the CPU: the treeNet
train step (learn/trainer.py make_train_step(mesh=)) and the joint
render+train step (learn/joint.py make_joint_step(mesh=)), each run by two
gloo processes (dist.multihost.run_local) and held against a reference.

- The train step against JAX's make_train_step on a 2-device Mesh
  (conftest's virtual CPU devices), weights carried across
  (treenet.params_from_jax), batch 4 split 2 + 2, the JAX step given
  optax.sgd(1) so that its update is its gradient: the loss and metrics
  within rtol 1e-4 of JAX's pmean'd ones; the gradients within 1e-3 of
  each tensor's largest |g| (chip_smoke phase 18's rule) of JAX's. JAX's
  gradient is the sum of the two halves' (shard_map sums the gradient of
  a replicated input, then the step's pmean keeps that sum): twice the
  single-process gradient of the whole batch, which the port's equals
  within rtol 1e-5. Mirrored (ROADMAP queue 3).
- The joint step (the scene of __graft_entry__._tiny_scene at 16x16,
  depth 2, Sobol 4 spp, tree levels 3 / capacity 16 / 64 prims) against
  the port's own single-process loss and gradients on each rank's half:
  the losses averaged, the gradients summed (JAX's step, as above); the
  metrics and the updated weights within rtol 1e-6 (the same float32
  operations). test_torch_joint.py holds that loss's branches against
  JAX. The JAX shard-mapped step of __graft_entry__.dryrun_multichip (the
  `slow` test) takes 160 s to compile on the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from nn_bvh_tpu.learn import trainer as j_trainer, treenet as j_treenet
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.dist import multihost
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.learn import data, joint, treenet
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.wavefront import integrator

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(__file__), "..")

J_CFG = j_treenet.TreeNetConfig(levels=3, capacity=16, pc_size=64, epo=True,
                                learning_rate=3e-4)
CFG = treenet.TreeNetConfig(**J_CFG._asdict())
RES = 16

WORKER = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.dist import multihost, sharding
from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
from nn_bvh_tpu_torch.learn import joint, trainer, treenet
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

mode, d = sys.argv[1], sys.argv[2]
cfg = treenet.TreeNetConfig(**torch.load(os.path.join(d, "cfg.pt")))
assert multihost.initialize(timeout_s=120)
mesh = sharding.make_mesh(device="cpu")
model = treenet.init_params(cfg, 0, "cpu")
model.load_state_dict(torch.load(os.path.join(d, "weights.pt")))
out = {}
if mode == "train":
    state = trainer.TrainState(model, trainer.make_optimizer(model, cfg), 0)
    clouds = torch.as_tensor(np.load(os.path.join(d, "clouds.npy")))
    state, metrics = trainer.make_train_step(cfg, mesh)(state, clouds)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = [p.grad.clone() for p in model.parameters()]
else:
    exec(open(os.path.join(d, "scene.py")).read())
    sc, dbvh, cam = tiny_scene(scene_mod, accel, xf, camera_mod)
    sc2, dbvh2, _ = joint.rebuild_scene_with_predicted_tree(sc, model, cfg, pc_size=cfg.pc_size)
    tsc = scene_mod.to_device(sc2, "cpu")
    rcfg = integrator.IntegratorConfig(max_depth=2, mis=True)
    scfg = samplers.make_sampler("sobol", seed=0, spp=4)
    clouds = torch.as_tensor(joint.scene_cloud(sc2, cfg.pc_size, batch=2))
    st = joint.JointState(model, tsc.mat_coeffs.clone().requires_grad_(True))
    step = joint.make_joint_step(cfg, cam, scfg, rcfg, mesh=mesh, axis=sharding.RAY_AXIS)
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32)
    new, metrics = step(st, tsc, dbvh2, lightsamplers.build(tsc, rcfg.light_sampler, "cpu"),
                        clouds, pix, 0)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["mat_coeffs"] = new.mat_coeffs.detach().clone()
out["params"] = [p.detach().clone() for p in model.parameters()]
if mesh.rank == 0:
    torch.save(out, os.path.join(d, mode + ".pt"))
torch.distributed.barrier()
'''

# __graft_entry__._tiny_scene for either package
SCENE_SRC = r'''
def tiny_scene(scene_mod, accel, xf, camera_mod, res=16):
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    mm = b.add_material("conductor", reflectance=(0.9, 0.7, 0.4), roughness=0.1)
    b.add_sphere((0, 0.6, 0), 0.6, mm, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0, width=res, height=res)
    return sc, dbvh, cam
'''
exec(SCENE_SRC)


def run_workers(d, mode, model):
    """The worker in `mode` on two gloo ranks, the weights `model`'s -> its
    rank-0 output."""
    (d / "worker.py").write_text(WORKER)
    (d / "scene.py").write_text(SCENE_SRC)
    torch.save(CFG._asdict(), d / "cfg.pt")
    torch.save(model.state_dict(), d / "weights.pt")
    outs = multihost.run_local([sys.executable, str(d / "worker.py"), mode, str(d)], 2,
                               timeout_s=300, env=dict(os.environ, OMP_NUM_THREADS="1"),
                               cwd=REPO)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    return torch.load(d / f"{mode}.pt")


def carried_weights(key: int = 0):
    jp = j_treenet.init_params(J_CFG, jax.random.PRNGKey(key))
    return jp, treenet.params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def test_train_step_over_two_ranks_matches_jax_mesh(tmp_path):
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices (conftest sets XLA_FLAGS)")
    jp, model = carried_weights()
    sc = data.random_scene(seed=0)
    sc.pc_size = CFG.pc_size
    sc.__post_init__()
    clouds = sc.next_batch(4)
    np.save(tmp_path / "clouds.npy", clouds)
    got = run_workers(tmp_path, "train", model)

    import optax

    sgd = optax.sgd(1.0)   # the update is minus the step's gradient
    state = j_trainer.TrainState(jp, sgd.init(jp), 0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
    new, j_metrics = j_trainer.make_train_step(J_CFG, sgd, mesh)(state, jnp.asarray(clouds))
    assert sorted(got["metrics"]) == sorted(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, err_msg=k)
    for g, p0, p1 in zip(got["grads"], jax.tree_util.tree_leaves(jp),
                         jax.tree_util.tree_leaves(new.params)):
        want = np.asarray(p0) - np.asarray(p1)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-3 * float(np.abs(want).max()), err
    assert sum(float(g.abs().sum()) for g in got["grads"]) > 0

    # the sum of the halves: twice the whole batch's single-process gradient
    loss, _ = treenet.loss_fn(model, CFG, torch.as_tensor(clouds))
    for g, whole in zip(got["grads"], torch.autograd.grad(loss, list(model.parameters()))):
        np.testing.assert_allclose(g.numpy(), 2 * whole.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(whole.abs().max()))


def test_joint_step_over_two_ranks_sums_the_halves_gradients(tmp_path):
    from nn_bvh_tpu_torch import accel
    from nn_bvh_tpu_torch.geometry import transform as xf
    from nn_bvh_tpu_torch.wavefront import camera

    model = treenet.init_params(CFG, 0, "cpu")
    got = run_workers(tmp_path, "joint", model)

    sc, dbvh, cam = tiny_scene(scene, accel, xf, camera)
    sc2, dbvh2, _ = joint.rebuild_scene_with_predicted_tree(sc, model, CFG, pc_size=CFG.pc_size)
    tsc = scene.to_device(sc2, "cpu")
    rcfg = integrator.IntegratorConfig(max_depth=2, mis=True)
    loss_fn = joint.make_joint_loss(CFG, cam, samplers.make_sampler("sobol", seed=0, spp=4),
                                    rcfg)
    lst = lightsamplers.build(tsc, rcfg.light_sampler, "cpu")
    clouds = torch.as_tensor(joint.scene_cloud(sc2, CFG.pc_size, batch=2))
    pix = torch.arange(RES * RES, dtype=torch.int32)
    mc = tsc.mat_coeffs.clone().requires_grad_(True)
    params = list(model.parameters())
    parts = []
    for r in range(2):
        loss, aux = loss_fn(joint.JointState(model, mc), tsc, dbvh2, lst, clouds[r:r + 1],
                            pix[r * 128:(r + 1) * 128], 0)
        grads = torch.autograd.grad(loss, params + [mc])
        parts.append([loss, aux["image_loss"], aux["tree_loss"], *grads])
    mean = [(a.detach() + b.detach()) / 2 for a, b in zip(*parts)][:3]
    gsum = [a + b for a, b in zip(*[q[3:] for q in parts])]
    m = got["metrics"]
    for k, want in zip(("loss", "image_loss", "tree_loss"), mean):
        np.testing.assert_allclose(m[k], float(want), rtol=1e-6, err_msg=k)
    # each rank's image term is its band's film over the full 16x16 (mirrored)
    assert 0 < m["image_loss"] < float(mean[1] * 2)
    lr = 1e-3
    for p, g, new in zip(params, gsum[:-1], got["params"]):
        np.testing.assert_allclose(new.numpy(), (p.detach() - lr * g).numpy(), rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(got["mat_coeffs"].numpy(), (mc.detach() - lr * gsum[-1]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(m["gnorm_mat"], float(torch.sqrt((gsum[-1] ** 2).sum())),
                               rtol=1e-6)
    assert m["gnorm_tree"] > 0 and m["gnorm_mat"] > 0


@pytest.mark.slow
def test_joint_step_over_two_ranks_matches_graft_entry(tmp_path):
    """Against __graft_entry__.dryrun_multichip's shard-mapped JAX step on a
    2-device mesh (its compile takes ~160 s here). The tree branch: the
    loss rtol 1e-4, the updated weights within 1e-3 of each tensor's
    largest step (phase 18's rule on lr * g). The render branch crosses
    triangle tests (JAX's watertight, the port's Moller-Trumbore): the
    image loss and the material gradient's norm within 1%, the material
    step within 1e-2 of its largest entry."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices (conftest sets XLA_FLAGS)")
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    import __graft_entry__ as graft
    from nn_bvh_tpu.core import samplers as j_samplers
    from nn_bvh_tpu.dist import sharding as j_sharding
    from nn_bvh_tpu.learn import joint as j_joint
    from nn_bvh_tpu.scatter import lightsamplers as j_lightsamplers
    from nn_bvh_tpu.wavefront import integrator as j_integrator

    jp, model = carried_weights()
    got = run_workers(tmp_path, "joint", model)

    mesh = Mesh(np.array(jax.devices()[:2]), (j_sharding.RAY_AXIS,))
    sc, _, cam = graft._tiny_scene(res=RES)
    scfg = j_samplers.make_sampler("sobol", seed=0, spp=4)
    cfg = j_integrator.IntegratorConfig(max_depth=2, mis=True)
    sc2, dbvh2, _ = j_joint.rebuild_scene_with_predicted_tree(sc, jp, J_CFG, pc_size=64)
    lst = j_lightsamplers.build(sc2, cfg.light_sampler)
    clouds = jnp.asarray(j_joint.scene_cloud(sc2, 64, batch=2))
    state = j_joint.JointState(tree_params=jp, mat_coeffs=jnp.asarray(sc2.mat_coeffs))
    step = j_joint.make_joint_step(J_CFG, cam, scfg, cfg, mesh=mesh, axis=j_sharding.RAY_AXIS)
    rep = lambda t: jax.tree.map(lambda _: P(), t)
    names = {"image_loss": 0, "tree_loss": 0, "loss": 0, "gnorm_tree": 0, "gnorm_mat": 0}
    sharded = jax.jit(partial(
        shard_map, mesh=mesh,
        in_specs=(rep(state), rep((sc2, dbvh2, lst)), P(j_sharding.RAY_AXIS),
                  P(j_sharding.RAY_AXIS)),
        out_specs=(rep(state), rep(names)))(
        lambda st, sb, cl, px: step(st, sb[0], sb[1], sb[2], cl, px, jnp.int32(0))))
    new, jm = sharded(state, (sc2, dbvh2, lst), clouds, jnp.arange(RES * RES, dtype=jnp.int32))
    m = got["metrics"]
    np.testing.assert_allclose(m["tree_loss"], float(jm["tree_loss"]), rtol=1e-4)
    for k in ("image_loss", "gnorm_mat"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-2, err_msg=k)
    for p0, want, g in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(new.tree_params),
                           got["params"]):
        step_w = np.asarray(want) - np.asarray(p0)
        err = float(np.abs((g.numpy() - np.asarray(p0)) - step_w).max())
        assert err <= 1e-3 * max(float(np.abs(step_w).max()), 1e-12), err
    mstep = np.asarray(new.mat_coeffs) - np.asarray(sc2.mat_coeffs)
    err = float(np.abs((got["mat_coeffs"].numpy() - np.asarray(sc2.mat_coeffs)) - mstep).max())
    assert err <= 1e-2 * float(np.abs(mstep).max()), err
