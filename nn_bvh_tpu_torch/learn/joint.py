"""Joint renderer + treeNet training step (port of
nn_bvh_tpu/learn/joint.py).

Gradient topology:
- treeNet weights <- the differentiable SAH/EPO tree cost (the splitter's
  event gradients) over the scene's primitive cloud. Visibility is
  discrete, so the render does not backprop into the planes.
- material coefficients <- the image loss through the wavefront renderer
  (shading gradients; traversal runs without a graph).
- One loss, one autograd pass over (tree weights, mat_coeffs), one plain
  SGD update. The forward render traverses a BVH whose top came from an
  earlier treeNet prediction, rebuilt on the host between outer steps
  (rebuild_scene_with_predicted_tree).
- Over a mesh (dist.sharding.make_mesh) each rank takes its share of the
  clouds and of pixel_idx; the loss and the aux terms are averaged over
  the ranks and both gradient sets summed before the update, as the JAX
  package's shard-mapped step computes them (its pmean of gradients that
  shard_map has already summed). A rank's image loss is its band's film
  sum over the full H*W, so the averaged image term is 1/n of the
  single-process one. Both mirrored (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dist import sharding
from ..geometry import scene as scene_mod
from ..utils import stats
from ..wavefront import film as film_mod, integrator
from . import data as nn_data, export as nn_export, treenet


def scene_cloud(scene, pc_size: int, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, pc_size, 9) primitive clouds from a compiled scene's triangles
    (stride-sampled, per-batch jitter), bit-identical to the JAX package's."""
    # exclude the lane-padding triangles (degenerate zeros past n_tris)
    prims = nn_data.tris_to_prims(scene_mod.host(scene.tri_p)[:scene.n_tris])
    n = len(prims)
    stride = max(1, n // pc_size)
    base = prims[::stride][:pc_size]
    if len(base) < pc_size:
        base = np.concatenate([base, np.repeat(base[-1:], pc_size - len(base), 0)])
    rs = np.random.RandomState(seed)
    ext = np.abs(base).max() + 1e-6
    out = np.stack([
        base + (rs.randn(1, 9) * 0.01 * ext).astype(np.float32) * (b > 0)
        for b in range(batch)
    ])
    return np.asarray(out, np.float32)


class JointState(NamedTuple):
    model: treenet.TreeNet     # the tree weights (the JAX package's tree_params)
    mat_coeffs: torch.Tensor   # (M, 3) leaf tensor with requires_grad


def make_joint_loss(tree_cfg: treenet.TreeNetConfig, cam, sampler_cfg, render_cfg,
                    tree_weight: float = 1.0, target: torch.Tensor | None = None):
    """-> loss(state, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
    isect=None) -> (scalar, aux). `scene` holds tensors on pixel_idx's
    device; `isect` (dispatch.make_intersectors) picks the traversal, by
    default the device's."""
    render_cfg = render_cfg._replace(early_exit=False)  # the JAX package's gradient config

    def loss_fn(state: JointState, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
                isect=None):
        # --- render branch: image loss w.r.t. material coeffs -------------
        with stats.span("joint.render"):
            scn = scene.replace(mat_coeffs=state.mat_coeffs)
            L, lam, lam_pdf, fw = integrator.trace_wave(scn, dbvh, cam, sampler_cfg,
                                                        render_cfg, pixel_idx, sample_idx,
                                                        ls_tables, isect)
            f = film_mod.make_film(cam.height, cam.width, pixel_idx.device)
            f = film_mod.add_samples(f, pixel_idx, L, lam, lam_pdf, filter_weight=fw)
            if target is None:
                image_loss = f.xyz.sum() / (cam.height * cam.width)
            else:
                image_loss = ((f.xyz - target) ** 2).mean()

        # --- treeNet branch: differentiable SAH/EPO tree cost -------------
        with stats.span("joint.tree"):
            tree_loss, _ = treenet.loss_fn(state.model, tree_cfg, clouds)
        loss = image_loss + tree_weight * tree_loss
        return loss, {"image_loss": image_loss, "tree_loss": tree_loss}

    return loss_fn


def make_joint_step(tree_cfg, cam, sampler_cfg, render_cfg, mesh: sharding.Mesh | None = None,
                    axis: str = sharding.RAY_AXIS, lr: float = 1e-3, tree_weight: float = 1.0,
                    target=None):
    """-> step(state, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
    isect=None) -> (state', metrics). Plain SGD: the tree weights are updated
    in place (as torch.optim does), mat_coeffs becomes a new leaf. With a
    mesh, `clouds` and `pixel_idx` are the whole batch and the step takes
    this rank's share of each; `axis` is the JAX package's mesh axis name,
    and the port's group has the one, sharding.RAY_AXIS. With tracing on
    (utils/stats.py) each step is a unit with the spans step.forward
    (holding the loss's joint.render, the wave's spans within it, and
    joint.tree), step.backward and step.update."""
    if axis != sharding.RAY_AXIS:
        raise ValueError(f"the mesh's one axis is {sharding.RAY_AXIS!r}, not {axis!r}")
    loss_fn = make_joint_loss(tree_cfg, cam, sampler_cfg, render_cfg, tree_weight, target)

    def step(state: JointState, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
             isect=None):
        stats.advance("step")
        with stats.span("step.forward"):
            if mesh is not None:
                clouds = sharding.local_rows(clouds, mesh)
                pixel_idx = sharding.local_rows(pixel_idx, mesh)
            params = list(state.model.parameters())
            loss, aux = loss_fn(state, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
                                isect)
        with stats.span("step.backward"):
            grads = torch.autograd.grad(loss, params + [state.mat_coeffs], allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params + [state.mat_coeffs], grads)]
        with stats.span("step.update"):
            if mesh is not None:
                loss, image_loss, tree_loss = sharding.pmean(
                    [loss, aux["image_loss"], aux["tree_loss"]], mesh)
                aux = {"image_loss": image_loss, "tree_loss": tree_loss}
                grads = sharding.psum(grads, mesh)
            g_tree, g_mat = grads[:-1], grads[-1]
            with torch.no_grad():
                for p, g in zip(params, g_tree):
                    p.sub_(lr * g)
                new_mc = (state.mat_coeffs - lr * g_mat).requires_grad_(True)
                gnorm_tree = torch.sqrt(sum((g * g).sum() for g in g_tree))
                gnorm_mat = torch.sqrt((g_mat ** 2).sum())
            metrics = {k: v.detach() for k, v in aux.items()}
            metrics.update(loss=loss.detach(), gnorm_tree=gnorm_tree, gnorm_mat=gnorm_mat)
        return JointState(state.model, new_mc), metrics

    return step


def rebuild_scene_with_predicted_tree(scene, model: treenet.TreeNet,
                                      tree_cfg: treenet.TreeNetConfig, pc_size: int = 256):
    """Host-side outer step: hard-predict the plane tree for this host scene
    (on the model's device) and rebuild the traversal BVH through it
    (export.planes_to_bvh + accel.apply_bvh_to_scene) -> (scene2, dbvh2,
    bvh2)."""
    from .. import accel

    dev = next(model.parameters()).device
    cloud = scene_cloud(scene, pc_size, batch=1)
    _, planes = treenet.predict_tree(model, tree_cfg, torch.as_tensor(cloud, device=dev))
    tri = scene_mod.host(scene.tri_p)[:scene.n_tris]
    bvh = nn_export.planes_to_bvh(tri, planes[0].cpu().numpy())
    return accel.apply_bvh_to_scene(scene, bvh)
