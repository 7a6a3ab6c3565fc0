"""Plain reference of the joint render + treeNet step: one loss, the image
term (the summed XYZ of one Path sample at every pixel, over the pixel
count, differentiated with respect to the material coefficients through
shading; visibility carries no gradient) plus the tree term
(treenet.loss), one gradient over both, and a plain SGD update of the tree
weights and the material coefficients.

It imports torch, numpy and the other references only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import path, treenet


def train(weights: list, tree_cfg: dict, sc: path.Scene, cam: dict, seed: int, spp: int,
          samples: list, batches: list, lr: float, tree_weight: float, max_depth: int,
          rr_depth: int, tf32: bool = False) -> dict:
    """SGD steps from `weights` (per-level dicts, left unchanged) and the
    scene's own material coefficients, step i rendering every pixel at
    sample index samples[i] and training the tree on batches[i] ->
    {"loss", "gnorm_tree", "gnorm_mat": per step, "delta": {name: change}}
    with the tree leaves as "<level>.<weight>" and the coefficients as
    "mat"."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = [{k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
                  for w in weights]
        flat = [p for w in params for p in w.values()]
        mc0 = sc.mat_coeffs.detach().clone()
        mc = mc0.clone().requires_grad_(True)
        n_pix = cam["width"] * cam["height"]
        pix = np.arange(n_pix, dtype=np.int64)
        smpl = path.Sampler(seed, spp)
        out = {"loss": [], "gnorm_tree": [], "gnorm_mat": []}
        for s, clouds in zip(samples, batches):
            sc.mat_coeffs = mc
            xyz = path.sample_xyz(sc, cam, pix, np.full(n_pix, s, np.int64), smpl, max_depth,
                                  rr_depth)
            loss = xyz.sum() / n_pix + tree_weight * treenet.loss(params, tree_cfg, clouds)
            grads = torch.autograd.grad(loss, flat + [mc], allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat + [mc], grads)]
            with torch.no_grad():
                for p, g in zip(flat, grads[:-1]):
                    p -= lr * g
                mc = (mc - lr * grads[-1]).requires_grad_(True)
            out["loss"].append(float(loss.detach()))
            out["gnorm_tree"].append(float(torch.sqrt(sum((g * g).sum() for g in grads[:-1]))))
            out["gnorm_mat"].append(float(torch.sqrt((grads[-1] ** 2).sum())))
        out["delta"] = {f"{l}.{k}": (params[l][k] - p0).detach()
                        for l, w in enumerate(weights) for k, p0 in w.items()}
        out["delta"]["mat"] = (mc - mc0).detach()
        sc.mat_coeffs = mc0
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
