"""Driver of the joint mixes: steps of the joint render + treeNet learner
(learn.joint.make_joint_step) back to back, a closed loop.

Parameters (traffic/<mix>.json): `render_config`, the configuration file
of the scene, integrator and sampler the render branch runs; `width`,
`height` of the rendered image (one sample a pixel a step, the sample
index advancing with the step); `pool` batches of clouds made on the card
from the seed, which the tree branch takes in turn; `lr` and
`tree_weight` of the step; `trace_steps` steps in the traced stretch. The
cell's configuration is the learner's.

Set-up builds the scene and its BVH, makes the tree weights and clouds on
the card from the seed, builds one joint state (the model and the scene's
material coefficients as a leaf) and one step function, and drives that
state through its first three steps, which warm every kernel and are the
steps the reference follows. The window runs steps on the same state
until its time has run out, each closed by a synchronize.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

N_CHECKED = 3


def run(ctx) -> dict:
    import torch

    from harness import device as device_mod, geometry, learner, spec, trace as tr
    from reference import joint as ref_joint, path as ref_path
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.learn import encoder as enc_mod, joint, treenet
    from nn_bvh_tpu_torch.scatter import lightsamplers

    cfg, tf = ctx.config, ctx.traffic
    rc = spec.read_json(os.path.join(spec.BENCH_DIR, "configs", f"{tf['render_config']}.json"))
    d = device_mod.open_device(torch, ctx)
    dev = d.dev
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tcfg = learner.tree_config(treenet, cfg)
    B, W, H, spp = int(cfg["batch"]), int(tf["width"]), int(tf["height"]), int(rc["spp"])
    integ = rc["integrator"]

    sc, dbvh, cam, icfg, c2w = geometry.program_scene(rc, W, H)
    scfg = samplers.make_sampler(rc["sampler"], seed=ctx.seed, spp=spp)
    scene_d = scene_mod.to_device(sc, dev)
    ls = lightsamplers.build(scene_d, icfg.light_sampler, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    weights = learner.make_weights(torch, cfg, gen, dev)
    pool = learner.make_clouds(torch, geometry.cloud_rule(cfg["pc_size"]), int(tf["pool"]) * B,
                               gen, dev).reshape(int(tf["pool"]), B, cfg["pc_size"], 9)
    model = treenet.TreeNet(tcfg, [enc_mod.Encoder({k: v.clone() for k, v in w.items()})
                                   for w in weights])
    state = joint.JointState(model, scene_d.mat_coeffs.detach().clone().requires_grad_(True))
    step = joint.make_joint_step(tcfg, cam, scfg, icfg, lr=float(tf["lr"]),
                                 tree_weight=float(tf["tree_weight"]))
    run_step = lambda st, i: step(st, scene_d, None, ls, pool[i % pool.shape[0]], pix, i % spp,
                                  isect)[0]

    # set-up: the first steps, which the reference follows
    got = {"loss": [], "gnorm_tree": [], "gnorm_mat": []}
    mc0 = state.mat_coeffs.detach().clone()
    for i in range(N_CHECKED):
        state, m = step(state, scene_d, None, ls, pool[i], pix, i % spp, isect)
        for k in got:
            got[k].append(float(m[k]))
    delta = {f"{l}.{k}": p.detach() - weights[l][k]
             for l, e in enumerate(model.encoders) for k, p in e.named_parameters()}
    delta["mat"] = state.mat_coeffs.detach() - mc0
    d.sync()
    if d.cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    setup_s = time.time() - ctx.t0
    state, n, window_s = learner.run_window(run_step, state, N_CHECKED, ctx.seconds, d.sync)
    rec = {"unit": "step", "setup_s": setup_s, "window_s": window_s, "steps": n}
    rec["device"] = device_mod.info(torch, d, 1, device_mod.peak_bytes(torch, d))
    if ctx.trace and d.cuda:
        nt = int(tf["trace_steps"])
        state, summ = learner.traced_steps(torch, tr, run_step, state, nt)
        rec.update(trace=summ, trace_units=nt)
        rec["device"].update(busy_s=summ["busy_s"], window_s=summ["span_s"])

    # the reference follows the first steps from the same weights and clouds
    del state, model, step, run_step, scene_d, ls, isect
    if d.cuda:
        torch.cuda.empty_cache()
    rsc = ref_path.Scene(geometry.triangles(), geometry.MATERIALS,
                         (geometry.CONDUCTOR_ETA, geometry.CONDUCTOR_K), dev, bvh=True)
    camd = dict(cam_to_world=c2w, fov=rc["camera"]["fov"], width=W, height=H)
    t_ref = time.perf_counter()
    want = ref_joint.train(weights, cfg, rsc, camd, ctx.seed, spp,
                           [i % spp for i in range(N_CHECKED)],
                           [pool[i] for i in range(N_CHECKED)], float(tf["lr"]),
                           float(tf["tree_weight"]), integ["max_depth"], integ["rr_depth"])
    print(f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr, flush=True)
    rec["checks"] = compare(got, delta, want, ctx.cell["check"])
    rec["attempted"], rec["failed"] = n, 0
    return rec


def compare(got: dict, delta: dict, want: dict, check: dict) -> list:
    """[name, value, limit] of: the largest relative gap of a step's loss;
    the largest relative gap of a step's gradient norm (the tree's, the
    coefficients'); the largest gap, over the tree's leaves and the
    coefficients, between the norms of the change after the steps, each
    over the larger of the reference leaf's norm and the median leaf's."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss_gap = max(rel(a, b) for a, b in zip(got["loss"], want["loss"]))
    grad_gap = max(rel(a, b) for k in ("gnorm_tree", "gnorm_mat")
                   for a, b in zip(got[k], want[k]))
    d_ref = {k: float(v.norm()) for k, v in want["delta"].items()}
    d_med = statistics.median(d_ref.values())
    delta_gap = max(abs(float(delta[k].norm()) - d_ref[k]) / max(d_ref[k], d_med, 1e-30)
                    for k in d_ref)
    return [["loss_gap", loss_gap, float(check["loss_gap"])],
            ["grad_gap", grad_gap, float(check["grad_gap"])],
            ["delta_gap", delta_gap, float(check["delta_gap"])]]
