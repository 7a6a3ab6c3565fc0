"""Driver of the training mixes: Adam steps of the treeNet learner back to
back, a closed loop.

Parameters (traffic/<mix>.json): `pool` distinct batches of clouds made on
the card from the seed, which the steps take in turn; `trace_steps` steps
in the traced stretch. The configuration gives the model, the batch and
the learning rate.

Set-up makes the weights on the card from the seed (He-uniform, the last
layer Glorot-uniform, one draw of a torch.Generator on the card), builds
one training state (model and Adam) and one step function
(learn.trainer.make_train_step), and drives that state through its first
three steps on the pool's first three batches: they warm every kernel and
are the steps the reference follows. The window then runs steps on the
same state until its time has run out, each step closed by a synchronize
(as the learner's data feed, a host-to-device copy a step, closes it).

Clouds follow the learner's data rule (harness/learner.py).
"""

from __future__ import annotations

import statistics
import sys
import time

N_CHECKED = 3


def run(ctx) -> dict:
    import torch

    from harness import device as device_mod, geometry, learner, trace as tr, yardstick
    from reference import treenet as ref
    from nn_bvh_tpu_torch.learn import encoder as enc_mod, trainer, treenet

    cfg, tf = ctx.config, ctx.traffic
    d = device_mod.open_device(torch, ctx)
    # the configuration's precision: float32 products, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tcfg = learner.tree_config(treenet, cfg)
    B, P = int(cfg["batch"]), int(tf["pool"])
    gen = torch.Generator(device=d.dev).manual_seed(ctx.seed)
    weights = learner.make_weights(torch, cfg, gen, d.dev)
    pool = learner.make_clouds(torch, geometry.cloud_rule(cfg["pc_size"]), P * B, gen,
                               d.dev).reshape(P, B, cfg["pc_size"], 9)
    model = treenet.TreeNet(tcfg, [enc_mod.Encoder({k: v.clone() for k, v in w.items()})
                                   for w in weights])
    train_step = trainer.make_train_step(tcfg)
    step = lambda st, i: train_step(st, pool[i % P])[0]
    names = [f"{l}.{k}" for l, w in enumerate(weights) for k in w]

    # set-up: the first steps, which the reference follows
    state = trainer.TrainState(model, trainer.make_optimizer(model, tcfg), 0)
    losses, first_grad = [], None
    for i in range(N_CHECKED):
        state, metrics = train_step(state, pool[i])
        losses.append(float(metrics["loss"]))
        if i == 0:
            # Adam's first moment after one step is 0.1 g; none where no step was made
            first_grad = [state.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / 0.1
                          for p in model.parameters()]
    after = [p.detach().clone() for p in model.parameters()]
    d.sync()
    if d.cuda:
        torch.cuda.reset_peak_memory_stats(d.dev)

    setup_s = time.time() - ctx.t0
    state, n, window_s = learner.run_window(step, state, N_CHECKED, ctx.seconds, d.sync)
    rec = {"unit": "step", "setup_s": setup_s, "window_s": window_s, "steps": n,
           "flops_per_step": yardstick.treenet_step_flops(cfg["levels"], cfg["capacity"],
                                                          cfg["pc_size"], B, cfg["epo"])}
    rec["device"] = device_mod.info(torch, d, 1, device_mod.peak_bytes(torch, d))
    if ctx.trace and d.cuda:
        nt = int(tf["trace_steps"])
        state, summ = learner.traced_steps(torch, tr, step, state, nt)
        rec.update(trace=summ, trace_units=nt)
        rec["device"].update(busy_s=summ["busy_s"], window_s=summ["span_s"])

    # the reference follows the first steps from the same weights and clouds
    del state, model, train_step, step
    if d.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = ref.train(weights, cfg, [pool[i] for i in range(N_CHECKED)])
    deltas = {k: a - weights[int(k.split(".")[0])][k.split(".")[1]]
              for k, a in zip(names, after)}
    gaps = delta_gaps(deltas, want)
    worst = max(gaps, key=gaps.get)
    print(f"reference {time.perf_counter() - t_ref:.2f} s; the steps' loss gaps "
          f"{[abs(a - b) / abs(b) for a, b in zip(losses, want['loss'])]}; the largest "
          f"leaf's change gap {gaps[worst]!r} ({worst}); leaves left out of the change "
          f"{sorted(set(names) - set(gaps))}", file=sys.stderr, flush=True)
    rec["checks"] = compare(losses, dict(zip(names, first_grad)), deltas, want,
                            ctx.cell["check"])
    rec["attempted"], rec["failed"] = n, 0
    return rec


def delta_gaps(deltas: dict, want: dict) -> dict:
    """{leaf: gap between the norms of its change after the steps, over the
    larger of the reference leaf's norm and the median leaf's}, over the
    leaves whose reference first gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    g_ref = {k: float(v.norm()) for k, v in want["grad"].items()}
    g_med = statistics.median(g_ref.values())
    d_ref = {k: float(v.norm()) for k, v in want["delta"].items()}
    moved = [k for k in d_ref if g_ref[k] >= 1e-3 * g_med]
    d_med = statistics.median(d_ref[k] for k in moved)
    return {k: abs(float(deltas[k].norm()) - d_ref[k]) / max(d_ref[k], d_med, 1e-30)
            for k in moved}


def compare(losses, grads: dict, deltas: dict, want: dict, check: dict) -> list:
    """[name, value, limit] of: the relative gap of the first step's loss
    (the later steps' losses follow weights that already differ by
    round-off, and a primitive that round-off moves across a split plane
    moves them by 1e-5 or more in a sound run); the largest gap, over
    leaves, between the norms of the first gradient (the program's from
    Adam's first moment), each over the larger of the reference leaf's
    norm and the median leaf's; the median leaf's gap of the change after
    the steps (delta_gaps: a leaf whose elements' gradients sit near Adam's
    epsilon moves by round-off, so the largest leaf's gap swings from seed
    to seed in a sound run)."""
    loss_gap = abs(losses[0] - want["loss"][0]) / max(abs(want["loss"][0]), 1e-30)
    g_ref = {k: float(v.norm()) for k, v in want["grad"].items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(float(grads[k].norm()) - g_ref[k]) / max(g_ref[k], g_med, 1e-30)
                   for k in g_ref)
    delta_gap = statistics.median(delta_gaps(deltas, want).values())
    return [["loss_gap", loss_gap, float(check["loss_gap"])],
            ["grad_gap", grad_gap, float(check["grad_gap"])],
            ["delta_gap", delta_gap, float(check["delta_gap"])]]
