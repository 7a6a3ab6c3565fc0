"""Parity of the torch port's treeNet learner (nn_bvh_tpu_torch/learn/, cli/)
against the JAX package on the CPU.

The JAX tests' tiny configuration (tests/test_learn.py:24-33): levels 3,
capacity 16, a cloud of 64 primitives, EPO and SAH, batch 2. The same numpy
inputs go to both packages; weights are carried from JAX's init_params with
treenet.params_from_jax. Tolerances:

- the splitter's autograd Functions against the JAX custom VJPs: discrete
  outputs (bounds picked from the cloud, counts) bit-equal, sums (w_epo)
  rtol 1e-6; backward against jax.vjp with a random upstream, rtol 1e-6
  (the event slopes are elementwise; only w_epo's area sums are reduced in
  another order);
- gen_nodes / gen_nodes_epo: offsets and child bounds within 1e-6, their
  VJPs (jnp.clip's halving at a tie) within 1e-6, build_mask_epo equal;
- the encoder: lthetas within rtol 1e-5 (float32 products summed in
  another order), scale and translate too; weight gradients with and
  without recomputation (torch.utils.checkpoint) bit-equal and within 1e-4
  of each tensor's largest |g| of jax.grad's;
- forward_tree: every level's bounds within 1e-5, masks equal (a flipped
  mask would be a finding, not a tolerance);
- loss_fn: the value within rtol 1e-4, gradients within 1e-3 of each
  tensor's largest |g| of jax.value_and_grad's;
- predict_tree: normals equal, offsets within 1e-5;
- 5 Adam steps against optax.adam: parameters within rtol 1e-4, the loss
  history within rtol 1e-4;
- checkpoint resume: bit-equal to an unbroken run;
- data, kd_tree, tree_eval, export: bit-identical.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu.learn import (callbacks as j_callbacks, common as j_common, data as j_data,
                              encoder as j_encoder, export as j_export, kd_tree as j_kd,
                              splitter as j_splitter, trainer as j_trainer,
                              tree_eval as j_tree_eval, treenet as j_treenet)
from nn_bvh_tpu_torch.cli import train as cli_train, tree_bench as cli_tree_bench
from nn_bvh_tpu_torch.learn import (callbacks, common, data, encoder, export, kd_tree, splitter,
                                    trainer, tree_eval, treenet)

torch.set_num_threads(1)

CFG = treenet.TreeNetConfig(levels=3, capacity=16, pc_size=64, epo=True)
CFG_SAH = CFG._replace(epo=False)
J_CFG = j_treenet.TreeNetConfig(levels=3, capacity=16, pc_size=64, epo=True)
CFGS = {"epo": (CFG, J_CFG), "sah": (CFG_SAH, J_CFG._replace(epo=False))}


def t(x):
    return torch.as_tensor(np.asarray(x))


def close_to_max(got, want, tol, name=""):
    """|got - want| <= tol * max|want| elementwise (the largest-|g| rule)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{name}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


def small_clouds(b=2, n=64, seed=0, points=False):
    """tests/test_learn.py's small_clouds, from the port's data module."""
    sc = data.random_scene(n_meshes=3, prims_per_mesh=max(n // 2, 8), seed=seed)
    sc.pc_size = n
    sc.__post_init__()
    c = sc.next_batch(b)
    return data.Scene.to_points(None, c).astype(np.float32) if points else c


def carried(jcfg, key=0):
    """JAX init_params -> (JAX params, the port's TreeNet with those weights)."""
    jp = j_treenet.init_params(jcfg, jax.random.PRNGKey(key))
    cfg = treenet.TreeNetConfig(**jcfg._asdict())
    return jp, treenet.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


# ---------------------------------------------------------------------------
# splitter: the six autograd Functions against the JAX custom VJPs
# ---------------------------------------------------------------------------

def grid(rs, shape, lo=0.0, hi=1.0, step=1 / 32):
    """Values on a coarse grid, so ties and exact events occur."""
    return (np.round(rs.uniform(lo, hi, shape) / step) * step).astype(np.float32)


def splitter_inputs(name, seed):
    """(args numpy, port fn, jax fn, indices of the differentiable args)."""
    rs = np.random.RandomState(seed)
    B, K, N = 2, 6, 24
    mask = (rs.rand(B, K, N) < 0.7).astype(np.float32)
    pmin = grid(rs, (B, K), 0.0, 0.3)
    pmax = grid(rs, (B, K), 0.7, 1.0)
    # offsets inside the node, and some outside it (the zero gradient)
    off = np.where(rs.rand(B, K) < 0.8, grid(rs, (B, K), 0.05, 0.95),
                   grid(rs, (B, K), -0.5, 1.5)).astype(np.float32)
    if name in ("ql_points", "ql_prims"):
        return ((grid(rs, (B, K, N)), mask, pmin, pmax, off),
                getattr(splitter, name), getattr(j_splitter, name), (4,))
    if name in ("left_child_bound", "right_child_bound"):
        return ((grid(rs, (B, K, N, 3)), mask, pmin, pmax, off),
                getattr(splitter, name), getattr(j_splitter, name), (4,))
    raise KeyError(name)


def check_vjp(args, fn, jfn, diff, seed, fwd_rtol=0.0, bwd_rtol=1e-6, exact=True, up=None):
    """Forward (bit-equal, or within fwd_rtol) and backward against
    jax.vjp with a random upstream (or `up`) -> the port's gradients."""
    rs = np.random.RandomState(seed + 100)
    tin = [torch.tensor(a, requires_grad=i in diff) for i, a in enumerate(args)]
    out = fn(*tin)
    jout, vjp = jax.vjp(lambda *d: jfn(*[d[diff.index(i)] if i in diff else jnp.asarray(a)
                                         for i, a in enumerate(args)]),
                        *[jnp.asarray(args[i]) for i in diff])
    if exact:
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    else:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=fwd_rtol)
    if up is None:
        up = rs.standard_normal(np.shape(jout)).astype(np.float32)
    got = torch.autograd.grad(out, [tin[i] for i in diff], torch.tensor(up))
    want = vjp(jnp.asarray(up))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=bwd_rtol, atol=0)
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["ql_points", "ql_prims", "left_child_bound",
                                  "right_child_bound"])
def test_event_functions_match_jax_vjp(name, seed):
    args, fn, jfn, diff = splitter_inputs(name, seed)
    (g,) = check_vjp(args, fn, jfn, diff, seed)
    off, pmin, pmax = args[4], args[2], args[3]
    outside = (off < pmin) | (off > pmax)
    assert outside.any() and (g.numpy()[outside] == 0).all()
    # right_child_bound's slope -(bound - bound_below) / (offset - offset_below)
    # is never positive, so JAX's clip to [0, 1e4] zeroes it everywhere; the
    # port mirrors that
    assert (g.numpy() != 0).any() == (name != "right_child_bound")


@pytest.mark.parametrize("case", ["ql_slope", "ql_out_of_bounds", "lcb", "rcb_clipped"])
def test_event_functions_on_the_jax_unit_cases(case):
    """tests/test_learn.py:36-90's hand-made cases, through both packages."""
    pts = np.linspace(0.0, 1.0, 11, dtype=np.float32)[None]
    ap = np.asarray([[[0.0, 0.1, 0.2], [0.5, 0.7, 0.9]]], np.float32)
    lo, hi = np.zeros(1, np.float32), np.ones(1, np.float32)
    args = {"ql_slope": ((pts, np.ones((1, 11), np.float32), lo, hi,
                          np.asarray([0.45], np.float32)), "ql_points", 20.0),
            "ql_out_of_bounds": ((pts, np.ones((1, 11), np.float32), lo, hi,
                                  np.asarray([1.5], np.float32)), "ql_points", 0.0),
            "lcb": ((ap, np.ones((1, 2), np.float32), lo, hi,
                     np.asarray([0.3], np.float32)), "left_child_bound", 1.75),
            "rcb_clipped": ((ap, np.ones((1, 2), np.float32), lo, hi,
                             np.asarray([0.3], np.float32)), "right_child_bound", 0.0)}[case]
    (a, name, slope) = args
    (g,) = check_vjp(a, getattr(splitter, name), getattr(j_splitter, name), (4,), 0,
                     up=np.ones(1, np.float32))
    np.testing.assert_allclose(g.numpy(), [slope], rtol=1e-4)


@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_soft_min_matches_jax_vjp(temp):
    rs = np.random.RandomState(3)
    v = rs.standard_normal((2, 6, 3)).astype(np.float32)
    v[0, 0, 1] = v[0, 0, 0]  # a tie
    check_vjp((v,), lambda x: splitter.soft_min(x, temp), lambda x: j_splitter.soft_min(x, temp),
              (0,), 3)


def w_epo_inputs(seed):
    rs = np.random.RandomState(seed)
    B, K, N = 2, 6, 32
    tri = grid(rs, (B, 1, N, 3, 3), 0.0, 1.0, 1 / 64)
    prims = tri.transpose(0, 1, 2, 4, 3).reshape(B, 1, N, 9)
    lo = grid(rs, (B, K, 3), 0.1, 0.45)
    hi = grid(rs, (B, K, 3), 0.55, 0.9)
    node_mask = (rs.rand(B, K, N) < 0.4).astype(np.float32)
    parent_mask = np.maximum(node_mask, (rs.rand(B, K, N) < 0.5).astype(np.float32))
    return prims, np.concatenate([lo, hi], -1), node_mask, parent_mask


@pytest.mark.parametrize("is_left", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_w_epo_matches_jax_vjp(axis, is_left):
    prims, nb, nm, pm = w_epo_inputs(axis + 3 * is_left)
    args = (prims, nb, nm, pm, nb[..., axis], nb[..., 3 + axis])
    g_min, g_max = check_vjp(
        args, lambda *a: splitter.w_epo(*a, axis, is_left),
        lambda *a: j_splitter.w_epo(*a, axis, is_left), (4, 5), axis, fwd_rtol=1e-6,
        exact=False)
    # the right child's slope (-area / (event - node_min)) is never positive,
    # so JAX's clip to [0, 1e4] zeroes it everywhere; the port mirrors that
    assert ((g_max if is_left else g_min) != 0).any() == is_left
    assert ((g_min if is_left else g_max) == 0).all()


def test_w_epo_on_the_jax_unit_case():
    """tests/test_learn.py's test_w_epo_forward: one prim inside the node,
    one crossing it from outside."""
    prims = data.tris_to_prims(np.array(
        [[[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [0.1, 0.2, 0.1]],
         [[0.45, 0.1, 0.1], [0.7, 0.1, 0.1], [0.45, 0.2, 0.1]]], np.float32))[None]
    nb = np.asarray([[0.0, 0.0, 0.0, 0.5, 0.5, 0.5]], np.float32)
    args = (prims, nb, np.asarray([[1.0, 0.0]], np.float32), np.ones((1, 2), np.float32),
            nb[..., 0], nb[..., 3])
    w = splitter.w_epo(*map(t, args), 0, True)
    areas = common.prim_areas(t(prims)).numpy()[0]
    np.testing.assert_allclose(w.numpy(), 0.5 * areas[1] / areas.sum(), rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_splitter.w_epo(
        *map(jnp.asarray, args), 0, True)), rtol=1e-6)


@pytest.mark.parametrize("epo", [True, False], ids=["gen_nodes_epo", "gen_nodes"])
def test_gen_nodes_match_jax(epo):
    """Offsets and child bounds within 1e-6 and their VJP to (bounds,
    thetas) within 1e-6: the child bounds equal the node's bounds on many
    lanes, where jnp.clip halves the gradient between the offset and the
    bound."""
    rs = np.random.RandomState(5)
    clouds = small_clouds(2, 64, seed=5)
    bounds = np.concatenate([clouds.reshape(2, 64, 3, 3).min((1, 3)),
                             clouds.reshape(2, 64, 3, 3).max((1, 3))], -1)
    bounds = np.repeat(bounds[:, None], 6, 1)  # (B, K, 6)
    thetas = rs.uniform(-0.2, 1.2, (2, 6, 3)).astype(np.float32)
    mask = (rs.rand(2, 6, 64) < 0.8).astype(np.float32)
    tb = torch.tensor(bounds, requires_grad=True)
    tt = torch.tensor(thetas, requires_grad=True)
    if epo:
        out = splitter.gen_nodes_epo(t(clouds[:, None]), tb, tt, t(mask))
        jfn = lambda b, th: j_splitter.gen_nodes_epo(jnp.asarray(clouds[:, None]), b, th,
                                                     jnp.asarray(mask))
    else:
        out = splitter.gen_nodes(tb, tt)
        jfn = j_splitter.gen_nodes
    jout, vjp = jax.vjp(jfn, jnp.asarray(bounds), jnp.asarray(thetas))
    for o, jo in zip(out, jout):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    ups = [rs.standard_normal(np.shape(jo)).astype(np.float32) for jo in jout]
    got = torch.autograd.grad(out, (tb, tt), [torch.tensor(u) for u in ups])
    want = vjp(tuple(jnp.asarray(u) for u in ups))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if epo:  # the children's masks
        off = out[0].detach()
        for a in range(3):
            for right in (False, True):
                np.testing.assert_array_equal(
                    common.build_mask_epo(t(clouds[:, None]), off[..., a, None], a, t(mask),
                                          right).numpy(),
                    np.asarray(j_common.build_mask_epo(
                        jnp.asarray(clouds[:, None]), jnp.asarray(off.numpy()[..., a, None]),
                        a, jnp.asarray(mask), right)))


# ---------------------------------------------------------------------------
# encoder, forward_tree, loss, predict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["epo", "sah"])
def test_encoder_matches_jax(variant):
    cfg, jcfg = CFGS[variant]
    jp, model = carried(jcfg, key=4)
    clouds = small_clouds(2, 64, seed=4, points=not cfg.epo)
    rs = np.random.RandomState(4)
    B, K, N = 2, 6, 64
    lo = clouds.reshape(B, N, -1, 3 if cfg.epo else 1).min((1, 3))[:, :3] if cfg.epo else \
        clouds.min(1)
    hi = clouds.reshape(B, N, -1, 3 if cfg.epo else 1).max((1, 3))[:, :3] if cfg.epo else \
        clouds.max(1)
    bounds = np.repeat(np.concatenate([lo, hi], -1)[:, None], K, 1).astype(np.float32)
    mask = (rs.rand(B, K, N) < 0.6).astype(np.float32)
    w = rs.standard_normal((B, K, 3)).astype(np.float32)
    enc, jenc = model.encoders[0], jp[0]

    out = encoder.apply_encoder(enc, t(clouds[:, None]), t(bounds), t(mask))
    jout = j_encoder.apply_encoder(jenc, jnp.asarray(clouds[:, None]), jnp.asarray(bounds),
                                   jnp.asarray(mask))
    for o, jo, name in zip(out, jout, ("lthetas", "scale", "translate")):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=0,
                                   err_msg=name)

    def loss(e):
        return (torch.as_tensor(w) * encoder.apply_encoder(e, t(clouds[:, None]), t(bounds),
                                                           t(mask))[0]).sum()

    def ck_loss(e):
        lth = torch.utils.checkpoint.checkpoint(encoder.apply_encoder, e, t(clouds[:, None]),
                                                t(bounds), t(mask), use_reentrant=False)[0]
        return (torch.as_tensor(w) * lth).sum()

    params = [p for p in enc.parameters()]
    g_plain = torch.autograd.grad(loss(enc), params)
    g_ck = torch.autograd.grad(ck_loss(enc), params)
    jg = jax.jit(jax.grad(lambda p, c, b, m: jnp.sum(jnp.asarray(w) * j_encoder.apply_encoder(
        p, c, b, m)[0])))(jenc, jnp.asarray(clouds[:, None]), jnp.asarray(bounds),
                          jnp.asarray(mask))
    names = [n for n in encoder.FIELDS if getattr(enc, n) is not None]
    for name, a, b in zip(names, g_plain, g_ck):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        close_to_max(a.numpy(), getattr(jg, name), 1e-4, name)


def test_encoder_ignores_masked_points():
    """tests/test_learn.py's test_mask_invariance through the port."""
    _, model = carried(J_CFG._replace(epo=False), key=1)
    rs = np.random.RandomState(1)
    cloud = rs.rand(1, 1, 16, 3).astype(np.float32)
    bounds = np.asarray([[[0.0, 0, 0, 1, 1, 1]]], np.float32)
    mask = np.ones((1, 1, 16), np.float32)
    mask[0, 0, 8:] = 0.0
    enc = model.encoders[0]
    a = encoder.apply_encoder(enc, t(cloud), t(bounds), t(mask))[0]
    cloud[0, 0, 8:] = 99.0
    b = encoder.apply_encoder(enc, t(cloud), t(bounds), t(mask))[0]
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


@pytest.fixture(scope="module", params=["epo", "sah"])
def anchor(request):
    """One batch through both packages: levels, loss, gradients, planes."""
    cfg, jcfg = CFGS[request.param]
    jp, model = carried(jcfg)
    clouds = small_clouds(2, 64, seed=0, points=not cfg.epo)
    jc = jnp.asarray(clouds)
    j_levels = j_treenet.forward_tree(jp, jcfg, jc)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, c: j_treenet.loss_fn(p, jcfg, c), has_aux=True))(jp, jc)
    j_cost, j_planes = jax.jit(lambda p, c: j_treenet.predict_tree(p, jcfg, c))(jp, jc)
    return dict(cfg=cfg, model=model, clouds=clouds, j_levels=j_levels, j_loss=j_loss,
                j_metrics=j_metrics, j_grads=j_grads, j_cost=j_cost, j_planes=j_planes)


def test_forward_tree_matches_jax(anchor):
    with torch.no_grad():
        levels = treenet.forward_tree(anchor["model"], anchor["cfg"], t(anchor["clouds"]))
    assert len(levels) == len(anchor["j_levels"])
    for l, (lev, jlev) in enumerate(zip(levels, anchor["j_levels"])):
        np.testing.assert_allclose(lev.bounds.numpy(), np.asarray(jlev.bounds), rtol=0,
                                   atol=1e-5, err_msg=f"level {l} bounds")
        np.testing.assert_array_equal(lev.mask.numpy(), np.asarray(jlev.mask),
                                      err_msg=f"level {l} mask")
        if jlev.offsets is not None:
            np.testing.assert_allclose(lev.offsets.numpy(), np.asarray(jlev.offsets), rtol=0,
                                       atol=1e-5, err_msg=f"level {l} offsets")


def test_loss_and_gradients_match_jax(anchor):
    model, cfg = anchor["model"], anchor["cfg"]
    loss, metrics = treenet.loss_fn(model, cfg, t(anchor["clouds"]))
    np.testing.assert_allclose(loss.item(), float(anchor["j_loss"]), rtol=1e-4)
    for k, v in anchor["j_metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-4, err_msg=k)
    names = [(l, n) for l, e in enumerate(model.encoders) for n in encoder.FIELDS
             if getattr(e, n) is not None]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(grads) == len(names)
    for (l, n), g in zip(names, grads):
        want = np.asarray(getattr(anchor["j_grads"][l], n))
        assert np.isfinite(g.numpy()).all()
        close_to_max(g.numpy(), want, 1e-3, f"encoder {l} {n}")
    # the gradient reaches the weights only through event slopes: not all zero
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_predict_tree_matches_jax(anchor):
    cost, planes = treenet.predict_tree(anchor["model"], anchor["cfg"], t(anchor["clouds"]))
    jp = np.asarray(anchor["j_planes"])
    assert planes.shape == jp.shape == (2, 2 ** (anchor["cfg"].levels - 1) - 1, 4)
    np.testing.assert_array_equal(planes[..., :3].numpy(), jp[..., :3])
    np.testing.assert_allclose(planes[..., 3].numpy(), jp[..., 3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(cost.numpy(), np.asarray(anchor["j_cost"]), rtol=1e-4)


def test_params_round_trip():
    jp, model = carried(J_CFG, key=7)
    back = treenet.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)), jax.tree.leaves(
            tuple(j_encoder.EncoderParams(*p) for p in back))):
        np.testing.assert_array_equal(a, b)
    assert back[0].vert.shape == (3, 16) and back[0].w1.shape == (16, 16)
    sah = treenet.params_to_numpy(carried(J_CFG._replace(epo=False))[1])
    assert sah[0].vert is None and sah[0].w1.shape == (1, 16)


@pytest.mark.parametrize("variant", ["epo", "sah"])
def test_init_params_match_jax_shapes_and_limits(variant):
    """init_params: the JAX package's shapes, He-uniform limits (Glorot for
    r3), the same weights for the same seed (a CPU generator), others for
    another seed."""
    cfg, jcfg = CFGS[variant]
    jp = jax.tree.map(np.asarray, j_treenet.init_params(jcfg, jax.random.PRNGKey(0)))
    a, b = (treenet.params_to_numpy(treenet.init_params(cfg, s, "cpu")) for s in (5, 5))
    c = treenet.params_to_numpy(treenet.init_params(cfg, 6, "cpu"))
    for ea, eb, ec, ej in zip(a, b, c, jp):
        for name in encoder.FIELDS:
            w, wj = getattr(ea, name), getattr(ej, name)
            assert (w is None) == (wj is None) == (name == "vert" and not cfg.epo), name
            if w is None:
                continue
            assert w.shape == wj.shape and w.dtype == np.float32, name
            fan = w.shape[0] + (w.shape[1] if name == "r3" else 0)
            assert np.abs(w).max() <= np.sqrt(6.0 / fan), name
            np.testing.assert_array_equal(w, getattr(eb, name))
            assert not np.array_equal(w, getattr(ec, name))


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ValueError, match="no CUDA device"):
        treenet.init_params(CFG)
    with pytest.raises(ValueError, match="no CUDA device"):
        cli_train.main(["--steps", "1", "--levels", "2", "--capacity", "8", "--pc-size", "32"])
    assert treenet.init_params(CFG, device="cpu").encoders[0].w1.device.type == "cpu"


# ---------------------------------------------------------------------------
# training: Adam against optax, checkpoint resume, TrainLog, CLIs
# ---------------------------------------------------------------------------

def train_scene(seed=3, prims=40):
    sc = data.random_scene(n_meshes=3, prims_per_mesh=prims, seed=seed)
    sc.pc_size = CFG.pc_size
    sc.__post_init__()
    return sc


def test_adam_steps_match_optax():
    jcfg = J_CFG._replace(learning_rate=3e-4)
    cfg = treenet.TreeNetConfig(**jcfg._asdict())
    jp, model = carried(jcfg, key=2)
    tx = j_trainer.optax.adam(jcfg.learning_rate)
    jstate = j_trainer.TrainState(jp, tx.init(jp), 0)
    jstep = j_trainer.make_train_step(jcfg, tx)
    state = trainer.TrainState(model, trainer.make_optimizer(model, cfg), 0)
    step = trainer.make_train_step(cfg)
    sc = train_scene()
    for i in range(5):
        clouds = sc.next_batch(2)
        jstate, jm = jstep(jstate, jnp.asarray(clouds))
        state, m = step(state, t(clouds))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    for jenc, enc in zip(jstate.params, treenet.params_to_numpy(state.model)):
        for name in encoder.FIELDS:
            if getattr(enc, name) is not None:
                np.testing.assert_allclose(getattr(enc, name), np.asarray(getattr(jenc, name)),
                                           rtol=1e-4, atol=0, err_msg=name)
    assert state.step == 5


def test_checkpoint_resume_is_bit_equal(tmp_path):
    cfg = CFG._replace(learning_rate=3e-4)
    kw = dict(batch_size=2, seed=0, log_every=1, device="cpu")
    _, whole = trainer.train(cfg, train_scene(5), n_steps=4, **kw)
    ck = str(tmp_path / "ck")
    _, first = trainer.train(cfg, train_scene(5), n_steps=2, checkpoint_dir=ck, **kw)
    assert os.path.exists(os.path.join(ck, trainer.CHECKPOINT))
    state, rest = trainer.train(cfg, train_scene(5), n_steps=4, checkpoint_dir=ck, **kw)
    assert [h["step"] for h in first + rest] == [1, 2, 3, 4]
    assert first + rest == whole  # every float of every row, bit for bit
    state2 = trainer.load_checkpoint(ck, trainer.make_train_state(cfg, seed=9, device="cpu"))
    assert state2.step == 4
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)


def test_history_keys_match_jax():
    cfg = CFG._replace(learning_rate=3e-4)
    _, hist = trainer.train(cfg, train_scene(), n_steps=2, batch_size=2, log_every=1,
                            device="cpu")
    _, jhist = j_trainer.train(J_CFG._replace(learning_rate=3e-4), train_scene(), n_steps=2,
                               batch_size=2, log_every=1)
    assert [list(h) for h in hist] == [list(h) for h in jhist]
    assert all(np.isfinite(v) for h in hist for v in h.values())


def test_train_log_writes_jax_columns(tmp_path):
    cfg = CFG._replace(learning_rate=3e-4)
    test_clouds = small_clouds(2, 64, seed=8)
    log = callbacks.TrainLog(cfg, str(tmp_path / "port"), test_clouds=test_clouds)
    jlog = j_callbacks.TrainLog(J_CFG, str(tmp_path / "jax"), test_clouds=test_clouds)
    trainer.train(cfg, train_scene(), n_steps=2, batch_size=2, log_every=1, callback=log,
                  device="cpu")
    j_trainer.train(J_CFG._replace(learning_rate=3e-4), train_scene(), n_steps=2, batch_size=2,
                    log_every=1, callback=jlog)
    rows = open(tmp_path / "port" / "treenet_log.csv").read().splitlines()
    jrows = open(tmp_path / "jax" / "treenet_log.csv").read().splitlines()
    assert rows[0] == jrows[0] and len(rows) == len(jrows) == 3
    assert "test_cost" in rows[0] and "greedy_cost" in rows[0]
    best = tmp_path / "port" / "treenet_best.pt"
    assert best.exists()
    st = trainer.load_checkpoint(str(tmp_path / "port"),
                                 trainer.make_train_state(cfg, device="cpu"), "treenet_best.pt")
    assert st.step in (1, 2)
    # the greedy column is numpy on the same cloud: equal
    col = rows[0].split(",").index("greedy_cost")
    assert [r.split(",")[col] for r in rows[1:]] == [r.split(",")[col] for r in jrows[1:]]
    png = log.export_plots()
    assert png is None or os.path.exists(png)


def test_cli_train_prints_finite_history(capsys):
    cli_train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--levels", "3",
                    "--capacity", "16", "--pc-size", "64", "--log-every", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert list(rows[0]) == ["loss", "mae", "out_of_bounds_splits", "pen_loss", "tree_loss",
                             "step"]


def test_cli_train_dp_raises():
    with pytest.raises(NotImplementedError, match="item 7"):
        cli_train.main(["--device", "cpu", "--dp", "--steps", "1"])


def test_cli_tree_bench_reads_a_port_checkpoint(tmp_path, capsys):
    cfg = treenet.TreeNetConfig(levels=3, capacity=8, pc_size=64, epo=True, learning_rate=3e-4)
    sc = data.random_scene(seed=0)
    sc.pc_size = cfg.pc_size
    sc.__post_init__()
    trainer.train(cfg, sc, n_steps=2, batch_size=2, checkpoint_dir=str(tmp_path), device="cpu")
    cli_tree_bench.main(["--device", "cpu", "--checkpoint", str(tmp_path), "--levels", "3",
                         "--capacity", "8", "--pc-size", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["scene"] == "procedural" and out["pred_stats"]["depth"] == 2
    assert np.isfinite(out["pred_sah"]) and out["pred_sah"] > 0


# ---------------------------------------------------------------------------
# numpy modules: bit-identical to the JAX package's
# ---------------------------------------------------------------------------

def test_data_is_bit_identical(tmp_path):
    for seed in (0, 11):
        a, b = data.random_scene(seed=seed), j_data.random_scene(seed=seed)
        for s in (a, b):
            s.pc_size = 64
            s.__post_init__()
        np.testing.assert_array_equal(a.base_cloud(), b.base_cloud())
        np.testing.assert_array_equal(a.next_batch(3), b.next_batch(3))
        np.testing.assert_array_equal(a.to_points(a.next_batch(1)), b.to_points(b.next_batch(1)))
    obj = tmp_path / "s.obj"
    obj.write_text("g a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\n"
                   "g b\nv 2 0 0\nv 3 0 0\nv 2 1 0\nf 5 6 7\n")
    for m, jm in zip(data.parse_obj(str(obj)), j_data.parse_obj(str(obj))):
        np.testing.assert_array_equal(m, jm)
    s, js = data.Scene(data.parse_obj(str(obj)), pc_size=16), \
        j_data.Scene(j_data.parse_obj(str(obj)), pc_size=16)
    np.testing.assert_array_equal(s.next_batch(2), js.next_batch(2))
    # the point-cloud stream
    root = tmp_path / "pcs"
    root.mkdir()
    rs = np.random.RandomState(0)
    names = []
    for i in range(5):
        np.savez(root / f"c{i}.npz", a=rs.rand(32, 3).astype(np.float32))
        names.append(f"c{i}")
    (root / "index.csv").write_text("samples\n" + "\n".join(names) + "\n")
    it = iter(data.PointCloudStream(str(root), str(root / "index.csv"), 2))
    jit_ = iter(j_data.PointCloudStream(str(root), str(root / "index.csv"), 2))
    for _ in range(4):
        (n, c), (jn, jc) = next(it), next(jit_)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(c, jc)


def test_kd_tree_is_bit_identical():
    prims = data.random_scene(n_meshes=2, prims_per_mesh=64, seed=0).base_cloud()
    for strategy in (kd_tree.SAH, kd_tree.VH):
        tr = kd_tree.build_greedy(prims, levels=3, strategy=strategy, n_bins=8)
        jtr = j_kd.build_greedy(prims, levels=3, strategy=strategy, n_bins=8)
        for a, b in zip(tr.planes, jtr.planes):
            np.testing.assert_array_equal(a, b)
        assert kd_tree.tree_cost(tr, prims, strategy) == j_kd.tree_cost(jtr, prims, strategy)
    flat = kd_tree.to_level_order(tr)
    np.testing.assert_array_equal(flat, j_kd.to_level_order(jtr))
    assert kd_tree.abs_diff(kd_tree.from_level_order(flat), tr) == 0
    pre = np.arange(28, dtype=np.float32).reshape(7, 4)
    np.testing.assert_array_equal(kd_tree.preorder_to_levelorder(pre, 3),
                                  j_kd.preorder_to_levelorder(pre, 3))


def test_tree_eval_is_bit_identical():
    prims = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=7).base_cloud()
    gp = tree_eval.greedy_tree(prims, 4)
    np.testing.assert_array_equal(gp, j_tree_eval.greedy_tree(prims, 4))
    root, jroot = tree_eval.build_tree_from_planes(prims, gp), \
        j_tree_eval.build_tree_from_planes(prims, gp)
    assert tree_eval.sah_cost(root) == j_tree_eval.sah_cost(jroot)
    assert tree_eval.epo_cost(root, prims) == j_tree_eval.epo_cost(jroot, prims)
    assert tree_eval.tree_stats(root) == j_tree_eval.tree_stats(jroot)


def test_export_is_bit_identical(tmp_path):
    jp, model = carried(J_CFG, key=3)
    export.export_variables(str(tmp_path / "port"), model)
    j_export.export_variables(str(tmp_path / "jax"), jp)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and "0_w1.bin" in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    prims = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=21).base_cloud()
    planes = tree_eval.greedy_tree(prims, 4)
    export.export_tree(str(tmp_path / "t.bin"), planes)
    np.testing.assert_array_equal(export.import_tree(str(tmp_path / "t.bin")),
                                  j_export.import_tree(str(tmp_path / "t.bin")))
    for p in (prims, data.prims_to_tris(prims)):
        bvh, jbvh = export.planes_to_bvh(p, planes), j_export.planes_to_bvh(p, planes)
        np.testing.assert_array_equal(bvh.prim_order, jbvh.prim_order)
        for f in ("node_lo", "node_hi", "node_meta"):
            np.testing.assert_array_equal(getattr(bvh, f), getattr(jbvh, f))


def test_planes_do_not_shape_the_bvh():
    """A fault of the reference that the port mirrors (ROADMAP queue 3):
    planes_to_bvh orders the prims by the plane tree's leaves, then runs
    the binned-SAH builder over that order, which re-partitions them by
    centroid. Its nodes, bounds and leaf sets are those of build_sah(
    max_leaf=4) over the scene whatever the planes; only the order inside
    leaves follows the planes. Shown for the JAX package and the port."""
    from nn_bvh_tpu.accel import build as j_build
    from nn_bvh_tpu_torch.accel import build

    prims = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=21).base_cloud()
    tri = data.prims_to_tris(prims)
    plain = build.build_sah(tri.min(1), tri.max(1), 4)

    def leaf_sets(bvh):
        return {frozenset(bvh.prim_order[o:o + c].tolist())
                for o, c, _ in bvh.node_meta[:bvh.n_nodes] if c > 0}

    greedy = tree_eval.greedy_tree(prims, 4)
    rs = np.random.RandomState(0)
    shuffled = greedy.copy()
    shuffled[:, 3] = rs.uniform(1.0, 2.0, len(greedy))
    for planes in (greedy, shuffled):
        for bvh in (export.planes_to_bvh(tri, planes), j_export.planes_to_bvh(tri, planes)):
            for f in ("node_lo", "node_hi", "node_meta"):
                np.testing.assert_array_equal(getattr(bvh, f), getattr(plain, f))
            assert leaf_sets(bvh) == leaf_sets(plain)
    j_plain = j_build.build_sah(tri.min(1), tri.max(1), 4)
    np.testing.assert_array_equal(j_plain.prim_order, plain.prim_order)
