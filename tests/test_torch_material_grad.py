"""The per-lane material gather (nn_bvh_tpu_torch/scatter/material_grad.py)
on the CPU, where it is the plain gather and its aten backward.

- `gather`, and `bxdf.gather_material` at both of its call sites (the
  direct gather and a mix material's second one), give the plain gather's
  values and gradients bit for bit, with and without a graph.
- The counter "grad/material lanes" reads the lanes of every gather made
  with a graph: R a bounce in a joint step, none in a render.
- `segment_sum`, the kernel's wrapper, raises on what the kernel cannot
  take before any launch; the autograd Function's backward reaches it.
- `segment_sum_plain`, the float64 reference of the card's tests, is the
  aten backward of the gather up to float32 rounding.

The kernel itself runs in tests/test_torch_cuda.py on a card.
"""

import os
import re

import numpy as np
import pytest
import torch

from nn_bvh_tpu_torch import accel, kernels
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
from nn_bvh_tpu_torch.learn import joint, trainer, treenet
from nn_bvh_tpu_torch.scatter import bxdf, lightsamplers, material_grad
from nn_bvh_tpu_torch.utils import stats
from nn_bvh_tpu_torch.wavefront import camera, integrator

torch.set_num_threads(1)
RES = 8
N = 512


def plain(table, ids):
    return table[torch.clamp(ids, min=0).long()]


def build(mix: bool):
    b = scene_mod.SceneBuilder()
    red = b.add_material("diffuse", reflectance=(0.6, 0.2, 0.1))
    m = red
    if mix:
        blue = b.add_material("diffuse", reflectance=(0.1, 0.3, 0.7))
        m = b.add_material("mix", mix_materials=(red, blue), mix_amount=0.4)
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), red)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), red,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera.make_perspective(xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0,
                                  width=RES, height=RES)
    return sc, dbvh, cam


@pytest.fixture(autouse=True)
def tracing_off():
    stats.disable()
    stats.clear()
    yield
    stats.disable()
    stats.clear()


@pytest.fixture(scope="module")
def scenes():
    return {mix: build(mix) for mix in (False, True)}


@pytest.mark.parametrize("graph", [True, False])
def test_gather_is_the_plain_gather(graph):
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.standard_normal((5, 17)), dtype=torch.float32)
    table.requires_grad_(graph)
    ids = torch.as_tensor(rng.integers(-1, 5, (4, N // 4)), dtype=torch.int32)
    w = torch.as_tensor(rng.standard_normal((4, N // 4, 17)), dtype=torch.float32)
    got, want = material_grad.gather(table, ids), plain(table, ids)
    assert torch.equal(got, want) and got.requires_grad == graph
    if graph:
        g_got, = torch.autograd.grad((got * w).sum(), table)
        g_want, = torch.autograd.grad((want * w).sum(), table)
        assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("mix", [False, True], ids=["direct", "mix"])
@pytest.mark.parametrize("graph", [True, False])
def test_gather_material_at_both_call_sites_is_the_plain_gather(scenes, monkeypatch, mix,
                                                                graph):
    """The wrapper against the plain gather at both of gather_material's
    gathers: every field of the context, and d(fields)/d mat_coeffs."""
    sc = scene_mod.to_device(scenes[mix][0], "cpu")
    rng = np.random.default_rng(11)
    M = sc.mat_coeffs.shape[0]
    mat_id = torch.as_tensor(rng.integers(-1, M, N), dtype=torch.int32)
    lam = torch.as_tensor(rng.uniform(380, 720, (N, 4)), dtype=torch.float32)
    uv = torch.as_tensor(rng.random((N, 2)), dtype=torch.float32)
    u_mix = torch.as_tensor(rng.random(N), dtype=torch.float32)

    def run():
        mc = sc.mat_coeffs.detach().clone().requires_grad_(graph)
        s2 = sc.replace(mat_coeffs=mc)
        ctx = bxdf.gather_material(s2, mat_id, lam, bxdf.material_records(s2), uv, u_mix)
        fields = [v for v in ctx if isinstance(v, torch.Tensor) and v.is_floating_point()]
        grad = None
        if graph:
            loss = sum((f * (i + 1.0)).sum() for i, f in enumerate(fields) if f.requires_grad)
            grad, = torch.autograd.grad(loss, mc)
        return ctx, grad

    calls = []
    ctx_got, g_got = run()
    monkeypatch.setattr(material_grad, "gather",
                        lambda t, i: calls.append(i.numel()) or plain(t, i))
    ctx_want, g_want = run()
    assert calls == ([N, N] if mix else [N])
    for a, b in zip(ctx_got, ctx_want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    if graph:
        assert float(g_got.abs().max()) > 0 and torch.equal(g_got, g_want)


def _counters():
    return stats.totals(stats.collect())


def test_counter_reads_the_lanes_of_a_joint_steps_gathers(scenes):
    sc, dbvh, cam = scenes[False]
    tsc = scene_mod.to_device(sc, "cpu")
    tcfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
    model = trainer.make_train_state(tcfg, seed=2, device="cpu").model
    st = joint.JointState(model, tsc.mat_coeffs.detach().clone().requires_grad_(True))
    step = joint.make_joint_step(tcfg, cam, samplers.make_sampler("independent", seed=3, spp=2),
                                 integrator.IntegratorConfig(max_depth=3, mis=True))
    clouds = torch.as_tensor(joint.scene_cloud(sc, tcfg.pc_size, batch=2))
    lst = lightsamplers.build(sc, integrator.IntegratorConfig().light_sampler, "cpu")
    stats.enable(cuda=False)
    step(st, tsc, None, lst, clouds, torch.arange(RES * RES, dtype=torch.int32), 0,
         dispatch.make_intersectors(sc, dbvh, "cpu"))
    c = _counters()
    # one gather of the wave's R lanes a bounce run (lanes/processed adds R a bounce)
    assert c["grad/material lanes"] == c["lanes/processed"] == RES * RES * 3


def test_counter_stays_off_in_a_render(scenes):
    sc, dbvh, cam = scenes[True]
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True)
    stats.enable(cuda=False)
    integrator.render(sc, dbvh, cam, spp=1, sampler="independent", seed=3, cfg=cfg,
                      device="cpu")
    c = _counters()
    assert c["lanes/processed"] > 0 and "grad/material lanes" not in c


def _stub_entry(monkeypatch):
    calls = []
    monkeypatch.setattr(material_grad, "_entry",
                        lambda: calls.append(1) or (lambda *a: 0))
    return calls


@pytest.mark.parametrize("case,err,match", [
    ("float64", TypeError, "float32"), ("non_contiguous", ValueError, "contiguous"),
    ("device_mix", ValueError, "ids are on meta"), ("int64_ids", TypeError, "int32"),
    ("shape", ValueError, "is not"), ("cpu", ValueError, "CUDA")])
def test_segment_sum_raises_before_any_launch(monkeypatch, case, err, match):
    calls = _stub_entry(monkeypatch)
    grad, ids = torch.zeros(64, 17), torch.zeros(64, dtype=torch.int32)
    if case == "float64":
        grad = grad.double()
    elif case == "non_contiguous":
        grad = torch.zeros(17, 64).t()
    elif case == "device_mix":
        ids = ids.to("meta")
    elif case == "int64_ids":
        ids = ids.long()
    elif case == "shape":
        ids = ids[:63]
    with pytest.raises(err, match=match):
        material_grad.segment_sum(grad, ids, 3)
    assert calls == []


def test_function_backward_goes_to_the_kernel_wrapper(monkeypatch):
    """The Function's backward hands its (..., C) gradient and int32 ids to
    segment_sum, which takes CUDA tensors only: no aten path behind it."""
    calls = _stub_entry(monkeypatch)
    seen = []
    real = material_grad.segment_sum
    monkeypatch.setattr(material_grad, "segment_sum",
                        lambda g, i, m: seen.append((g.shape, i.dtype, m)) or real(g, i, m))
    table = torch.ones(3, 17, requires_grad=True)
    ids = torch.tensor([[0, -1, 2], [1, 1, 2]], dtype=torch.int32)
    out = material_grad._GatherRows.apply(table, ids)
    assert torch.equal(out, plain(table, ids))
    with pytest.raises(ValueError, match="CUDA"):
        (out * torch.rand(2, 3, 17)).sum().backward()
    assert seen == [((2, 3, 17), torch.int32, 3)] and calls == []


@pytest.mark.parametrize("M,R", [(1, 300), (3, 4097), (70, 1000)])
def test_plain_segment_sum_is_the_aten_backward(M, R):
    rng = np.random.default_rng(M)
    ids = torch.as_tensor(rng.integers(-1, M, R), dtype=torch.int32)
    grad = torch.as_tensor(rng.standard_normal((R, 17)), dtype=torch.float32)
    table = torch.zeros(M, 17, requires_grad=True)
    aten, = torch.autograd.grad((plain(table, ids) * grad).sum(), table)
    ref = material_grad.segment_sum_plain(grad, ids, M)
    assert ref.dtype == torch.float64 and ref.shape == (M, 17)
    # float32 sums of up to R terms of unit size against float64
    np.testing.assert_allclose(aten.numpy(), ref.numpy(), rtol=0, atol=R * 2e-7)


def test_blocks_per_sm_is_the_kernels_own():
    """The wrapper sizes the scratch (blocks, M, C) from BLOCKS_PER_SM; the
    kernel's launch bounds are sized from kBlocksPerSM."""
    with open(os.path.join(kernels.CSRC, f"{material_grad.NAME}.cu")) as f:
        found = re.findall(r"constexpr int kBlocksPerSM = (\d+);", f.read())
    assert found == [str(material_grad.BLOCKS_PER_SM)]
