"""The comparison that decides `correct` has to fail: the lower-precision
control (tests/controls.py) and each fault a cell can have, planted under
the timed path while the rest of a run goes on as the benchmark drives it
(on the CPU at a tiny size; the tests marked `cuda` read the controls on
the card at the cells' own sizes).

    python -m pytest benchmark/tests -q -p no:cacheprovider -n 0
"""

from __future__ import annotations

import os
import queue
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for _p in (os.path.dirname(BENCH), BENCH, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import controls  # noqa: E402
import run  # noqa: E402
from harness import spec  # noqa: E402
from test_bench_harness import TINY_JOINT, TINY_PATH, TINY_TRAIN  # noqa: E402

SEED = 2 ** 31 + 21


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")


def test_path_control_fails_on_the_cpu():
    limit = spec.load_cell("path_1080p").cell["check"]["mismatch_share"]
    assert controls.path_control("path_1080p", SEED, "cpu", TINY_PATH) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["path_1080p", "path_4k_x4"])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_path_control_fails_on_the_card(seed, cell):
    _need_card()
    limit = spec.load_cell(cell).cell["check"]["mismatch_share"]
    assert controls.path_control(cell, seed, "cuda") > limit


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_train_control_fails_on_the_card(seed):
    _need_card()
    check = spec.load_cell("treenet_train").cell["check"]
    got = controls.train_control("treenet_train", seed, "cuda")
    assert any(got[k] > check[k] for k in got), got


def _scaled(fn, factor):
    def wrapped(*a, **kw):
        return fn(*a, **kw) * factor
    return wrapped


def test_path_fault_answer_altered(monkeypatch):
    from nn_bvh_tpu_torch.wavefront import film

    monkeypatch.setattr(film, "develop", _scaled(film.develop, 1.01))
    out = run.run_cell("path_1080p", SEED, 0.0, False, device="cpu", overrides=TINY_PATH)
    assert not out["correct"], out["checks"]


def test_path_fault_half_the_lanes_left_out(monkeypatch):
    from nn_bvh_tpu_torch.wavefront import integrator

    orig = integrator.trace_wave

    def half(*a, **kw):
        L, *rest = orig(*a, **kw)
        keep = torch.arange(L.shape[0], device=L.device) % 2 == 0
        return (torch.where(keep[:, None], 2.0 * L, 0.0), *rest)

    monkeypatch.setattr(integrator, "trace_wave", half)
    out = run.run_cell("path_1080p", SEED, 0.0, False, device="cpu", overrides=TINY_PATH)
    assert not out["correct"], out["checks"]


def test_train_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run.run_cell("treenet_train", SEED, 0.0, False, device="cpu", overrides=TINY_TRAIN)
    assert not out["correct"], out["checks"]


def test_joint_fault_state_unchanged(monkeypatch):
    from nn_bvh_tpu_torch.learn import joint

    orig = joint.make_joint_step

    def unchanged(*a, **kw):
        step = orig(*a, **kw)

        def run_step(state, *args):
            keep = [p.detach().clone() for p in state.model.parameters()]
            _, metrics = step(state, *args)
            with torch.no_grad():
                for p, k in zip(state.model.parameters(), keep):
                    p.copy_(k)
            return state, metrics
        return run_step

    monkeypatch.setattr(joint, "make_joint_step", unchanged)
    out = run.run_cell("joint_720p", SEED, 0.0, False, device="cpu", overrides=TINY_JOINT)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,overrides", [("treenet_train", TINY_TRAIN),
                                            ("joint_720p", TINY_JOINT)])
def test_learner_fault_half_the_batch(monkeypatch, cell, overrides):
    from nn_bvh_tpu_torch.learn import treenet

    orig = treenet.loss_fn
    monkeypatch.setattr(treenet, "loss_fn",
                        lambda model, cfg, clouds: orig(model, cfg, clouds[:clouds.shape[0] // 2]))
    out = run.run_cell(cell, SEED, 0.0, False, device="cpu", overrides=overrides)
    assert not out["correct"], out["checks"]


def _plant(fault: str) -> None:
    """Plant `fault` under render_sharded in this rank: "exchange" keeps
    the rank's own band in every slot; "zeroed-<b>" and "stale-<b>" give
    band b as zeros or as the previous image's (the exchange left out in
    part); "jaxlib-<r>" loads a module named jaxlib on rank r."""
    from nn_bvh_tpu_torch.dist import sharding

    kind, _, arg = fault.partition("-")
    orig = sharding.gather_band
    if kind == "exchange":
        sharding.gather_band = lambda x, mesh: x.repeat(mesh.world_size, *[1] * (x.dim() - 1))
    elif kind in ("zeroed", "stale"):
        b, prev = int(arg), {}

        def partial(x, mesh):
            out = orig(x, mesh)
            n = out.shape[0] // mesh.world_size
            old = prev.get(x.dim())
            prev[x.dim()] = out.clone()
            if kind == "zeroed":
                out[b * n:(b + 1) * n] = 0
            elif old is not None:
                out[b * n:(b + 1) * n] = old[b * n:(b + 1) * n]
            return out

        sharding.gather_band = partial


def _sharded_rank(rank: int, port: int, fault: str, q) -> None:
    for _p in (os.path.dirname(BENCH), BENCH):
        if _p not in sys.path:
            sys.path.insert(0, _p)
    import types

    import run as run_mod

    _plant(fault)
    ov = {"traffic": {"width": 16, "height": 8, "check_pixels": 32, "check_images": 1,
                      "ref_chunk": 8192}, "config": {"spp": 2}}
    out = run_mod.run_cell("path_4k_x4", SEED, 0.0, False, device="cpu", rank=rank, world=4,
                           port=port, overrides=ov)
    if fault == f"jaxlib-{rank}":
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
    q.put((rank, (out, run_mod.forbidden_on_every_rank(4))))


@pytest.mark.parametrize("fault", ["", "exchange", "zeroed-1", "stale-1", "stale-3",
                                   "jaxlib-3"])
def test_sharded_cell_on_four_cpu_ranks(fault):
    """The 4-rank cell on the CPU over gloo: correct as it stands; not
    correct with the bands' exchange left out, whole or for one band
    (rank 0's band is sky at every size, so a fault there changes no
    pixel); a module of JAX loaded on one rank is seen by rank 0."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank, args=(r, port, fault, q)) for r in range(4)]
    for p in procs:
        p.start()
    got, deadline = {}, time.time() + 600
    try:
        while len(got) < len(procs) and time.time() < deadline:
            try:
                r, v = q.get(timeout=5)
                got[r] = v
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs)
    assert sorted(got) == [0, 1, 2, 3], [p.exitcode for p in procs]
    out = got[0][0]
    broken = fault.split("-")[0] in ("exchange", "zeroed", "stale")
    assert out["correct"] is (not broken), out["checks"]
    assert got[1][0] is None and out["device"]["count"] == 4
    assert all(bad == (["jaxlib"] if fault.startswith("jaxlib") else []) for _, bad in
               got.values())
