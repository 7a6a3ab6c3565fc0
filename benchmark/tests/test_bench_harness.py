"""CPU tests of the benchmark harness: its files load by name, a cell and a
metric can be added as files alone, the yardstick's arithmetic holds
against hand and brute-force counts, the rate and tail follow a stall, the
JAX check compares whole top-level names, and the references agree with
the port at a tiny size.

    python -m pytest benchmark/tests -q -p no:cacheprovider -n 0
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
from harness import geometry, learner, spec, yardstick  # noqa: E402
from reference import path as ref_path, treenet as ref_tree  # noqa: E402

TINY_PATH = {"traffic": {"width": 8, "height": 6, "check_pixels": 24, "check_images": 1,
                         "ref_chunk": 8192},
             "config": {"spp": 2}}
TINY_TRAIN = {"traffic": {"pool": 4},
              "config": {"levels": 3, "capacity": 16, "pc_size": 64, "batch": 2}}
TINY_JOINT = {"traffic": {"width": 8, "height": 6, "pool": 4}, "config": TINY_TRAIN["config"]}


def _benchmark():
    return spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_cell_config_and_metric_loads():
    b = _benchmark()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert spec.read_json(os.path.join(ROOT, c["file"]))["name"] == c["name"]
    for w in b["workloads"]:
        sp = spec.load_cell(w["name"])
        assert (sp.cell["config"], sp.cell["traffic"], sp.chips) == (w["config"], w["traffic"],
                                                                     w["chips"])
        assert callable(sp.driver.run)
        for m in sp.end_to_end + sp.per_layer:
            assert m["name"] in {x["name"] for x in b["end_to_end"] + b["per_layer"]}
    for m in b["end_to_end"] + b["per_layer"]:
        reader = spec.load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"), "m")
        assert reader.read({}) is None  # finds nothing in an empty record


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    b = _benchmark()
    b["workloads"].append({"name": "path_tiny", "config": "bench_path",
                           "traffic": "frames_tiny", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "images_done", "unit": "images", "better": "higher",
                           "source": "host_clock", "layer": "render entry",
                           "moves": "samples_per_s", "workloads": ["path_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = dict(spec.read_json(os.path.join(BENCH, "traffic", "frames_1080p.json")),
                   **TINY_PATH["traffic"])
    (bench / "traffic" / "frames_tiny.json").write_text(json.dumps(traffic))
    cell = dict(spec.read_json(os.path.join(BENCH, "workloads", "path_1080p.json")),
                traffic="frames_tiny")
    (bench / "workloads" / "path_tiny.json").write_text(json.dumps(cell))
    (bench / "metrics" / "images_done.py").write_text(
        "def read(rec):\n    return rec.get('images')\n")
    out = run.run_cell("path_tiny", 5, 0.0, True, device="cpu",
                       overrides={"config": TINY_PATH["config"]}, bench_dir=str(bench))
    assert out["correct"]
    assert out["metrics"]["images_done"] == {"value": 1.0, "unit": "images"}


def test_treenet_flops_against_a_hand_count():
    # levels 2 (one encoder, one node), C = 4, N = 5, batch 1, EPO:
    # vert 2*5*3*3*4 = 360, w1..w3 3 * 2*5*3*4*4 = 1440, pool 2*5*3*4 = 120,
    # r1 2*3*4*4 = 96, r2 2*3*4*2 = 48, r3 2*3*2 = 12 -> 2,076 forward
    assert yardstick.treenet_step_flops(2, 4, 5, 1) == 3 * 2076
    # levels 3 adds six nodes, a batch of 2 doubles it
    assert yardstick.treenet_step_flops(3, 4, 5, 2) == 3 * 2076 * 7 * 2
    # the products the plain encoder runs, counted by torch
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    w = {k: torch.rand(s, generator=g) for k, s in
         {"vert": (3, 4), "w1": (4, 4), "w2": (4, 4), "w3": (4, 4), "r1": (4, 4),
          "r2": (4, 2), "r3": (2, 1)}.items()}
    cloud = torch.rand(1, 1, 5, 9, generator=g)
    with FlopCounterMode(display=False) as fc:
        ref_tree.encode(w, cloud, torch.ones(1, 1, 5), 4.0)
    assert fc.get_total_flops() == 2076


def _two_leaf_tree():
    """Four triangles in two leaves of two, the leaves' boxes x in [0, 1]
    and [2, 3], z in [4, 6] (every triangle in the plane z = 5)."""
    tri = np.array([[[0, 0, 5], [1, 0, 5], [0, 1, 5]], [[0, 0.5, 5], [1, 0.5, 5], [0, 1, 5]],
                    [[2, 0, 5], [3, 0, 5], [2, 1, 5]], [[2, 0.5, 5], [3, 0.5, 5], [2, 1, 5]]],
                   np.float32)
    lo = np.array([[0, 0, 4], [0, 0, 4], [2, 0, 4]], np.float32)
    hi = np.array([[3, 1, 6], [1, 1, 6], [3, 1, 6]], np.float32)
    meta = np.array([[2, 0, 0], [0, 2, 0], [2, 2, 0]], np.int32)
    return tri, lo, hi, meta


def test_traversal_bound_against_a_brute_force_count():
    tri, lo, hi, meta = _two_leaf_tree()
    rs = np.random.RandomState(0)
    # rays along +y at z = 5 inside the slab of a leaf or between them: box
    # hits without triangle hits, so no t pruning and a count by brute force
    xs = rs.uniform(-0.5, 3.5, 64).astype(np.float32)
    o = np.stack([xs, np.full(64, -1.0, np.float32), np.full(64, 5.0, np.float32)], 1)
    d = np.tile(np.array([[0, 1, 0]], np.float32), (64, 1))
    t_max = np.where(rs.rand(64) < 0.25, -1.0, 1e30).astype(np.float32)
    T = lambda a: torch.as_tensor(a)
    got = yardstick.plain_walk_counts(T(lo), T(hi), T(meta), T(tri), T(o), T(d), T(t_max),
                                      any_hit=False)
    live = t_max > 0
    in_box = lambda k: (xs >= lo[k, 0]) & (xs <= hi[k, 0])
    root = live  # the walk starts at the root and tests its two children
    assert got["slab"] == 2 * int(root.sum())
    assert got["tri"] == 2 * int((root & in_box(1)).sum() + (root & in_box(2)).sum())
    assert got["tris"] == 2 * (int((root & in_box(1)).any()) + int((root & in_box(2)).any()))
    ms, flops, nbytes = yardstick.batch_bound(got, 64, int(live.sum()), False)
    assert flops == got["slab"] * 26 + got["tri"] * 58
    assert nbytes == live.sum() * 24 + 64 * 20 + got["nodes"] * 24 + got["tris"] * 36
    assert ms == max(flops / 67e12, nbytes / 3.35e12) * 1e3


def test_a_stall_in_the_window_moves_the_rate_and_the_tail():
    samples = spec.load_module(os.path.join(BENCH, "metrics", "samples_per_s.py"), "a")
    p90 = spec.load_module(os.path.join(BENCH, "metrics", "wave_ms_p90.py"), "b")
    waves = [100.0] * 160
    rec = {"unit": "wave", "samples": 160 * 1000, "wave_ms": waves, "window_s": 16.0}
    stalled = dict(rec, wave_ms=[w + (400.0 if 40 <= i < 60 else 0.0)
                                 for i, w in enumerate(waves)], window_s=16.0 + 20 * 0.4)
    assert samples.read(stalled) < samples.read(rec)
    assert p90.read(stalled) > p90.read(rec)


def test_the_jax_check_compares_whole_top_level_names():
    ok = ["nn_bvh_tpu_torch", "nn_bvh_tpu_torch.accel.dispatch", "numpy", "jaxtyping",
          "nn_bvh_tpu_tools"]
    assert spec.forbidden_modules(ok) == []
    for bad in ("jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "nn_bvh_tpu",
                "nn_bvh_tpu.core.rng", "flax"):
        assert spec.forbidden_modules(ok + [bad]) == [bad]


def test_path_reference_matches_the_port_on_the_cpu():
    from nn_bvh_tpu_torch.wavefront import integrator

    W, H, spp, seed = 6, 4, 2, 2 ** 31 + 5
    conf = spec.load_cell("path_1080p").config
    sc, dbvh, cam, cfg, c2w = geometry.program_scene(conf, W, H)
    img = integrator.render(sc, dbvh, cam, spp=spp, seed=seed, cfg=cfg, device="cpu")
    rs = ref_path.Scene(geometry.triangles(), geometry.MATERIALS,
                        (geometry.CONDUCTOR_ETA, geometry.CONDUCTOR_K), "cpu")
    want = ref_path.render_pixels(rs, dict(cam_to_world=c2w, fov=50.0, width=W, height=H),
                                  np.arange(W * H), seed, spp, chunk=8192)
    assert float(want.mean()) > 0
    torch.testing.assert_close(img.reshape(-1, 3), want, rtol=1e-5, atol=1e-6)


def test_treenet_reference_matches_the_port_on_the_cpu():
    sp = spec.load_cell("treenet_train")
    cfg = dict(sp.config, **TINY_TRAIN["config"])
    gen = torch.Generator().manual_seed(3)
    weights = learner.make_weights(torch, cfg, gen, "cpu")
    clouds = learner.make_clouds(torch, geometry.cloud_rule(cfg["pc_size"]), 2 * 2, gen,
                                   "cpu").reshape(2, 2, cfg["pc_size"], 9)
    from nn_bvh_tpu_torch.learn import encoder as enc_mod, trainer, treenet

    tcfg = treenet.TreeNetConfig(levels=3, capacity=16, pc_size=64)
    model = treenet.TreeNet(tcfg, [enc_mod.Encoder({k: v.clone() for k, v in w.items()})
                                   for w in weights])
    state = trainer.TrainState(model, trainer.make_optimizer(model, tcfg), 0)
    step = trainer.make_train_step(tcfg)
    losses = [float(step(state, clouds[i])[1]["loss"]) for i in range(2)]
    want = ref_tree.train(weights, cfg, [clouds[0], clouds[1]])
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-5)
    for (name, w0), p in zip(((f"{l}.{k}", v) for l, w in enumerate(weights)
                              for k, v in w.items()), model.parameters()):
        torch.testing.assert_close(p.detach() - w0, want["delta"][name], rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("cell,overrides", [("path_1080p", TINY_PATH),
                                            ("treenet_train", TINY_TRAIN),
                                            ("joint_720p", TINY_JOINT)])
def test_a_cell_runs_correct_on_the_cpu(cell, overrides):
    out = run.run_cell(cell, 2 ** 31 + 11, 0.0, False, device="cpu", overrides=overrides)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
