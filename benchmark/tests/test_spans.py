"""CPU tests of the readers of the program's spans and counters
(harness/spans.py and the metrics that read what it computes): self
stretches, idle attribution on synthetic device events and spans, the band
gather over four ranks, and the render and learner numbers of spans that
the program recorded at a tiny size.

    python -m pytest benchmark/tests/test_spans.py -q -p no:cacheprovider -n 0
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import spans, spec  # noqa: E402

NEW = ("shade_ms_per_wave", "resort_ms_per_wave", "live_lane_pct", "sync_idle_pct.render",
       "image_setup_ms", "band_gather_ms", "fwd_ms_per_step", "bwd_ms_per_step",
       "update_ms_per_step", "sync_idle_pct.train")


def _span(name, t0, t1, parent=-1, sync=False, ms=None, image=0, wave=None, step=-1, rank=0):
    return dict(name=name, t0_ns=t0, t1_ns=t1, parent=parent, sync=sync, device_ms=ms,
                image=image, wave=wave, step=step, rank=rank)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_its_key_and_nothing_else(name):
    metrics = [{"name": name, "unit": "x"}]
    assert spec.read_metrics(metrics, {name: 12.5}) == {name: {"value": 12.5, "unit": "x"}}
    assert spec.read_metrics(metrics, {"unit": "wave", "trace": {"n": 1}}) == {}


def test_self_stretch_and_per_unit_sums():
    sp = [_span("a", 0, 10, ms=10.0, wave=1), _span("b", 1, 4, 0, ms=3.0, wave=1),
          _span("c", 4, 9, 0, ms=5.0, wave=1), _span("d", 5, 6, 2, ms=1.5, wave=1),
          _span("a", 10, 20, ms=7.0, wave=2)]
    assert spans.self_ms(sp) == [2.0, 3.0, 3.5, 1.5, 7.0]
    assert spans.per_unit(sp, ("a",), "wave") == {1: 10.0, 2: 7.0}
    assert spans.per_unit(sp, ("b", "c"), "wave") == {1: 8.0}


def test_idle_is_put_down_to_the_innermost_open_span():
    # host: A [0, 100) holds the sync read S [40, 60) and its child T [45, 50);
    # B [100, 165); nothing after 165
    sp = [_span("A", 0, 100), _span("S", 40, 60, 0, sync=True), _span("T", 45, 50, 1),
          _span("B", 100, 165)]
    # device: busy 0-10, 20-41, 52-150, 160-170 (overlapping 165-168), 215-220
    ev = [("k", 0, 10), ("k", 20, 41), ("k", 52, 150), ("k", 160, 170), ("k", 165, 168),
          ("k", 215, 220)]
    assert spans.idle_gaps(ev) == [(10, 10), (41, 11), (150, 10), (170, 45)]
    got = spans.idle_by_span(ev, sp)
    ns = {k: round(v * 1e9) for k, v in got["by_name"].items()}
    assert ns == {"A": 10, "S": 11, "B": 10, spans.OUTSIDE: 45}
    assert round(got["sync_s"] * 1e9) == 11 and round(got["idle_s"] * 1e9) == 76
    # a gap that begins in a span within a sync span is the sync span's too
    ev2 = [("k", 0, 46), ("k", 49, 50)]
    got2 = spans.idle_by_span(ev2, sp)
    assert round(got2["sync_s"] * 1e9) == 3 and list(got2["by_name"]) == ["T"]
    assert spans.top_idle(got, 2) == [[spans.OUTSIDE, got["by_name"][spans.OUTSIDE]],
                                      ["S", got["by_name"]["S"]]]


def test_band_gather_from_the_last_band_to_rank_zero_develop():
    ms = 1_000_000
    per_rank = []
    for r in range(4):
        s = []
        for img in range(3):
            base = img * 1000 * ms
            s.append(dict(name="band.to_host", image=img, rank=r, t1_ns=base + (10 + r) * ms))
            if r == 0:
                s.append(dict(name="image.develop", image=img, rank=0,
                              t1_ns=base + (20 + img) * ms))
        per_rank.append(s)
    # rank 3's band reaches the host last, at 13 ms; rank 0 develops at 20, 21, 22
    assert spans.band_gather_ms(per_rank, 3) == pytest.approx(8.0)
    assert spans.band_gather_ms(per_rank, 2) == pytest.approx(7.5)
    assert spans.band_gather_ms([[]] * 4, 3) is None
    col = {"spans": [_span("band.to_host", 0, 5), _span("wave.film", 5, 6),
                     _span("image.develop", 6, 9)], "counters": []}
    assert [s["name"] for s in spans.band_spans(col)] == ["band.to_host", "image.develop"]
    assert spans.mean_over_ranks([{"a": 1.0, "b": None}, {"a": 3.0, "b": 2.0}], ["a", "b"]) \
        == {"a": 2.0}


def test_learner_numbers_of_the_last_steps():
    sp = []
    for step in range(4):
        t = step * 100
        sp.append(_span("step.forward", t, t + 30, ms=30.0 + step, step=step))
        sp.append(_span("step.backward", t + 30, t + 80, ms=50.0, step=step))
        sp.append(_span("sync.x", t + 80, t + 90, sync=True, ms=1.0, step=step))
        sp.append(_span("step.update", t + 90, t + 100, ms=10.0, step=step))
    ev = [("k", 300, 385), ("k", 395, 400)]
    got = spans.learner_metrics({"spans": sp, "counters": []}, ev, 2)
    assert got["fwd_ms_per_step"] == pytest.approx(32.5)
    assert got["bwd_ms_per_step"] == 50.0 and got["update_ms_per_step"] == 10.0
    assert got["sync_idle_pct.train"] == pytest.approx(100.0)
    assert spans.learner_metrics({"spans": sp, "counters": []}, [], 5)["fwd_ms_per_step"] is None


def test_render_numbers_of_a_recorded_image():
    """The program's own spans and counters of a tiny Path render (CPU: no
    device stretches) through render_metrics."""
    from nn_bvh_tpu_torch import accel
    from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
    from nn_bvh_tpu_torch.utils import stats
    from nn_bvh_tpu_torch.wavefront import camera, integrator

    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera.make_perspective(xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0,
                                  width=8, height=6)
    cfg = integrator.IntegratorConfig(max_depth=3, rr_depth=1)
    stats.clear()
    stats.enable(cuda=False)
    try:
        for seed in (1, 2):
            integrator.render(sc, dbvh, cam, spp=3, sampler="independent", seed=seed, cfg=cfg,
                              device=torch.device("cpu"))
        col = stats.collect()
    finally:
        stats.disable()
        stats.clear()
    sp = col["spans"]
    t0, t1 = min(s["t0_ns"] for s in sp), max(s["t1_ns"] for s in sp)
    got = spans.render_metrics(col, [("k", t0 - 10, t0 - 5), ("k", t1 + 5, t1 + 10)], 1, 1,
                               range(1, 3))
    assert 0 < got["live_lane_pct"] <= 100
    assert got["shade_ms_per_wave"] == 0 and got["resort_ms_per_wave"] == 0
    assert got["image_setup_ms"] > 0 and got["sync_idle_pct.render"] == 0
    assert got["idle_top"] == [[spans.OUTSIDE, pytest.approx((t1 - t0 + 10) * 1e-9)]]
