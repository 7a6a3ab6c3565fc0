"""Driver of the render mixes: whole images back to back, a closed loop.

Parameters (traffic/<mix>.json): `width`, `height` of each image;
`entry` "render" (integrator.render, one process) or "render_sharded"
(dist.sharding.render_sharded over the cell's ranks, one per card, on
gloo); `check_pixels` pixels of `check_images` images compared with the
reference; `trace_waves` waves in the traced stretch; `traversal` true to
read the traversal's time and bound in the traced run. The configuration
gives the scene, the integrator, the sampler and the samples per image.

Image i of the window renders with sampler seed --seed + i. Set-up builds
the scene and its BVH and renders one whole image (another seed), so every
kernel is loaded and every shape warmed. The window renders images while
its time has not run out, checked at image boundaries (on rank 0, and
broadcast, when sharded), and ends with a synchronize: its work is every
pixel sample of the completed images. A CUDA event is recorded at the
start and after each wave (from the wave callback, with no added
synchronisation), read once after the window.
"""

from __future__ import annotations

import sys
import time

import numpy as np

WARM_SEED_OFFSET = 1_000_003


def _timed_isect(torch, dispatch, isect):
    """The program's intersectors `isect`, subclassed to time each call,
    and each call of the backend callable, by CUDA events, and to keep a
    copy of the batches while `keep`."""
    class TimedIntersectors(dispatch.Intersectors):
        def __init__(self):
            super().__init__(**isect.like())
            self.calls, self.fns, self.batches, self.keep = [], [], [], False
            inner = self.fn

            def fn(*a):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                out = inner(*a)
                e.record()
                self.fns.append((s, e))
                return out

            self.fn = fn

        def _call(self, o, d, t_max, any_hit):
            if self.keep:
                self.batches.append((o.clone(), d.clone(), t_max.clone(), any_hit))
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = super()._call(o, d, t_max, any_hit)
            e.record()
            self.calls.append((s, e))
            return out

    return TimedIntersectors()


def run(ctx) -> dict:
    import torch

    from harness import device as device_mod, geometry, trace as tr, yardstick
    from reference import path as ref
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg, tf = ctx.config, ctx.traffic
    d = device_mod.open_device(torch, ctx)
    dev, cuda, sync = d.dev, d.cuda, d.sync
    sharded = tf["entry"] == "render_sharded"
    mesh = None
    if sharded:
        from nn_bvh_tpu_torch.dist import multihost, sharding

        multihost.initialize(f"localhost:{ctx.port}", ctx.world, ctx.rank, timeout_s=900)
        mesh = sharding.make_mesh(ctx.world, device=dev)
    W, H, spp = int(tf["width"]), int(tf["height"]), int(cfg["spp"])
    integ = cfg["integrator"]

    scene, dbvh, cam, icfg, c2w = geometry.program_scene(cfg, W, H)

    def render(seed, cb=None):
        if sharded:
            return sharding.render_sharded(
                scene, dbvh, cam, mesh, spp=spp, sampler=cfg["sampler"], seed=seed, cfg=icfg,
                wave_callback=None if cb is None else (lambda s, xyz, w: cb(s)))
        return integrator.render(scene, dbvh, cam, spp=spp, sampler=cfg["sampler"], seed=seed,
                                 cfg=icfg, device=dev,
                                 wave_callback=None if cb is None else (lambda s, f: cb(s)))

    def agree(flag: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if not sharded:
            return flag
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        torch.distributed.broadcast(t, 0)
        return bool(t.item())

    # set-up: one whole image warms every kernel and shape
    render(ctx.seed + WARM_SEED_OFFSET)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rs = np.random.default_rng(ctx.seed)
    check_pix = np.sort(rs.choice(W * H, size=min(int(tf["check_pixels"]), W * H),
                                  replace=False))
    check_idx = torch.as_tensor(check_pix, device=dev)

    # the window
    events, kept, last_cb, band_done, returned, image_s = [], [], [0.0], [], [], []
    new_event = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else None

    def cb(s):
        if cuda:
            ev = new_event()
            ev.record()
            events.append(ev)
        last_cb[0] = time.time()

    sync()
    if cuda:
        ev0 = new_event()
        ev0.record()
    t_start = time.perf_counter()
    setup_s = time.time() - ctx.t0
    n_img = 0
    while agree(n_img == 0 or time.perf_counter() - t_start < ctx.seconds):
        t_img = time.perf_counter()
        img = render(ctx.seed + n_img, cb)
        returned.append(time.time())
        band_done.append(last_cb[0])
        image_s.append(time.perf_counter() - t_img)
        kept.append(img.reshape(-1, 3)[check_idx])
        n_img += 1
    sync()
    window_s = time.perf_counter() - t_start
    wave_ms = []
    if cuda:
        prev = ev0
        for ev in events:
            wave_ms.append(prev.elapsed_time(ev))
            prev = ev
    peak = device_mod.peak_bytes(torch, d)

    rec = {"unit": "wave", "setup_s": setup_s, "window_s": window_s,
           "samples": n_img * W * H * spp, "waves": n_img * spp, "wave_ms": wave_ms, "images": n_img}
    gather_s = []
    if sharded:
        per_rank = [None] * ctx.world
        torch.distributed.all_gather_object(per_rank, {"wave_ms": wave_ms, "peak": peak,
                                                       "band_done": band_done})
        rec["wave_ms"] = [w for r in per_rank for w in r["wave_ms"]]
        peak = max(r["peak"] for r in per_rank)
        # the gather and develop of an image: from the last rank's last wave
        # callback (host clock, shared by the ranks on one host) to the
        # image's return on rank 0; the wait for the slowest band before it
        # is band_skew_pct's
        gather_s = [returned[i] - max(r["band_done"][i] for r in per_rank)
                    for i in range(n_img)]
        rec["gather_ms"] = float(np.median(gather_s)) * 1e3
        if wave_ms:
            # a rank's band time of an image: its waves after the first, whose
            # time holds the image's set-up and the wait at the last gather
            per_image = np.array([[sum(r["wave_ms"][i * spp + 1:(i + 1) * spp]) for r in per_rank]
                                  for i in range(n_img)])
            rec["band_skew_pct"] = float(np.median(per_image.max(1) / per_image.mean(1)
                                                   - 1.0)) * 100

    if ctx.trace and cuda:
        rec.update(_traced(ctx, torch, tr, yardstick, dispatch, samplers, film_mod, integrator,
                           scene, dbvh, cam, icfg, render, cfg, tf, dev, sharded))
        t = rec["trace"]
        print(f"rank {ctx.rank}: {n_img} images, host s an image "
              f"{[round(x, 4) for x in image_s]}, from the last band's last wave to the "
              f"image {[round(x, 4) for x in gather_s]} s, wave ms median "
              f"{np.median(wave_ms):.2f} max {max(wave_ms):.2f}; traced {t['n']} device "
              f"events, busy {t['busy_s']:.4f} s of {t['span_s']:.4f} s, summed "
              f"{sum(t['by_name'].values()):.4f} s", file=sys.stderr, flush=True)
    device = device_mod.info(torch, d, ctx.world, peak)
    if ctx.trace and cuda:
        device.update(busy_s=rec["busy_s"], window_s=rec["trace_window_s"])
    rec["device"] = device
    if sharded:
        torch.distributed.barrier()
    if ctx.rank != 0:
        return rec

    # the answers: sampled pixels of images drawn from the seed, against the
    # plain reference, once the program's state is freed
    del scene, dbvh
    if cuda:
        torch.cuda.empty_cache()
    which = sorted(rs.choice(n_img, size=min(int(tf["check_images"]), n_img), replace=False))
    rscene = ref.Scene(geometry.triangles(), geometry.MATERIALS,
                       (geometry.CONDUCTOR_ETA, geometry.CONDUCTOR_K), dev)
    camd = dict(cam_to_world=c2w, fov=cfg["camera"]["fov"], width=W, height=H)
    t_ref = time.perf_counter()
    worst, failed = 0.0, 0
    limit = float(ctx.cell["check"]["mismatch_share"])
    band = torch.as_tensor(band_of(check_pix, W * H, ctx.world), device=dev)
    for i in which:
        want = ref.render_pixels(rscene, camd, check_pix, ctx.seed + int(i), spp,
                                 max_depth=integ["max_depth"], rr_depth=integ["rr_depth"],
                                 chunk=int(tf.get("ref_chunk", 1024)))
        share = mismatch_share(kept[i].float(), want, ctx.cell["check"], band)
        worst = max(worst, share)
        failed += share > limit
    print(f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr, flush=True)
    rec["checks"] = [["worst_band_mismatch", worst, limit]]
    rec["attempted"], rec["failed"] = n_img, failed
    return rec


def band_of(pix, n_pixels: int, bands: int):
    """The row band (0 .. bands - 1) of each flat pixel index: the image cut
    into `bands` equal runs of rows, as render_sharded gives each rank its
    own."""
    return np.asarray(pix) // (n_pixels // bands)


def mismatch_share(got, want, check: dict, band) -> float:
    """The share of pixels whose value differs from the reference's by
    more than rel * |reference| + abs in any channel (a non-finite value
    differs), in the worst band (`band`: a band index per pixel), so that
    one band gathered wrong reads its own share, not a quarter of it."""
    import torch

    tol = float(check["rel"]) * want.abs() + float(check["abs"])
    diff = (got - want).abs()
    bad = (~(diff <= tol).all(-1)).float()
    n = int(band.max()) + 1
    per = torch.zeros(n, device=bad.device).index_add_(0, band, bad)
    count = torch.zeros(n, device=bad.device).index_add_(0, band, torch.ones_like(bad))
    return float((per / count.clamp(min=1)).max())


def _traced(ctx, torch, tr, yardstick, dispatch, samplers, film_mod, integrator, scene, dbvh,
            cam, icfg, render, cfg, tf, dev, sharded) -> dict:
    """The traced stretch: waves 1..n of one image under the profiler (the
    image's set-up, in wave 0, left out); with `traversal`, two waves
    through timed intersectors and the bound of one wave's batches."""
    n = int(tf["trace_waves"])
    prof_box = {}

    def cb(s):
        if s == 0:
            torch.cuda.synchronize()
            prof_box["p"] = tr.start()
        elif s == n:
            torch.cuda.synchronize()
            prof_box["events"] = tr.stop(prof_box.pop("p"))

    render(ctx.seed + 2 * WARM_SEED_OFFSET, cb)
    summ = tr.summary(prof_box["events"])
    busy, span = summ["busy_s"], summ["span_s"]
    if sharded:
        both = [None] * ctx.world
        torch.distributed.all_gather_object(both, (busy, span))
        busy = sum(b for b, _ in both) / ctx.world
        span = sum(s for _, s in both) / ctx.world
    out = {"trace": summ, "trace_units": n, "busy_s": busy, "trace_window_s": span}
    if not tf.get("traversal"):
        return out
    isect = _timed_isect(torch, dispatch, dispatch.make_intersectors(scene, dbvh, dev))
    scfg = samplers.make_sampler(cfg["sampler"], seed=ctx.seed, spp=int(cfg["spp"]))
    wave = integrator.make_wave_fn(scene, dbvh, cam, scfg, icfg, isect=isect, device=dev)
    film = film_mod.make_film(cam.height, cam.width, dev)
    film = wave(film, 0)
    torch.cuda.synchronize()
    isect.calls.clear()
    isect.fns.clear()
    for s in (1, 2):
        film = wave(film, s)
    torch.cuda.synchronize()
    call_ms = sum(a.elapsed_time(b) for a, b in isect.calls) / 2
    fn_ms = sum(a.elapsed_time(b) for a, b in isect.fns) / 2
    isect.keep = True
    wave(film, 3)
    torch.cuda.synchronize()
    stride = yardstick.BOUND_STRIDE
    lo, hi, meta = (torch.as_tensor(x[:dbvh.n_nodes], device=dev)
                    for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    tri = torch.as_tensor(np.asarray(scene.tri_p, np.float32), device=dev)
    bound = 0.0
    for o, d, t_max, any_hit in isect.batches:
        counts = yardstick.plain_walk_counts(lo, hi, meta, tri, o[::stride], d[::stride],
                                             t_max[::stride], any_hit)
        live = int(((t_max >= 0) if any_hit else (t_max > 0)).sum())
        bound += yardstick.batch_bound(counts, t_max.numel(), live, any_hit, scale=stride)[0]
    isect.batches.clear()
    out.update(isect_ms_per_wave=call_ms, trav_ms_per_wave=fn_ms, trav_bound_ms_per_wave=bound)
    return out

