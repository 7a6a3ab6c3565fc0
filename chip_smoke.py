#!/usr/bin/env python3
"""Smoke run of the torch port (nn_bvh_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the bench configuration of bench.py (400x400
Path integrator, MIS + Russian roulette, depth 4, Sobol 16 spp, power light
sampler, the 52,996-triangle sphere-field scene), through its user entry
points, once per traversal backend, and checks it:

1. environment: a CUDA card is required; prints nvidia-smi's name and power
   limit;
2. build: compiles the three traversal sources, the lab's and the material
   gradient's of csrc/ with nvcc, one process each, all at once; prints
   their ptxas register / spill lines and fails if any kernel spills (the
   lab's floor and its probe too); then the material gradient
   (`phase_material_grad`) at the joint_720p shape against the float64
   segment sum, bit-equal twice and with no atomic instruction, its device
   ms beside its bound, aten's index_put_ backward and two plain float32
   forms of the sum;
3. BVH4 kernel vs plain: closest-hit and any-hit on 160,000 camera rays and
   160,000 incoherent rays (20% dead lanes), through the CUDA kernel and the
   plain torch traversal, under the kernels' contract
   (tools/bench_scene.check_hits): closest-hit t bit-equal on every lane,
   prim, b1, b2 equal wherever prim is, a differing prim only on an exact t
   tie of two hit triangles (tie lanes counted and printed), any-hit
   occlusion equal on every lane, dead lanes miss (closest) or report
   occluded (any-hit). Kernel times are device times (bench_scene.device_ms:
   50 back-to-back calls between two CUDA events, the stream held busy while
   the host enqueues them), with the host's time per call (host_us) and one
   launch between two events (median of 5, host and device time together,
   as earlier rounds timed it); the plain version's median of 5 calls;
4. main path: make_wave_fn -> one warm-up wave + 4 timed waves; the image
   must be finite with mean > 0, and the kernel's launch count must equal
   the traversal calls the integrator made (0 < calls <= 9 per wave);
5. the same seed through backend="plain" and the kernel: film XYZ within
   rtol 1e-3 + atol 1e-4 on >= 99.5% of pixels, mean within 0.1%;
6. phase 3 for the binary (stack 64), deep binary (stack 128) and BVH8
   kernels against their plain versions, the same contract and times;
7. a synthetic binary tree of depth 100 (too deep for the 64-entry stack,
   whose packer must refuse it) through the deep binary kernel and its plain
   version, with phase 3's checks;
8. one bench wave per new backend through make_wave_fn: launches of its
   kernel = traversal calls, no other kernel launched, film within phase 5's
   tolerance of the cuda_bvh4 film of the same seed;
9. a bound per kernel on the incoherent closest batch
   (bench_scene.traversal_bound): the larger of FLOPs / 67 TFLOP/s (float32
   outside the tensor cores) and bytes / 3.35 TB/s, with the box and
   triangle tests, and the node records and triangles read, counted by the
   plain version on the same batch, beside the kernel's device time;
10. the kernel lab's main path (`python -m nn_bvh_tpu_torch.tools.kernel_lab`,
   the bench scene's camera, bounce and shadow classes at R = 65,536):
   launches of lab_traverse, floor_bench and brless_traverse > 0, and one
   of binary_traverse (the camera hits of the ray classes), nothing else;
11. each lab variant (kernel_lab.VARIANTS: lab_traverse rows 8, 16, 32,
   k_pop 2 and 4, no leaf tests, vec; brless_traverse both modes) on each
   class: its time (CUDA events, median of 5) beside cuda_binary's
   (device_ms), the cluster geometry it ran with (kernel_lab.launch_geometry:
   blocks per packet, threads a block) and the microseconds per
   visit of the longest packet (ms / its visits: max cnt, or for brless the
   plain version's count where it ran); its prims against
   cuda_binary's on live lanes (a lane that differs must be a tie, both
   hits, |dt| <= 1e-4); bit for bit against its plain version (t, prim,
   cnt, cnt2) on the camera and shadow classes, and on the bounce class
   for the first variant of each kernel (the plain walk takes seconds
   there), whose plain call is timed, with a bound by phase 9's rule: its
   box and triangle tests counted by the plain version on that batch (every
   lane's box test per packet visit, the triangle tests masked in), o and d
   for every lane (dead lanes vote in a packet);
12. the loop-floor probe, one packet a cluster as the lab's packets are:
   the three floor_bench variants (stack only,
   +load, +slab) at n_iter = 20,000 at each geometry of
   kernel_lab.FLOOR_GEOMETRIES (rows 32 at the lab's cluster of 8 blocks of
   512 threads; rows 4 as one block of 512; rows 4 as 8 blocks of 64), bit
   for bit against floor_bench_plain, in ns an iteration (the mean of two
   medians of 5); each with its bound by bytes or FLOPs and its chain
   estimate: 20,000 times the cycles of the pieces on the variant's chain
   of dependences (kernel_lab.floor_cycles: each piece timed alone by
   clock64 on the card; kernel_lab.floor_chain) at the SM clock nvidia-smi
   prints while the card spins, and its share of the kernel's time (above
   100% where the pieces overlap in the kernel); then a lab visit split
   by the floor's steps at rows 32 (stack and barrier, record load and
   publication, vote) beside phase 11's microseconds per visit of the
   longest packet without and with leaf tests;
13. the nine traversal batches of one bench wave (sample 0 through the
   default cuda_bvh4 intersectors, recorded as trace_wave hands them over,
   in its lane order, as bench_scene.wave_batches does; launch counts reset
   just before and read just after: 9 launches = 9 traversal calls),
   through bench_scene.time_traversals for each of the four per-ray kernels
   (bvh4_traverse against plain, binary_traverse and binary_traverse_deep
   against plain_binary, bvh8_traverse against plain_bvh8): for each batch,
   its live lanes, the plain walk's work per lane and per warp
   (bench_scene.warp_work), the kernel's device time (two readings), its
   device time with L2 flushed before each call (device_ms(cold=True): a
   write of twice the card's L2, the median of 50 calls each between its
   own events) and host time, the plain version's time, the bound by phase
   9's rule, and phase 3's contract with its tie count; then for each
   kernel the sums, its "traversal device ms per wave" warm and cold with
   its bound, and torch.profiler's device time of the kernel on two batches
   beside device_ms;
14. gradients: d sum(film.xyz)/R / d mat_coeffs and / d light_scale of one
   bench wave (depth 4, Russian roulette off: rr_depth 99) by autograd,
   through cuda_bvh4 and through the plain traversal on the card (rtol 1e-3
   + atol 1e-6), central finite differences with common random numbers on
   the coefficient of largest gradient (relative error < 2%), the forward +
   backward time by CUDA events and the peak memory;
15. VolPath through make_wave_fn, which takes the phased wave
   (volpath.make_phased_wave) over cuda_bvh4: `volpath_bench` (the bench
   scene and wave with kind="volpath") over 16 waves, its image mean within
   5% of Path's over the same 16 waves; `volpath_fog` (the fog sphere of
   tests/test_phased_wave.py at 400x400 with the crown's settings: depth
   100, rr_depth 2, MIS, power light sampler; Sobol for the crown's
   Halton); for each the wave time by CUDA events (a warm-up, then 3
   waves), bvh4_traverse launches a wave, the CUDA kernels of a wave
   (torch.profiler), the lanes and live lanes of each phase; the fog image
   finite with mean > 0, its peak memory, and its phased wave over
   cuda_bvh4 against trace_wave_vol over the plain traversal on sample 0
   (atol and rtol 1e-5), every batch the phased wave hands the
   kernel held against the plain traversal (phase 3's contract, tie lanes
   counted); the fog scene as built (its sphere opaque: no ray enters the
   medium) and with the sphere as a medium boundary (rays scatter in it);
16. the materials: `bench_scene.build_material_scene()` (the bench
   geometry, its 24 spheres cycling through twelve materials: smooth and
   rough dielectric, thin dielectric, diffuse transmission, coated diffuse
   and coated conductor, a mix, hair, a measured GGX table, subsurface,
   spectral gold, diffuse) at 400x400 through make_wave_fn on cuda_bvh4 with
   the bench configuration: the wave time by CUDA events (a warm-up, then 3
   waves), bvh4_traverse launches a wave, peak memory, CUDA kernels and
   copies a wave (torch.profiler), also with the coated spheres made
   diffuse (the layered walk's share); the image finite with mean > 0; the
   same seed through the plain traversal gives the same film by phase 5's
   rule, while every batch the kernel is handed (the subsurface probes
   among them) is held against the plain traversal (phase 3's contract,
   tie lanes counted); the gradient of one wave with Russian roulette off
   (d sum(film.xyz)/R / d mat_coeffs, by autograd over two chunks of
   80,000 lanes, which bounds autograd's memory) finite on every material,
   the first chunk's equal through cuda_bvh4 and the plain traversal (rtol
   1e-3 + atol 1e-6), its forward + backward time and peak memory; then
   phase 15's fog run on `build_fog_scene(interface="glass")` (a
   dielectric sphere, eta 1.33, holding the fog; one timed wave after the
   warm-up, ~8 s each): time, launches, phases, the phased wave against
   trace_wave_vol (1e-5), lane scatterings in the fog > 0, and the lanes
   whose medium changed on real transmission through the glass > 0. Each
   line ends with the seconds since phase 16 began;
17. lights, light samplers, samplers, quadrics and motion blur, each wave
   through make_wave_fn on cuda_bvh4 at 400x400 over the bench geometry
   (52,996 triangles): `bench_scene.build_lights_scene` (one bench sphere
   an analytic sphere light, point, spot and distant lights, a 128x128
   equal-area sky map, four analytic quadrics; Path MIS, depth 4, Halton
   16 spp) with the light BVH (17.1), under the other CUDA backends
   (17.2), seen through a portal with the exhaustive sampler (17.3), with
   kind="volpath" (the phased wave, 17.4); `build_motion_scene` (every
   other sphere moving, a panning camera; Sobol) with every batch held
   against the plain traversal on the wave's lerped tables (17.5); one
   wave per new sampler kind (stratified, halton, zsobol, pmj02bn,
   fullsobol) and their get_1d/get_2d on the card bit-equal to the CPU's
   on 65,536 (pixel, sample, dim) triples (17.6). For each scene: ms a
   wave (CUDA events, the median of 3 after a warm-up), CUDA kernels and
   copies a wave (torch.profiler), bvh4_traverse launches (equal to the
   traversal calls, no other kernel), peak memory, the image finite with
   mean > 0, and the same seed through the plain traversal within phase 5's
   rule (17.2: each backend's film against cuda_bvh4's);
18. the treeNet learner (learn/): `cli.train` at its defaults (levels 4,
   capacity 128, 2,048-prim clouds, EPO, batch 8) for 2 steps, finite
   history lines; 18.1 the same configuration trained on the bench
   geometry (`bench_scene.treenet_scene`: the floor static, the 24 spheres
   movable) through `trainer.make_train_step`: a warm-up step, then 10
   steps by CUDA events (median, min, max), peak memory, CUDA kernels and
   copies a step (torch.profiler), device busy time a step (the summed
   durations of the device's events), every loss finite, with its
   tree_loss, pen_loss and thetas out of [0, 1]; one batch-1 step from the
   same weights on the card and on the CPU: losses within rtol 1e-4,
   gradients within 1e-3 of each tensor's largest |g|; 18.2 one timed step
   of the SAH (point) variant; 18.3 the trained model's Adam step count and
   loss parts on the bench cloud, its planes for that cloud, their SAH/EPO
   cost (`tree_eval`) beside the greedy tree's, the scene rebuilt through them
   (`joint.rebuild_scene_with_predicted_tree`: `export.planes_to_bvh`,
   `accel.apply_bvh_to_scene`), its bench wave through cuda_bvh4 equal to
   the SAH film by phase 5's rule, and bvh4_traverse device ms over a
   wave's batches on both trees, warm and with L2 flushed; 18.4 one joint
   step (`joint.make_joint_step`) on phase 14's configuration (the bench
   wave, RR off) over the predicted BVH with the tree branch at full width:
   time, peak memory, launches = traversal calls, material_grad's two
   launches a bounce and no other kernel, gnorm_tree and gnorm_mat finite
   and > 0 (the step updates 18.1's model in place, after 18.3 has read
   it). Its main path's launches (the wave and the joint step) count in
   bvh4_traverse's; the joint step's material_grad launches are that
   kernel's row.
19. scene input: `bench_scene.write_pbrt_bench` writes the bench
   configuration as a .pbrt file into a temporary directory (the 24
   spheres as three binary plymesh files under a checkerboard, a scaled
   256^2 imagemap and a mix whose amount is an imagemap; the floor under
   the 2048^2 PNG written by the port's write_png; the emissive quad; a
   loopsubdiv shape, curves and an analytic sphere; an infinite light from
   an equal-area EXR written by the port's write_exr). 19.1:
   `cli.render.main([scene, "--outfile", out.exr, "--stats"])` on the card
   (parse, atlas-pack, scene and native BVH build seconds, render seconds,
   rays/s, atlas MiB, peak memory); the native builder was used; out.exr
   reads back bit-equal to the returned image, finite with mean > 0.
   19.2: one wave of the parsed scene with its textures and without (base
   colors from the rows, mix amounts 0.5, no atlas): ms a wave (CUDA
   events, the median of 5 after a warm-up), CUDA kernels a wave
   (torch.profiler), launches = traversal calls. 19.3: the parsed builder
   plus a projection and a goniometric light, its wave timed in turn with
   19.2's two (five rounds; the median of each). 19.4: a parsed cloud
   medium scene, one timed VolPath wave (the phased wave) at 400x400.
   19.2-19.4 go through phase 17's `scene_waves`: each scene's film
   through the plain traversal agrees with the cuda_bvh4 film (phase 5's
   rule). Its launches count in bvh4_traverse's.
20. the remaining integrators on the bench configuration (52,996
   triangles, 400x400, depth 4, power light sampler, seed 0) through
   cuda_bvh4: 20.1 the RandomWalk and AO waves through make_wave_fn (no
   MIS, no light sampling, as the CLI sets them; phase 17's scene_waves:
   ms a wave, the median of 3 after a warm-up); 20.2 render_lightpath and
   render_bdpt at 1 spp; 20.3 render_sppm's iterations (run_sppm, 2
   iterations of R photons) with the photons its per-cell cap dropped;
   20.4 render_mlt at 1 spp (4,096 chains, 39 mutation steps, 9 bootstrap
   batches: the check, on the card, that the wave's re-sort carries each
   chain's sample index). For each: seconds (CUDA events), bvh4_traverse
   launches = traversal calls and no other kernel, CUDA kernels and copies
   (torch.profiler, a second run, whose image must equal the first's for
   the line's "repeatable"), peak memory, the image finite with mean > 0,
   and the same seed through the plain traversal by phase 5's rule (MLT:
   the kernel's and the plain traversal's render at 200x200); 20.5
   each mean against Path's (phase 5's film): LightPath within 12%, MLT
   within max(0.03, 15%), BDPT within 5% (the JAX package's own bands),
   SPPM's ratio printed; 20.6 cli.render on phase 19's pbrt file with
   `--integrator bdpt --spp 1 --stats` (the EXR read back bit-equal, the
   stats JSON's dist_avg_path_length) and with `--pixelstats` (four PNGs
   read back). Its launches count in bvh4_traverse's.
21. the film surface, the cameras and the image tools on the bench
   configuration (400x400, depth 4, Sobol, power light sampler) through
   cuda_bvh4: 21.1 one Path wave per camera (orthographic, equirect and
   equal-area spherical, realistic with the built-in lens focused at 1,000
   mm) through phase 17's scene_waves (ms a wave, launches = traversal
   calls, the plain traversal's film by phase 5's rule, every batch held
   against the plain traversal); for the realistic camera the vignetted
   lanes of sample 0 (sent from (0, 0, -1e9) along +z) counted and their
   camera batch held against the plain traversal apart from the other
   lanes (phase 3's contract); 21.2 a measured sensor (canon_eos_5d_mkiv,
   white balance 5000 K) through make_wave_fn (Path) and the phased wave
   (VolPath), and a 3000 K white-balanced PixelSensor developing the same
   kinds' films: each image finite with mean > 0 and the plain traversal's
   by phase 5's rule; 21.3 one wave's (L, lambda, pdf) into a SpectralFilm
   on the card, sequentially and by scatter, equal to the CPU's on the same
   inputs (1e-5); 21.4 render_gbuffer at 400x400, its camera batch held
   against the plain traversal and every AOV equal to the plain
   traversal's but on tie lanes, then `imgtool denoise` of a 1-spp bench
   image guided by its normal and albedo; 21.5 cli.render on phase 19's
   pbrt file with a measured sensor and a white balance added and
   --display-server pointed at a TCP listener of this script (one update
   per channel a wave); 21.6 tools/determinism (256x256, 4 spp, two fresh
   wave functions: bit-identical); 21.7 pspec.power_spectrum on the card
   against the CPU (rtol 1e-4 + atol 1e-4 x mean P). Its launches count in
   bvh4_traverse's.
22. dist/, the kd-tree and the reference-bound tools (`phase_dist`): 22.1
   dist.sharding.render_sharded at world size 1 on the bench configuration
   (400x400, depth 4, Sobol 16 spp) through cuda_bvh4, ms a wave (CUDA
   events between the wave callbacks, the median after the first), its
   band film after 4 waves against the same call through the plain
   traversal stopped there, by phase 5's rule; 22.3 the render killed after 8 of its 16 waves by its wave
   callback, which saves the render state
   (dist.multihost.save_render_state), then resumed from it: bit-equal to
   22.1's image; 22.2 two processes on this card (dist.multihost.run_local:
   torchrun's environment, gloo), each rank running `chip_smoke.py
   --worker`: its pixel band of the bench wave at 128x128 x 16 spp through
   bvh4_traverse, the bands gathered over gloo; the image against world
   size 1's (bit-equal printed, phase 5's rule held), the wall seconds with
   each process's start-up; 22.5 in the same ranks one data-parallel
   treeNet step (phase 18's configuration, batch 8 as 4 + 4) and one joint
   step (phase 14's wave as two bands, RR off) against this process's
   single-process losses and gradients: the losses averaged, the
   gradients summed (the JAX package's shard-mapped step), phase 18's rule
   (loss rtol 1e-4, gradients or the update within 1e-3 of the largest);
   22.4 `cli.render --sharded` on phase 19's .pbrt file on two ranks
   (128x128, 4 spp): rank 0 alone writes the PFM and the stats, which
   agree with render_sharded at world size 1 by phase 5's rule; 22.6 the
   kd-tree (accel.kdtree) built on the bench geometry (host seconds,
   nodes, max_leaf, clamped leaves), its closest and any-hit walks on
   phase 3's incoherent batch against bvh4_traverse (prim equal but on
   exact t ties and on lanes behind the mirrored clamped scan, t bit-equal
   on equal prims, occlusion equal on live lanes but those), ms by CUDA
   events and the lockstep steps; 22.7 tools.crown_grad.grad_check on the
   .pbrt file at 64x64 (material 0, the mix's diffuse side, Russian
   roulette off as phase 14's check) under 2% (with roulette its value
   printed); host-only, no render of the port: tools.crown_gate
   --use-existing gates the committed crown EXRs with numpy (PASS).
   Its launches (22.1, 22.2-22.5 as the ranks report them, 22.3, 22.4's
   reference, 22.7) count in bvh4_traverse's; 22.6's are comparisons.

Any failure raises (exit code != 0). The last two lines of standard output
are a JSON record of the kernels and {"ok": true, "device": {...}}.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

DEPTH = 4  # bench_scene.BENCH_DEPTH

# name, CUDA backend, plain twin, source, TPU kernel it replaces
KERNELS = [
    ("bvh4_traverse", "cuda_bvh4", "plain", "nn_bvh_tpu_torch/csrc/bvh4_traverse.cu",
     "nn_bvh_tpu/accel/pallas_bvh4.py:297"),
    ("binary_traverse", "cuda_binary", "plain_binary",
     "nn_bvh_tpu_torch/csrc/binary_traverse.cu", "nn_bvh_tpu/accel/pallas_traverse.py:373"),
    ("binary_traverse_deep", "cuda_binary_deep", "plain_binary_deep",
     "nn_bvh_tpu_torch/csrc/binary_traverse.cu", "nn_bvh_tpu/accel/hbm_traverse.py:255"),
    ("bvh8_traverse", "cuda_bvh8", "plain_bvh8", "nn_bvh_tpu_torch/csrc/bvh8_traverse.cu",
     "nn_bvh_tpu/accel/pallas_bvh8.py:223"),
]
LAB_SOURCE = "nn_bvh_tpu_torch/csrc/kernel_lab.cu"
LAB_REPLACES = {"lab_traverse": "tools/perf/kernel_lab.py:202",
                "brless_traverse": "tools/perf/kernel_lab.py:360",
                "floor_bench": "tools/perf/kernel_lab.py:434"}
LAB_R = 65536
MLT_CHECK_RES = 200  # 20.4's render against the plain traversal
FLOPS_FLOOR_SLAB = 6  # per lane: 2 sub, min, max, mul, compare


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def launch_counts() -> dict:
    from nn_bvh_tpu_torch.accel import kernel_launch

    return dict(kernel_launch.n_launches)


def reset_counts():
    from nn_bvh_tpu_torch.accel import kernel_launch

    kernel_launch.n_launches.clear()


def compare(torch, label, kernel, plain, o, d, t_max):
    """Kernel vs plain (callables (o, d, t_max, any_hit)) on one batch under
    the kernels' contract (bench_scene.check_hits) -> (tie lanes, max |dt|
    over lanes where both hit, hit rate of the live lanes)."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    live = t_max > 0
    hk = kernel(o, d, t_max, False)
    hp = plain(o, d, t_max, False)
    torch.cuda.synchronize()
    ties = bs.check_hits(hk, hp, t_max, False, f"{label} closest")
    both = (hk.prim >= 0) & (hp.prim >= 0)
    err = float((hk.t - hp.t)[both].abs().max()) if bool(both.any()) else 0.0
    bs.check_hits(kernel(o, d, t_max, True), plain(o, d, t_max, True), t_max, True,
                  f"{label} any-hit")
    rate = float(((hk.prim >= 0) & live).sum()) / float(live.sum())
    return ties, err, rate


def sass_atomics(torch, name: str) -> list:
    """The atomic and reduction instructions (ATOM, ATOMS, ATOMG, RED) in
    the SASS of the library of csrc/<name>.cu (cuobjdump, beside nvcc)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from nn_bvh_tpu_torch import kernels

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           kernels.load(name)._name], capture_output=True, text=True,
                          check=True).stdout
    check("partial_sums" in sass, f"{name}: no partial_sums entry in its SASS")
    return re.findall(r"\b(?:ATOM|ATOMS|ATOMG|RED)\.[A-Z0-9_.]+", sass)


def phase_material_grad(torch, dev) -> dict:
    """Phase 2: the material gather's gradient (csrc/material_grad.cu) at the
    joint_720p shape (921,600 lanes x 17 columns onto 3 rows, 10% missed
    lanes) against the float64 plain segment sum, twice bit-equal, no atomic
    instruction in its SASS; its device time beside its bound (the bytes of
    grad and ids at 3.35 TB/s), beside aten's index_put_ backward of the same
    gather and beside two plain float32 forms of the same sum that are
    deterministic (a one-hot product, one masked sum a row) -> the kernels
    line's row, whose launches phase 18.4 fills in."""
    from nn_bvh_tpu_torch.scatter import material_grad as mg
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    R, C, M = 1280 * 720, 17, 3
    gen = torch.Generator(device=dev).manual_seed(21)
    grad = torch.randn(R, C, generator=gen, device=dev)
    ids = (torch.bucketize(torch.rand(R, generator=gen, device=dev),
                           torch.tensor([0.1, 0.6, 0.9], device=dev)) - 1).to(torch.int32)
    got, again = mg.segment_sum(grad, ids, M), mg.segment_sum(grad, ids, M)
    diff = (got.double() - mg.segment_sum_plain(grad, ids, M)).abs()
    # float32 partial sums against float64: relative to each entry's absolute sum
    abs_sum = mg.segment_sum_plain(grad.abs(), ids, M)
    err = float((diff / abs_sum).max())
    check(torch.equal(got, again), "material_grad: two calls differ")
    check(err < 1e-5, f"material_grad: {err:.3g} of the absolute sum from float64")
    atomics = sass_atomics(torch, mg.NAME)
    check(not atomics, f"material_grad: atomic instructions {atomics}")
    ms = bs.device_ms(lambda: mg.segment_sum(grad, ids, M))
    plain_ms = event_ms(torch, lambda: mg.segment_sum_plain(grad, ids, M))[0]
    idx = torch.clamp(ids, min=0).long()
    aten = lambda: torch.zeros(M, C, device=dev).index_put_((idx,), grad, accumulate=True)
    aten()
    aten_ms = event_ms(torch, lambda: [aten() for _ in range(3)])[0] / 3
    rows = torch.arange(M, device=dev)
    forms = {  # plain float32, no atomics: cuBLAS's product and aten's reductions
        "one-hot product": lambda: (idx[None, :] == rows[:, None]).to(torch.float32) @ grad,
        "masked sums": lambda: torch.stack([torch.where((idx == m)[:, None], grad, 0.0).sum(0)
                                            for m in range(M)])}
    form_ms = {}
    for label, fn in forms.items():
        a, b = fn(), fn()
        f_err = float(((a.double() - mg.segment_sum_plain(grad, ids, M)).abs() / abs_sum).max())
        form_ms[label] = bs.device_ms(fn, n=20)
        print(f"phase 2: plain float32 {label}: {form_ms[label]:.4f} ms device, "
              f"{f_err:.3g} of the absolute sum from float64, two calls "
              f"{'bit-equal' if torch.equal(a, b) else 'differ'} (TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32})", flush=True)
    nbytes = (grad.numel() + ids.numel()) * 4
    bound_ms = nbytes / 3.35e12 * 1e3
    print(f"phase 2: material_grad at {R} x {C} onto {M} rows: {ms:.4f} ms device "
          f"(bound {bound_ms:.4f} ms: {nbytes} bytes at 3.35 TB/s; {bound_ms / ms:.1%} of it), "
          f"aten index_put_ backward {aten_ms:.3f} ms, float64 plain {plain_ms:.3f} ms; "
          f"{err:.3g} of the absolute sum from float64, two calls bit-equal, no atomics",
          flush=True)
    return {"name": mg.NAME, "route": "cuda", "source": "nn_bvh_tpu_torch/csrc/material_grad.cu",
            "replaces": None, "launches": None, "max_abs_err": float(diff.max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": aten_ms}


def phase_kernel_vs_plain(torch, sc, dbvh, batches, dev, backend, plain, phase):
    """Phases 3 and 6 for one kernel -> ({(batch, mode): {device ms, host
    us, single-launch ms, plain ms}}, max |dt|, the plain Intersectors)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import device_ms, host_us, median_ms

    k_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
    nodes, tris = k_isect.tables
    print(f"phase {phase}: {backend}: node table {tuple(nodes.shape)}, triangle table "
          f"{tuple(tris.shape)}")
    results = {}
    max_err = 0.0
    for name, (o, d, t_max) in batches.items():
        kern = lambda *a: k_isect.fn(*k_isect.tables, *a)
        pl = lambda *a: p_isect.fn(*p_isect.tables, *a)
        ties, err, rate = compare(torch, f"{backend} {name}", kern, pl, o, d, t_max)
        max_err = max(max_err, err)
        for mode, any_hit in (("closest", False), ("any_hit", True)):
            call = lambda: kern(o, d, t_max, any_hit)
            times = {"kernel": device_ms(call), "host_us": host_us(call),
                     "single": median_ms(call),
                     "plain": median_ms(lambda: pl(o, d, t_max, any_hit))}
            results[(name, mode)] = times
            print(f"phase {phase}: {backend} {name} {mode}: kernel {times['kernel']:.4f} ms "
                  f"device (50 calls), host {times['host_us']:.1f} us/call, one launch "
                  f"between events {times['single']:.4f} ms; plain {times['plain']:.2f} ms "
                  f"(median of 5)")
        print(f"phase {phase}: {backend} {name}: contract met (t bit-equal, prim/b1/b2 equal "
              f"but {ties} tie lanes, occlusion equal), hit rate {rate:.4f}, max |dt| {err:.3g}")
    return results, max_err, p_isect


def phase_main_path(torch, sc, dbvh, cam, dev):
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import bench_config
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg, sampler_cfg = bench_config()
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
    film = film_mod.make_film(cam.height, cam.width, dev)

    reset_counts()
    isect.n_calls = 0
    t0 = time.perf_counter()
    film = wave(film, 0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    n_waves = 4
    t0 = time.perf_counter()
    for s in range(1, 1 + n_waves):
        film = wave(film, s)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.get("bvh4_traverse", 0)
    calls = isect.n_calls

    check(launches == calls, f"kernel launches {launches} != traversal calls {calls}")
    check(0 < launches <= (2 * DEPTH + 1) * (1 + n_waves),
          f"{launches} traversal calls for {1 + n_waves} waves")
    check(sum(counts.values()) == launches, f"other kernels launched: {counts}")
    img = film_mod.develop(film)
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()) and mean > 0, f"bad image, mean {mean}")
    rays_per_s = cam.width * cam.height * (2 * DEPTH + 1) * n_waves / dt
    print(f"phase 4: warm-up wave {warm:.3f} s, {n_waves} waves {dt:.3f} s "
          f"({dt / n_waves * 1e3:.1f} ms/wave), {rays_per_s / 1e6:.3f} Mrays/s "
          f"(R*(2*depth+1)*waves/s), {launches} kernel launches = {calls} "
          f"traversal calls, image mean {mean:.5f}")
    return launches


def one_wave(torch, sc, dbvh, cam, dev, backend):
    """One bench wave (sample 0) through `backend` -> (film XYZ, kernel
    launches by name, traversal calls, seconds)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools.bench_scene import bench_config
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg, sampler_cfg = bench_config()
    isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg, isect=isect)
    film = film_mod.make_film(cam.height, cam.width, dev)
    reset_counts()
    t0 = time.perf_counter()
    xyz = wave(film, 0).xyz
    torch.cuda.synchronize()
    return xyz, launch_counts(), isect.n_calls, time.perf_counter() - t0


def film_agreement(a, b):
    close = ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all(-1).float().mean().item()
    rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-12)
    return close, rel


def phase_same_seed(torch, sc, dbvh, cam, dev):
    films = {}
    for backend in ("plain", "cuda_bvh4"):
        films[backend], _, _, sec = one_wave(torch, sc, dbvh, cam, dev, backend)
        print(f"phase 5: {backend} wave {sec:.3f} s")
    close, rel = film_agreement(films["cuda_bvh4"], films["plain"])
    check(close >= 0.995, f"film XYZ agrees on {close:.5f} of pixels")
    check(rel <= 1e-3, f"film mean differs by {rel:.3g}")
    print(f"phase 5: film XYZ agrees on {close:.6f} of pixels, mean rel diff {rel:.3g}")
    return films["cuda_bvh4"]


def phase_deep_tree(torch, dev, R):
    from nn_bvh_tpu_torch.accel import binary, binary_kernel, bvh4, traverse
    from nn_bvh_tpu_torch.tools import bench_scene

    levels = 100
    tri, db = bench_scene.build_deep_tree(levels)
    try:
        binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 64)
        check(False, "the 64-entry packer accepted a tree of depth 100")
    except ValueError:
        pass
    nodes = torch.as_tensor(binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 128),
                            device=dev)
    tris = torch.as_tensor(bvh4.pack_tris_cuda(tri), device=dev)
    o, d, t_max = (torch.as_tensor(x, device=dev)
                   for x in bench_scene.deep_tree_rays(levels, R))
    kern = lambda *a: binary_kernel.traverse(nodes, tris, *a, stack=128)
    pl = lambda *a: traverse.traverse_binary_plain(nodes, tris, *a, stack_depth=128)
    ties, err, rate = compare(torch, "deep tree", kern, pl, o, d, t_max)
    brute = traverse.intersect_brute(torch.as_tensor(tri, device=dev), o, d, t_max)
    hk = kern(o, d, t_max, False)
    check(bool(torch.equal(hk.prim, brute.prim)), "deep tree: kernel differs from brute force")
    print(f"phase 7: depth-{binary.tree_depth(db.node_meta)} tree, {R} rays: contract met "
          f"({ties} tie lanes), hit rate {rate:.4f}, max |dt| {err:.3g}, prims equal to brute "
          f"force")


def bound_ms(torch, p_isect, o, d, t_max):
    """Phase 9's bound of one closest-hit call (bench_scene.traversal_bound),
    the work counted by the plain version on this batch -> (ms, by, work)."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    counts = {}
    p_isect.fn(*p_isect.tables, o, d, t_max, False, counts=counts)
    return bs.traversal_bound(counts, t_max, False, p_isect.tables[0])


def phase_wave_batches(torch, sc, dbvh, cam, dev):
    """Phase 13: the nine traversal batches of one bench wave, recorded
    through cuda_bvh4, then every per-ray kernel held against its plain
    version and timed on them, one family of tables at a time -> {kernel:
    totals over the wave}."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    reset_counts()
    rec = bs.RecordingIntersectors(dispatch.make_intersectors(sc, dbvh, dev))
    bs.bench_wave(sc, dbvh, cam, rec)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(rec.backend == "cuda_bvh4" and counts == {"bvh4_traverse": rec.n_calls}
          and len(rec.batches) == rec.n_calls == 2 * DEPTH + 1,
          f"wave batches: {len(rec.batches)} batches, launches {counts}")
    batches = dict(zip(bs.wave_batch_names(rec.batches), rec.batches))
    families = {}  # plain twin -> {kernel name: fn(o, d, t_max, any_hit)}
    for name, backend, plain, *_ in KERNELS:
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        families.setdefault(plain, {})[name] = functools.partial(isect.fn, *isect.tables)
    totals = {}
    for plain, fns in families.items():
        p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend=plain)
        rows = bs.time_traversals(fns, batches, p_isect)
        for kname in fns:
            total = {"device_ms": 0.0, "cold_ms": 0.0, "host_us": 0.0, "bound_ms": 0.0,
                     "plain_ms": 0.0, "ties": 0}
            for name, row in rows.items():
                ms = bs.mean_ms(row, kname)
                for key, val in (("device_ms", ms), ("cold_ms", row["cold_ms"][kname]),
                                 ("host_us", row["host_us"][kname]),
                                 ("bound_ms", row["bound_ms"]), ("plain_ms", row["plain_ms"]),
                                 ("ties", row["ties"][kname])):
                    total[key] += val
                print(f"phase 13: {kname} {name:18s} live {row['live']:6d}; nodes/lane "
                      f"{row['nodes_mean']:.2f} p99 {row['nodes_p99']:.0f} max "
                      f"{row['nodes_max']}; tris/lane {row['tris_mean']:.2f} max "
                      f"{row['tris_max']}; warp max nodes {row['warp_nodes']:.1f} tris "
                      f"{row['warp_tris']:.1f}; kernel "
                      f"{'/'.join(f'{v:.4f}' for v in row['device_ms'][kname])} ms device "
                      f"(L2 flushed: {row['cold_ms'][kname]:.4f}), "
                      f"{row['host_us'][kname]:.1f} us host; {plain} {row['plain_ms']:.1f} ms; "
                      f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}; {row['work']}); "
                      f"contract met, {row['ties'][kname]} ties", flush=True)
            print(f"phase 13: {kname}: traversal device ms per wave {total['device_ms']:.4f} "
                  f"warm, {total['cold_ms']:.4f} with L2 flushed before each call, "
                  f"bound {total['bound_ms']:.6f} ms (host {total['host_us']:.1f} us, {plain} "
                  f"{total['plain_ms']:.1f} ms), {total['ties']} tie lanes", flush=True)
            for name in bs.PROFILED:
                prof = rows[name]["profiler_us"][kname]
                print(f"phase 13: {kname} profiler on {name}: "
                      + ("no device time recorded" if prof == 0 else f"{prof:.2f} us per call")
                      + f"; device_ms {bs.mean_ms(rows[name], kname) * 1e3:.2f} us per call")
            totals[kname] = total
    return totals


def phase_lab_main_path(torch):
    """Phase 10: the lab's entry point, counts reset just before and read
    just after -> launches by kernel name."""
    import contextlib
    import io

    from nn_bvh_tpu_torch.tools import kernel_lab

    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kernel_lab.main([])
    torch.cuda.synchronize()
    counts = launch_counts()
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines and lines[-1].startswith('{"kernel_lab"'),
          f"kernel_lab main returned {rc}")
    for line in lines[:-1]:
        print(f"phase 10: {line}")
    check(all(counts.get(n, 0) > 0 for n in LAB_REPLACES), f"lab kernels not launched: {counts}")
    # the camera hits that the bounce and shadow rays start from: one call
    check(set(counts) - set(LAB_REPLACES) == {"binary_traverse"}
          and counts["binary_traverse"] == 1, f"other kernels launched by the lab: {counts}")
    print(f"phase 10: kernel_lab main in {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


def event_ms(torch, fn):
    """-> (ms of one call of fn by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def lab_bound(lab_counts, R, Rp, table_bytes):
    """Phase 9's rule for a lab traversal: FLOPs of the lane box tests and
    the triangle tests masked in; bytes of o and d for every lane of the
    batch (dead lanes vote in a packet), t_max, the four outputs of the
    padded batch, the tables once."""
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    slab, tri = int(lab_counts["slab"].sum()), int(lab_counts["tri"].sum())
    flops = slab * bs.FLOPS_SLAB + tri * bs.FLOPS_TRI
    nbytes = R * (12 + 12 + 4) + Rp * 16 + table_bytes
    return flops, nbytes, dict(lane_slab_tests=slab, lane_tri_tests=tri)


def phase_lab_variants(torch, sc, dbvh, cam, dev):
    """Phases 11 and 12 -> {kernel: row of the kernels line without launches}."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import kernel_lab
    from nn_bvh_tpu_torch.tools.bench_scene import bound_of, device_ms, median_ms

    rays = kernel_lab.ray_classes(sc, dbvh, cam, LAB_R, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev, backend="cuda_binary")
    nodes, tris = kernel_lab.lab_tables(sc, dbvh, dev)
    table_bytes = nodes.numel() * nodes.element_size() + tris.numel() * tris.element_size()
    kern = {"lab_traverse": kernel_lab.lab_traverse, "brless_traverse": kernel_lab.brless_traverse}
    plain = {"lab_traverse": kernel_lab.lab_traverse_plain,
             "brless_traverse": kernel_lab.brless_traverse_plain}
    rows = {}
    ms_binary = {}
    visit_us = {}  # bounce class: us per visit of the longest packet, by variant
    for cls, (o, d, t_max) in rays.items():
        live = (t_max > 0).cpu()
        ref = isect.closest(o, d, t_max)
        ms_binary[cls] = device_ms(lambda: isect.closest(o, d, t_max))
        print(f"phase 11: {cls}: {int(live.sum())} live lanes, cuda_binary {ms_binary[cls]:.4f} ms, "
              f"hits {int((ref.prim >= 0).sum())}")
        for tag, (name, kw) in kernel_lab.VARIANTS.items():
            timed = cls == "bounce" and name not in rows
            out = kern[name](nodes, tris, o, d, t_max, **kw)
            ms = median_ms(lambda: kern[name](nodes, tris, o, d, t_max, **kw))
            r = kw["rows"]
            line = (f"phase 11: {tag:20s} {cls:7s} kernel {ms:9.4f} ms, cluster/threads "
                    f"{kernel_lab.launch_geometry(r)}")
            visits = int(out[2].max())
            if kw.get("count"):
                line += f", iters {int(out[2][::r, 0].sum())}, leafs {int(out[3][::r, 0].sum())}"
            prim, t = out[1].reshape(-1)[:LAB_R].cpu(), out[0].reshape(-1)[:LAB_R].cpu()
            if kw.get("leaf_mode") != "none":
                bp, bt = ref.prim.cpu(), ref.t.cpu()
                differ = live & (prim != bp)
                ties = differ & (prim >= 0) & (bp >= 0) & ((t - bt).abs() <= 1e-4)
                check(bool((differ == ties).all()),
                      f"{tag} {cls}: {int((differ & ~ties).sum())} live prims differ from "
                      "cuda_binary's and are no tie")
                line += f", prims = cuda_binary's ({int(ties.sum())} ties)"
            else:
                check(bool((prim == -1).all()), f"{tag} {cls}: no leaf tests, yet a hit")
            # the plain walk of the bounce class takes seconds a call on the card:
            # there only the timed variant of each kernel
            if cls != "bounce" or timed:
                lab_counts = {}
                plain_ms, want = event_ms(torch, lambda: plain[name](nodes, tris, o, d, t_max,
                                                                     counts=lab_counts, **kw))
                for a, b, what in zip(out, want, ("t", "prim", "cnt", "cnt2")):
                    check(a.shape == b.shape and bool(torch.equal(a, b)),
                          f"{tag} {cls}: {what} differs from the plain version")
                line += f", bit-equal to plain ({plain_ms:.1f} ms, one call)"
                if not visits:  # brless writes no counters: the plain walk's visits
                    visits = int(lab_counts["slab"].max()) // (r * 128)
            if visits:
                line += f", {ms * 1e3 / visits:.3f} us per visit of the longest packet ({visits})"
                if cls == "bounce":
                    visit_us[tag] = ms * 1e3 / visits
            if timed:
                flops, nbytes, work = lab_bound(lab_counts, LAB_R, out[0].numel(), table_bytes)
                bound, by = bound_of(flops, nbytes)
                rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                              "max_abs_err": float((out[0] - want[0]).abs().max())}
                line += (f"; cuda_binary {ms_binary[cls]:.4f} ms; bound {bound:.6f} ms ({by}; "
                         f"{work}, {flops} FLOPs, {nbytes} bytes)")
            print(line, flush=True)

    rows["floor_bench"] = phase_floor(torch, nodes, kernel_lab.floor_ox(rays), visit_us)
    return rows


def floor_bound(rows, with_load, with_slab, n_iter):
    """Phase 12's bound of one floor call (FLOPs and bytes of its inputs and
    output) -> (ms, by, FLOPs, bytes): the slab test on every lane each
    iteration, or one add a lane at the end and one a record; the distinct
    records read, ox where the slab reads it, the output."""
    from nn_bvh_tpu_torch.tools import kernel_lab
    from nn_bvh_tpu_torch.tools.bench_scene import bound_of

    lanes = rows * 128
    addr = kernel_lab.floor_addr(kernel_lab.floor_nodes(n_iter))
    rec_bytes = int(addr.unique().numel()) * 32 if with_load else 0
    flops = n_iter * lanes * FLOPS_FLOOR_SLAB if with_slab else (n_iter + lanes
                                                                 if with_load else 0)
    nbytes = rec_bytes + lanes * 4 * (2 if with_slab else 1)
    return (*bound_of(flops, nbytes), flops, nbytes)


def phase_floor(torch, nodes, ox, visit_us):
    """Phase 12: the floor sweep (kernel_lab.floor_sweep: every variant at
    every geometry of FLOOR_GEOMETRIES, bit for bit against the plain
    version), the pieces of an iteration (floor_cycles) and each variant's
    chain estimate at the SM clock, the split of a lab visit -> the
    floor_bench row of the kernels line."""
    from nn_bvh_tpu_torch.tools import kernel_lab as kl
    from nn_bvh_tpu_torch.tools.bench_scene import _sleep_cycles_per_ms

    sweep = kl.floor_sweep({"kernel": kl.floor_bench}, nodes, ox)
    clock = kl.sm_clock_mhz()
    print(f"phase 12: SM clock {clock:.0f} MHz (nvidia-smi clocks.sm while the card spins; "
          f"torch.cuda._sleep's clock64 rate {_sleep_cycles_per_ms() / 1e3:.0f} MHz)")
    n_iter = kl.FLOOR_ITERS
    row = None
    ns = {}
    for geo, (rows, cluster) in kl.FLOOR_GEOMETRIES.items():
        kl.floor_cycles(nodes, rows, cluster)  # a warm-up
        pieces = kl.floor_cycles(nodes, rows, cluster)
        chain = kl.floor_chain(pieces)
        print(f"phase 12: floor {geo}, cluster/threads {kl.launch_geometry(rows, cluster)}: "
              "cycles a step, each piece alone (floor_cycles, clock64, 1,000 steps): "
              + ", ".join(f"{p} {c:.1f}" for p, c in pieces.items()), flush=True)
        for variant, (wl, ws) in kl.FLOOR_VARIANTS.items():
            times = sweep[(variant, geo)]["kernel"]
            ms = sum(times) / len(times)
            ns[(variant, geo)] = kl.ns_per_iter(times)
            bound, by, flops, nbytes = floor_bound(rows, wl, ws, n_iter)
            chain_ms = n_iter * chain[variant] / (clock * 1e3)
            print(f"phase 12: floor {variant:10s} {geo:16s} {ns[(variant, geo)]:8.2f} ns/iter "
                  f"({'/'.join(f'{x:.4f}' for x in times)} ms), bit-equal to plain; bound "
                  f"{bound:.6f} ms ({by}; {flops} FLOPs, {nbytes} bytes); chain estimate "
                  f"{chain_ms:.4f} ms ({chain[variant]:.1f} cycles an iteration), "
                  f"{chain_ms / ms:.1%} of the kernel's time", flush=True)
            if geo == "rows=32" and variant == "+load":
                plain_ms, _ = event_ms(torch, lambda: kl.floor_bench_plain(nodes, ox, n_iter,
                                                                             wl, ws))
                row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "max_abs_err": 0.0}
    stack, load, slab = (ns[(v, "rows=32")] for v in kl.FLOOR_VARIANTS)
    print(f"phase 12: a lab visit at rows 32 by the floor: stack and barrier {stack:.2f} ns, "
          f"record load and publication {load - stack:.2f} ns, vote {slab - load:.2f} ns "
          f"(+slab {slab:.2f} ns); the lab's visit of the longest packet (phase 11, bounce): "
          f"{visit_us['lab rows=32 no leaf']:.3f} us without leaf tests, "
          f"{visit_us['lab rows=32 k=1']:.3f} us with them")
    return row


def phase_gradients(torch, sc, dbvh, cam, dev):
    """Phase 14: d sum(film)/R / d mat_coeffs and d / d light_scale of one
    bench wave (depth 4, Russian roulette off), through cuda_bvh4 and through
    the plain traversal on the card; central finite differences on one
    coefficient; forward + backward time and peak memory."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    cfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    tsc = scene_mod.to_device(sc, dev)
    lst = lightsamplers.build(tsc, cfg.light_sampler, dev)
    R = cam.width * cam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)
    ls = tsc.light_scale.detach().clone().requires_grad_(True)

    def loss(isect, mat_coeffs, light_scale):
        s2 = tsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        L, lam, pdf, fw = integrator.trace_wave(s2, None, cam, scfg, cfg, pix, 0, lst, isect)
        film = film_mod.add_samples(film_mod.make_film(cam.height, cam.width, dev), pix, L, lam,
                                    pdf, filter_weight=fw, sequential=True)
        return film.xyz.sum() / R

    def grads(isect):
        value = loss(isect, mc, ls)
        return value, torch.autograd.grad(value, (mc, ls))

    k_isect = dispatch.make_intersectors(sc, dbvh, dev)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    grads(k_isect)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    ms, (value, g_k) = event_ms(torch, lambda: grads(k_isect))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(counts.get("bvh4_traverse", 0) > 0 and counts.get("material_grad", 0) > 0
          and set(counts) == {"bvh4_traverse", "material_grad"},
          f"gradient wave launches {counts}")
    _, g_p = grads(p_isect)
    rtol, atol = 1e-3, 1e-6
    for name, a, b in zip(("mat_coeffs", "light_scale"), g_k, g_p):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0, f"{name} grad {a}")
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"{name}: kernel grad differs from plain by {float((a - b).abs().max()):.3g}")
    err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    # central differences with common random numbers on the largest coefficient
    i, j = divmod(int(g_k[0].abs().argmax()), 3)
    eps = 1e-3
    step = torch.zeros_like(mc)
    step[i, j] = eps
    with torch.no_grad():
        fd = (float(loss(k_isect, mc + step, ls)) - float(loss(k_isect, mc - step, ls))) / (2 * eps)
    rel = abs(float(g_k[0][i, j]) - fd) / max(abs(fd), 1e-12)
    check(rel < 0.02, f"finite differences: autograd {float(g_k[0][i, j])} vs {fd}")
    print(f"phase 14: loss {value.item():.6f}; d/d mat_coeffs {g_k[0].flatten().tolist()}, "
          f"d/d light_scale {g_k[1].flatten().tolist()}; kernel vs plain traversal: max |diff| "
          f"{err:.3g} (rtol {rtol}, atol {atol}); finite differences on mat_coeffs[{i},{j}] "
          f"(eps {eps}): autograd {float(g_k[0][i, j]):.6f}, central difference {fd:.6f}, "
          f"relative error {rel:.2e} (< 2e-2); forward + backward {ms:.1f} ms by CUDA events, "
          f"peak memory {peak / 2**20:.1f} MiB above the {base_mem / 2**20:.1f} MiB held "
          f"before; launches {counts}", flush=True)


def cuda_kernel_count(torch, fn) -> int | None:
    """CUDA kernels and copies launched by fn (torch.profiler, device
    activity only: the host's op events would make a profile of 100,000s of
    kernels take minutes to read), None when the profiler records none. The
    events are counted as kineto hands them over: prof.events() would build
    a FunctionEvent tree first, ~20x slower (a profile of 190,000 kernels
    took 40 s to read that way)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA)
    return n or None


def timed_waves(torch, label, wave, film, first: int, n: int):
    """Samples first .. first+n-1 through wave, timed by CUDA events ->
    (film, ms a wave, bvh4_traverse launches a wave, phases of the last)."""
    reset_counts()
    ms, film = event_ms(torch, lambda: functools.reduce(wave, range(first, first + n), film))
    counts = launch_counts()
    check(set(counts) == {"bvh4_traverse"}, f"{label}: launches {counts}")
    return film, ms / n, counts.get("bvh4_traverse", 0) / n, getattr(wave, "phases", None)


def phase_volpath(torch, sc, dbvh, cam, dev):
    """Phase 15: VolPath on the card through make_wave_fn (the phased wave
    over cuda_bvh4): volpath_bench against Path over 16 waves, and
    volpath_fog (the crown's settings) against trace_wave_vol."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    waves = 16
    means = {}
    for label, (cfg, scfg) in (("volpath_bench", bench_scene.volpath_bench_config()),
                               ("path", bench_scene.bench_config())):
        isect = dispatch.make_intersectors(sc, dbvh, dev)
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        check((label == "path") != hasattr(wave, "phases"), f"{label}: wrong wave function")
        film = wave(film_mod.make_film(cam.height, cam.width, dev), 0)  # warm-up
        film, ms, launches, phases = timed_waves(torch, label, wave, film, 1, 3)
        film = functools.reduce(wave, range(4, waves), film)
        img = film_mod.develop(film)
        means[label] = float(img.mean())
        check(bool(torch.isfinite(img).all()) and means[label] > 0, f"{label}: bad image")
        print(f"phase 15: {label}: {ms:.1f} ms a wave (CUDA events, 3 waves after a warm-up), "
              f"{launches:.1f} bvh4_traverse launches a wave"
              + ("" if phases is None else f", phases (depth, lanes, live) {phases}")
              + f"; image mean over {waves} waves {means[label]:.6f}", flush=True)
        if label == "volpath_bench":
            n_k = cuda_kernel_count(torch, lambda: wave(film, waves))
            print(f"phase 15: volpath_bench: CUDA kernels a wave (torch.profiler): "
                  f"{n_k if n_k is not None else 'not measured'}", flush=True)
    rel = abs(means["volpath_bench"] - means["path"]) / means["path"]
    check(rel < 0.05, f"volpath_bench mean {means['volpath_bench']} vs path {means['path']}")
    print(f"phase 15: volpath_bench mean vs Path mean over {waves} waves: {rel:.4f} (< 0.05)")

    for interface in (False, True):
        phase_fog(torch, dev, interface)


def phase_fog(torch, dev, interface, phase: int = 15):
    """Phase 15's `volpath_fog` (interface=False: the scene as
    tests/test_phased_wave.py builds it, its diffuse sphere opaque) or the
    same with the sphere as a pure medium boundary (True) or as glass
    ("glass", phase 16), so rays enter the fog: time, launches and phases of
    the phased wave, then the phased wave over cuda_bvh4 against
    trace_wave_vol over the plain traversal on the same samples, each batch
    of the kernel held against the plain traversal, counting the lanes that
    scattered in the medium there and the lanes whose medium changed."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator, volpath

    label = "volpath_fog" + {False: "", True: " (sphere as medium boundary)",
                             "glass": " (glass sphere)"}[interface]
    fsc, fdbvh, fcam = bench_scene.build_fog_scene(interface=interface)
    cfg, scfg = bench_scene.volpath_fog_config()
    isect = dispatch.make_intersectors(fsc, fdbvh, dev)
    wave = integrator.make_wave_fn(fsc, fdbvh, fcam, scfg, cfg, isect=isect)
    check(hasattr(wave, "phases"), f"{label}: make_wave_fn did not take the phased wave")
    film = wave(film_mod.make_film(fcam.height, fcam.width, dev), 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    # the glass scene's wave takes ~9 s: phase 16 times one after the warm-up
    n_timed = 3 if phase == 15 else 1
    film, ms, launches, phases = timed_waves(torch, label, wave, film, 1, n_timed)
    peak = torch.cuda.max_memory_allocated() - base_mem
    img = film_mod.develop(film)
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"{label}: bad image")
    # phase 16 counts no kernels here (~500,000 a wave, its time is enough)
    n_k = cuda_kernel_count(torch, lambda: wave(film, 4)) if phase == 15 else None
    print(f"phase {phase}: {label} ({fsc.n_tris} triangles, {fsc.n_media} medium, "
          f"{fcam.width}x{fcam.height}, depth {cfg.max_depth}): {ms:.1f} ms a wave (CUDA "
          f"events, {n_timed} wave(s) after a warm-up), {launches:.1f} bvh4_traverse launches "
          f"a wave, CUDA kernels and copies a wave (torch.profiler): "
          f"{n_k if n_k is not None else 'not measured'}, peak memory "
          f"{peak / 2**20:.1f} MiB above {base_mem / 2**20:.1f} MiB; phases of wave {n_timed} (depth, "
          f"lanes, live): {phases}; image mean {float(img.mean()):.6f}", flush=True)

    # the phased wave over cuda_bvh4 against the whole-wave trace over the
    # plain traversal, same samples, on the card; every batch the phased wave
    # hands the kernel is also held against the plain traversal (check_hits)
    tsc = scene_mod.to_device(fsc, dev)
    R = fcam.width * fcam.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    p_isect = dispatch.make_intersectors(fsc, fdbvh, dev, backend="plain")
    checked = bench_scene.CheckedIntersectors(isect, p_isect, label)
    wave = integrator.make_wave_fn(fsc, fdbvh, fcam, scfg, cfg, isect=checked)
    f_ph = f_pl = film_mod.make_film(fcam.height, fcam.width, dev)
    scattered, changed = [], []
    events, bounce = volpath.medium_events, volpath.bounce

    def counted(*a, **kw):
        out = events(*a, **kw)
        scattered.append(int(out[0].sum()))
        return out

    def counted_bounce(ctx, depth, state, allow_scatter=True):
        # lanes whose medium the bounce changed, matched by their caller lane
        out = bounce(ctx, depth, state, allow_scatter)
        n = int(max(state.perm.max(), out.perm.max())) + 1
        before = torch.full((n,), -2, dtype=torch.int32, device=dev)
        after = before.clone()
        before[state.perm] = state.cur_med
        after[out.perm] = out.cur_med
        changed.append(int((before != after).sum()))
        return out

    # one wave (sample 0): the two traces of a sample of the glass scene take ~30 s
    volpath.medium_events, volpath.bounce = counted, counted_bounce
    try:
        f_ph = wave(f_ph, 0)
        L, lam, pdf, fw = volpath.trace_wave_vol(tsc, None, fcam, scfg, cfg, pix, 0, None,
                                                 p_isect)
        f_pl = film_mod.add_samples(f_pl, pix, L, lam, pdf, filter_weight=fw, sequential=True)
    finally:
        volpath.medium_events, volpath.bounce = events, bounce
    a, b = film_mod.develop(f_ph), film_mod.develop(f_pl)
    diff = float((a - b).abs().max())
    check(bool(torch.allclose(a, b, atol=1e-5, rtol=1e-5)),
          f"{label}: phased wave differs from trace_wave_vol by {diff}")
    check((sum(scattered) > 0) == bool(interface), f"{label}: {sum(scattered)} lanes scattered")
    # the glass scene has no pure interface: each change is a real transmission
    check(interface != "glass" or sum(changed) > 0, f"{label}: no medium change")
    sizes = sorted({n for n, _ in checked.sizes}, reverse=True)
    print(f"phase {phase}: {label}: phased wave (cuda_bvh4) vs trace_wave_vol (plain), "
          f"sample 0: max |diff| {diff:.3g} (atol 1e-5, rtol 1e-5); lane scatterings in the "
          f"medium {sum(scattered)}, lanes whose medium changed {sum(changed)} (the wave of "
          f"each); the kernel held against plain on all {len(checked.sizes)} batches of the "
          f"phased wave (lanes {sizes}), contract met, {checked.ties} tie lanes", flush=True)


def phase_materials(torch, dev):
    """Phase 16: the material scene through make_wave_fn on cuda_bvh4 (time,
    launches, kernels, memory; the diffuse variant's kernels), the same seed
    through the plain traversal with every batch held against it, the
    gradient of a wave through both, then the glass fog scene."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator, subsurface

    t0 = time.perf_counter()
    msc, mdbvh, mcam = bench_scene.build_material_scene()
    dsc, ddbvh, _ = bench_scene.build_material_scene(coated=False)
    check(msc.n_tris == 52996, f"material scene has {msc.n_tris} triangles")
    print(f"phase 16: material scene {msc.n_tris} triangles, {len(msc.mat_type)} materials "
          f"(spheres: {', '.join(bench_scene.MATERIAL_KINDS)}), {msc.n_lights} lights, "
          f"built twice (as is, coated spheres diffuse) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    cfg, scfg = bench_scene.bench_config()
    label = "material scene"
    make_film = lambda: film_mod.make_film(mcam.height, mcam.width, dev)
    isect = dispatch.make_intersectors(msc, mdbvh, dev)
    check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
    wave = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=isect)
    film = wave(make_film(), 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    film, ms, launches, _ = timed_waves(torch, label, wave, film, 1, 3)
    peak = torch.cuda.max_memory_allocated() - base_mem
    img = film_mod.develop(film)
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"{label}: bad image")
    n_k = cuda_kernel_count(torch, lambda: wave(film, 4))
    dwave = integrator.make_wave_fn(dsc, ddbvh, mcam, scfg, cfg,
                                    isect=dispatch.make_intersectors(dsc, ddbvh, dev))
    dfilm = dwave(make_film(), 0)  # warm-up
    n_kd = cuda_kernel_count(torch, lambda: dwave(dfilm, 1))
    nm = lambda n: "not measured" if n is None else n
    print(f"phase 16: {label} ({mcam.width}x{mcam.height}, Path MIS, depth 4, rr_depth 2, "
          f"Sobol 16 spp): "
          f"{ms:.1f} ms a wave (CUDA events, 3 waves after a warm-up), {launches:.1f} "
          f"bvh4_traverse launches a wave, peak memory {peak / 2**20:.1f} MiB above "
          f"{base_mem / 2**20:.1f} MiB; CUDA kernels and copies a wave (torch.profiler): "
          f"{nm(n_k)}, {nm(n_kd)} with the coated spheres diffuse; image mean "
          f"{float(img.mean()):.6f} [{time.perf_counter() - t0:.0f} s]", flush=True)

    # the same seed through the plain traversal; each batch of the kernel
    # (the subsurface probes among them) held against the plain traversal
    plain = dispatch.make_intersectors(msc, mdbvh, dev, backend="plain")
    checked = bench_scene.CheckedIntersectors(isect, plain, label)
    f_k = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=checked)(make_film(), 0)
    f_p = integrator.make_wave_fn(msc, mdbvh, mcam, scfg, cfg, isect=plain)(make_film(), 0)
    close, rel = film_agreement(f_k.xyz, f_p.xyz)
    check(close >= 0.995 and rel <= 1e-3,
          f"{label}: film agrees with the plain traversal on {close:.5f} of pixels, "
          f"mean rel diff {rel:.3g}")
    n_any = sum(1 for _, a in checked.sizes if a)
    n_closest = len(checked.sizes) - n_any
    check(n_closest == 1 + n_any * (1 + subsurface.N_PROBE),
          f"{label}: {n_closest} closest-hit batches for {n_any} shadow batches")
    print(f"phase 16: {label}: the same seed through the plain traversal: film XYZ agrees on "
          f"{close:.6f} of pixels, mean rel diff {rel:.3g}; the kernel held against plain on "
          f"all {len(checked.sizes)} batches of the wave ({n_closest} closest-hit, "
          f"{n_any * subsurface.N_PROBE} of them subsurface probes, {n_any} any-hit), "
          f"contract met, {checked.ties} tie lanes [{time.perf_counter() - t0:.0f} s]",
          flush=True)

    # the gradient of one wave, Russian roulette off, in chunks of lanes
    gcfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    tsc = scene_mod.to_device(msc, dev)
    lst = lightsamplers.build(tsc, gcfg.light_sampler, dev)
    R = mcam.width * mcam.height
    chunks = torch.arange(R, dtype=torch.int32, device=dev).split(80000)
    mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)

    def grads(isect_, chunks_):
        """-> (loss, the gradient of each chunk of lanes)."""
        value, gs = 0.0, []
        for pix in chunks_:
            L, lam, pdf, fw = integrator.trace_wave(tsc.replace(mat_coeffs=mc), None, mcam,
                                                    scfg, gcfg, pix, 0, lst, isect_)
            loss = film_mod.add_samples(make_film(), pix, L, lam, pdf,
                                        filter_weight=fw).xyz.sum() / R
            gs.append(torch.autograd.grad(loss, mc)[0])
            value += float(loss.detach())
        return value, gs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    g_ms, (value, gs_k) = event_ms(torch, lambda: grads(isect, chunks))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(set(counts) == {"bvh4_traverse", "material_grad"}, f"gradient wave launches {counts}")
    g_k = sum(gs_k)
    # the plain traversal on the first chunk (~12 s a chunk), against its gradient
    _, (g_p,) = grads(plain, chunks[:1])
    check(bool(torch.isfinite(g_k).all()), f"{label}: non-finite gradient rows "
          f"{torch.nonzero(~torch.isfinite(g_k).all(-1)).flatten().tolist()}")
    g_err = float((gs_k[0] - g_p).abs().max())
    check(bool(torch.allclose(gs_k[0], g_p, rtol=1e-3, atol=1e-6)),
          f"{label}: kernel gradient differs from plain by {g_err:.3g}")
    rows = [(int(t), f"{float(m):.3g}") for t, m in zip(msc.mat_type, g_k.abs().amax(-1))]
    print(f"phase 16: {label} gradient (one wave, depth 4, RR off, {len(chunks)} chunks of "
          f"{chunks[0].numel()} lanes): loss {value:.6f}; (material tag, max |d/d "
          f"mat_coeffs|) by row {rows}; finite on all {g_k.shape[0]} rows; cuda_bvh4 vs plain "
          f"traversal on the first chunk max |diff| {g_err:.3g} (rtol 1e-3, atol 1e-6); forward + "
          f"backward {g_ms:.1f} ms by CUDA events, peak memory {peak / 2**20:.1f} MiB above "
          f"{base_mem / 2**20:.1f} MiB; {counts['bvh4_traverse']} launches "
          f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    phase_fog(torch, dev, "glass", phase=16)
    print(f"phase 16: done in {time.perf_counter() - t0:.0f} s", flush=True)


def median_wave_ms(torch, wave, film, first: int, n: int = 3):
    """Waves first .. first+n-1, each between its own CUDA events -> (film,
    median ms)."""
    times = []
    for s in range(first, first + n):
        ms, film = event_ms(torch, lambda: wave(film, s))
        times.append(ms)
    return film, sorted(times)[n // 2]


def scene_waves(torch, phase, scenes: dict, cam, cfg, scfg, dev, rounds: int = 3,
                profile: bool = True, check_batches: bool = False, sensor=None) -> dict:
    """Scenes ({label: (host scene, DeviceBVH)}) through make_wave_fn on
    cuda_bvh4: a warm-up wave each (none when rounds is 1), then `rounds`
    rounds of one wave of each scene in turn, each wave between its own CUDA
    events (interleaved, so the host's drift falls on every scene alike).
    Checks: bvh4_traverse launches = traversal calls in every timed wave;
    the image finite with mean > 0; sample 0 through the plain traversal
    gives the cuda_bvh4 film by phase 5's rule, and with check_batches every
    batch of the kernel is also held against the plain traversal on the
    same batch (bench_scene.CheckedIntersectors). Reads the median ms, CUDA
    kernels and copies a wave (torch.profiler, with profile) and a wave's
    peak memory. `sensor` goes to make_wave_fn and develop -> {label:
    dict(xyz=film XYZ of sample 0, ms=median ms, kernels=, launches=
    bvh4_traverse launches of the timed waves, mean=image mean)}."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    t0 = time.perf_counter()
    make_film = lambda: film_mod.make_film(cam.height, cam.width, dev)
    runs = {}
    for label, (sc, dbvh) in scenes.items():
        isect = dispatch.make_intersectors(sc, dbvh, dev)
        check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect, sensor=sensor)
        film = make_film()
        if rounds > 1:
            film = wave(film, 0)  # warm-up
        runs[label] = dict(sc=sc, dbvh=dbvh, isect=isect, wave=wave, film=film, ms=[],
                           launches=0, peak=0, base=None)
    first = 1 if rounds > 1 else 0  # one round: its wave is sample 0's, checked below
    for r in range(rounds):
        for label, run in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            run["isect"].n_calls = 0
            ms, run["film"] = event_ms(torch, lambda: run["wave"](run["film"], first + r))
            counts = launch_counts()
            n = counts.get("bvh4_traverse", 0)
            check(set(counts) == {"bvh4_traverse"} and n == run["isect"].n_calls,
                  f"{label}: launches {counts} for {run['isect'].n_calls} traversal calls")
            run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() - base)
            run["base"] = base if run["base"] is None else run["base"]
            run["ms"].append(ms)
            run["launches"] += n
    out = {}
    for label, run in runs.items():
        sc, dbvh, isect = run["sc"], run["dbvh"], run["isect"]
        img = film_mod.develop(run["film"], sensor=sensor)
        mean = float(img.mean())
        check(bool(torch.isfinite(img).all()) and mean > 0, f"{label}: bad image, mean {mean}")
        n_k = (cuda_kernel_count(torch, lambda: run["wave"](run["film"], rounds + 1))
               if profile else None)
        plain = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
        k_isect = bench_scene.CheckedIntersectors(isect, plain, label) if check_batches else isect
        f_k = (run["film"] if rounds == 1 and not check_batches else
               integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=k_isect,
                                       sensor=sensor)(make_film(), 0))
        f_p = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=plain,
                                      sensor=sensor)(make_film(), 0)
        close, rel = film_agreement(f_k.xyz, f_p.xyz)
        check(close >= 0.995 and rel <= 1e-3, f"{label}: film agrees with the plain traversal "
              f"on {close:.5f} of pixels, mean rel diff {rel:.3g}")
        extra = ""
        if check_batches:
            extra = (f"; the kernel held against plain on all {len(k_isect.sizes)} batches of "
                     f"wave 0, contract met, {k_isect.ties} tie lanes")
        ms = sorted(run["ms"])[rounds // 2]
        others = f", interleaved with {len(runs) - 1} other scene(s)" if len(runs) > 1 else ""
        print(f"phase {phase}: {label}: {ms:.2f} ms a wave (CUDA events, the median of {rounds}"
              f"{' after a warm-up' if rounds > 1 else ', no warm-up'}{others}; all: "
              f"{', '.join(f'{t:.1f}' for t in run['ms'])}), {run['launches'] / rounds:.1f} "
              f"bvh4_traverse launches a wave = traversal calls, CUDA kernels and copies a "
              f"wave (torch.profiler): {n_k if n_k is not None else 'not measured'}, peak "
              f"memory {run['peak'] / 2**20:.1f} MiB above {run['base'] / 2**20:.1f} MiB; image "
              f"mean {mean:.6f}; the same seed through the plain traversal: film XYZ agrees on "
              f"{close:.6f} of pixels, mean rel diff {rel:.3g}{extra} "
              f"[{time.perf_counter() - t0:.0f} s]", flush=True)
        out[label] = dict(xyz=f_k.xyz, ms=ms, kernels=n_k, launches=run["launches"],
                          mean=mean, film_k=f_k, film_p=f_p)
    return out


def peak_mib(torch, fn) -> float:
    """MiB that one call of fn holds at its peak above what was allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_lights(torch, dev) -> int:
    """Phase 17 (see the module doc) -> bvh4_traverse launches of its
    timed waves."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import film as film_mod, integrator

    t0 = time.perf_counter()
    total = 0
    sc, dbvh, cam = bench_scene.build_lights_scene("image")
    check(sc.n_tris == 52996, f"lights scene has {sc.n_tris} triangles")
    print(f"phase 17: lights scene {sc.n_tris} triangles, {sc.n_quadrics} quadrics, "
          f"{sc.n_lights} lights (tags {sorted(set(sc.light_type.tolist()))}), sky map "
          f"{tuple(sc.env_luminance.shape)}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg, scfg = bench_scene.lights_config("image")
    label = "17.1 lights, image env, light BVH"
    w = scene_waves(torch, 17, {label: (sc, dbvh)}, cam, cfg, scfg, dev)[label]
    ref = w["xyz"]
    total += w["launches"]

    for backend in ("cuda_binary", "cuda_binary_deep", "cuda_bvh8"):
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        reset_counts()
        xyz = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)(
            film_mod.make_film(cam.height, cam.width, dev), 0).xyz
        counts = launch_counts()
        name = [k[0] for k in KERNELS if k[1] == backend][0]
        check(set(counts) == {name} and counts[name] == isect.n_calls,
              f"17.2 {backend}: launches {counts} for {isect.n_calls} calls")
        close, rel = film_agreement(xyz, ref)
        check(close >= 0.995 and rel <= 1e-3, f"17.2 {backend}: film agrees with cuda_bvh4 on "
              f"{close:.5f} of pixels, mean rel diff {rel:.3g}")
        print(f"phase 17: 17.2 lights scene through {backend}: {counts[name]} launches = "
              f"traversal calls, film vs cuda_bvh4: {close:.6f} of pixels, mean rel diff "
              f"{rel:.3g}", flush=True)

    vcfg, vscfg = bench_scene.lights_config("image", kind="volpath")
    check(hasattr(integrator.make_wave_fn(sc, dbvh, cam, vscfg, vcfg, device=dev), "phases"),
          "17.4: make_wave_fn did not take the phased wave")
    label = "17.4 lights, image env, VolPath (phased wave)"
    total += scene_waves(torch, 17, {label: (sc, dbvh)}, cam, vcfg, vscfg, dev)[label]["launches"]

    psc, pdbvh, pcam = bench_scene.build_lights_scene("portal")
    pcfg, pscfg = bench_scene.lights_config("portal")
    label = "17.3 lights, portal env, exhaustive sampler"
    total += scene_waves(torch, 17, {label: (psc, pdbvh)}, pcam, pcfg, pscfg,
                         dev)[label]["launches"]

    # the two lane-by-table tensors of this slice alone, at a wave's width:
    # the env map's conditional rows and the exhaustive importance matrix
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lights, lightsamplers

    R = cam.width * cam.height
    g = torch.Generator(device=dev).manual_seed(17)
    tsc, tpsc = scene_mod.to_device(sc, dev), scene_mod.to_device(psc, dev)
    u2 = torch.rand(R, 2, generator=g, device=dev)
    lo, hi = tsc.bounds
    p = lo + torch.rand(R, 3, generator=g, device=dev) * (hi - lo)
    ex = lightsamplers.build(tpsc, "exhaustive", dev)
    env_mib = peak_mib(torch, lambda: lights.env_sample_dir(tsc, u2))
    ex_mib = peak_mib(torch, lambda: lightsamplers.sample_ctx(ex, p, u2[:, 0]))
    he, we = tsc.env_luminance.shape
    print(f"phase 17: peak memory of one call on {R} lanes: env_sample_dir {env_mib:.1f} MiB "
          f"(its conditional rows ({R}, {we + 1}) float32: {R * (we + 1) * 4 / 2**20:.1f} MiB), "
          f"exhaustive sample_ctx {ex_mib:.1f} MiB (its importances ({R}, "
          f"{ex.node_phi.shape[0]}) float32: {R * ex.node_phi.shape[0] * 4 / 2**20:.1f} MiB)",
          flush=True)

    msc, mdbvh, mcam = bench_scene.build_motion_scene()
    check(msc.tri_p_end is not None and mcam.motion_keys is not None, "17.5: nothing moves")
    mcfg, mscfg = bench_scene.bench_config()
    label = "17.5 motion scene (Sobol)"
    total += scene_waves(torch, 17, {label: (msc, mdbvh)}, mcam, mcfg, mscfg, dev,
                         check_batches=True)[label]["launches"]

    R = 65536
    gen = torch.Generator().manual_seed(17)
    pix = torch.randint(0, cam.width * cam.height, (R,), generator=gen, dtype=torch.int32)
    smp = torch.randint(0, 16, (R,), generator=gen, dtype=torch.int32)
    for kind in bench_scene.SAMPLER_KINDS:
        kcfg, kscfg = bench_scene.lights_config("image", sampler=kind)
        isect = dispatch.make_intersectors(sc, dbvh, dev)
        wave = integrator.make_wave_fn(sc, dbvh, cam, kscfg, kcfg, isect=isect)
        film = wave(film_mod.make_film(cam.height, cam.width, dev), 0)  # warm-up
        reset_counts()
        film, ms = median_wave_ms(torch, wave, film, 1)
        total += launch_counts().get("bvh4_traverse", 0)
        img = film_mod.develop(film)
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"17.6 {kind}: bad image")
        n_k = cuda_kernel_count(torch, lambda: wave(film, 4))
        dims = (0, 2, 5, 12, 33, 64)
        dcfg = samplers.to_device(kscfg, dev)
        for dim in dims:
            for fn in (samplers.get_1d, samplers.get_2d):
                on_card = fn(dcfg, pix.to(dev), smp.to(dev), dim)
                on_cpu = fn(kscfg, pix, smp, dim)
                for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                                  for x in (on_card, on_cpu))):
                    check(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
                          f"17.6 {kind}: {fn.__name__} dim {dim} differs on the card")
        print(f"phase 17: 17.6 sampler {kind}: {ms:.1f} ms a wave (median of 3), CUDA kernels "
              f"and copies a wave (torch.profiler): {n_k if n_k is not None else 'not measured'}, "
              f"image mean {float(img.mean()):.6f}; get_1d/get_2d on the card bit-equal to the "
              f"CPU on {R} (pixel, sample) pairs x dims {dims}", flush=True)
    print(f"phase 17: done in {time.perf_counter() - t0:.0f} s, {total} bvh4_traverse launches "
          f"in its timed waves", flush=True)
    return total


def max_rel_to_max(got, want) -> float:
    """max |got - want| over max |want| (each tensor's largest-|g| rule)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def wave_traversal_ms(torch, sc, dbvh, cam, dev):
    """bvh4_traverse device ms over the batches of one bench wave on this
    tree (bench_scene.wave_batches): (warm, L2 flushed before each call,
    batches)."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.tools import bench_scene as bs

    isect = dispatch.make_intersectors(sc, dbvh, dev)
    calls = [functools.partial(isect.fn, *isect.tables, *b)
             for b in bs.wave_batches(sc, dbvh, cam, dev)]
    return (sum(bs.device_ms(c) for c in calls), sum(bs.device_ms(c, cold=True) for c in calls),
            len(calls))


def phase_learner(torch, sc, dbvh, cam, dev, ref_film) -> tuple:
    """Phase 18 (see the module doc) -> (bvh4_traverse launches of its main
    path (the wave on the predicted BVH and the joint step), material_grad
    launches of the joint step)."""
    import contextlib
    import io
    import math

    from nn_bvh_tpu_torch import devices
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.cli import train as cli_train
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.learn import joint, trainer, tree_eval, treenet
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.tools import bench_scene as bs
    from nn_bvh_tpu_torch.wavefront import integrator

    t0 = time.perf_counter()
    secs = lambda: f"[{time.perf_counter() - t0:.0f} s]"
    devices.full_float32()
    # the CLI at its defaults: levels 4, capacity 128, 2,048 prims, EPO, batch 8
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(["--steps", "2", "--log-every", "1"])
    hist = [json.loads(x) for x in out.getvalue().splitlines()]
    check(len(hist) == 2 and all(math.isfinite(v) for h in hist for v in h.values()),
          f"cli.train history {hist}")
    print(f"phase 18: cli.train at its defaults (procedural scene), 2 steps: {hist} {secs()}",
          flush=True)

    # 18.1 training at full width on the bench geometry
    cfg = treenet.TreeNetConfig()
    tscene = bs.treenet_scene()
    state = trainer.make_train_state(cfg, seed=0, device=dev)
    carried = treenet.params_to_numpy(state.model)
    step = trainer.make_train_step(cfg)
    batch, n = 8, 10
    clouds = [torch.as_tensor(tscene.next_batch(batch), device=dev) for _ in range(n + 1)]
    state, _ = step(state, clouds[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times, losses, parts = [], [], []
    for c in clouds[1:]:
        ms, (state, m) = event_ms(torch, lambda: step(state, c))
        times.append(ms)
        losses.append(float(m["loss"]))
        parts.append((float(m["tree_loss"]), float(m["pen_loss"]),
                      int(m["out_of_bounds_splits"])))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # a theta per axis of every interior node (levels 0 .. levels-2) of every cloud
    n_thetas = batch * 3 * sum(6 ** l for l in range(cfg.levels - 1))
    n_k = cuda_kernel_count(torch, lambda: step(state, clouds[1]))
    busy = bs.profiler_us(lambda: step(state, clouds[1]), n=3) / 1e3
    med = float(sorted(times)[n // 2])
    print(f"phase 18: 18.1 treeNet EPO (levels {cfg.levels}, capacity {cfg.capacity}, "
          f"{cfg.pc_size} prims, batch {batch}) on the bench geometry: {med:.1f} ms a step "
          f"(median of {n} by CUDA events, min {min(times):.1f}, max {max(times):.1f}), "
          f"peak memory {peak:.1f} MiB above {base / 2**20:.1f} MiB, CUDA kernels and copies a "
          f"step {n_k}, device busy {busy:.1f} ms a step (torch.profiler, device events, 3 "
          f"steps); losses {losses}; (tree_loss, pen_loss, thetas out of [0, 1] of "
          f"{n_thetas}) {parts} {secs()}", flush=True)

    # one step at batch 1 from the same carried weights, card against CPU
    c1 = tscene.next_batch(1)

    def batch1_step(d):
        model = treenet.params_from_jax(carried, cfg, device=d)
        loss, _ = treenet.loss_fn(model, cfg, torch.as_tensor(c1, device=d))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.item(), [g.cpu() for g in grads]

    (l_gpu, g_gpu), (l_cpu, g_cpu) = batch1_step(dev), batch1_step(torch.device("cpu"))
    err = max(max_rel_to_max(a, b) for a, b in zip(g_gpu, g_cpu))
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"card loss {l_gpu} vs CPU {l_cpu}")
    check(err <= 1e-3, f"card gradients differ from the CPU's by {err:.3g} of the largest |g|")
    print(f"phase 18: 18.1 card vs CPU, one batch-1 step from the same weights: loss "
          f"{l_gpu:.7g} vs {l_cpu:.7g} (rtol 1e-4), gradients within {err:.3g} of each tensor's "
          f"largest |g| (< 1e-3) {secs()}", flush=True)

    # 18.2 the SAH variant (points)
    cfg_sah = cfg._replace(epo=False)
    st = trainer.make_train_state(cfg_sah, seed=0, device=dev)
    sstep = trainer.make_train_step(cfg_sah)
    pts = [torch.as_tensor(tscene.to_points(tscene.next_batch(batch)), device=dev)
           for _ in range(2)]
    st, _ = sstep(st, pts[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, (st, m) = event_ms(torch, lambda: sstep(st, pts[1]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(math.isfinite(float(m["loss"])), f"SAH loss {m}")
    print(f"phase 18: 18.2 treeNet SAH (points, batch {batch}): {ms:.1f} ms a step (CUDA events, "
          f"after a warm-up), peak memory {peak:.1f} MiB, loss {float(m['loss']):.6g} {secs()}",
          flush=True)

    # 18.3 the predicted tree: plane costs, the rebuilt BVH, its wave
    cloud = joint.scene_cloud(sc, cfg.pc_size, batch=1)
    with torch.no_grad():
        _, pm = treenet.loss_fn(state.model, cfg, torch.as_tensor(cloud, device=dev))
    pm = {k: float(v) for k, v in pm.items()}
    # Adam's own count: the counted and profiled steps update the model in place
    # but their states (and TrainState.step) are not kept
    n_adam = int(state.optimizer.state[next(state.model.parameters())]["step"])
    _, planes = treenet.predict_tree(state.model, cfg, torch.as_tensor(cloud, device=dev))
    pred = tree_eval.build_tree_from_planes(cloud[0], planes[0].cpu().numpy())
    greedy = tree_eval.build_tree_from_planes(cloud[0],
                                              tree_eval.greedy_tree(cloud[0], cfg.levels))
    costs = {name: (tree_eval.sah_cost(root), tree_eval.epo_cost(root, cloud[0]))
             for name, root in (("predicted", pred), ("greedy", greedy))}
    sc2, dbvh2, _ = joint.rebuild_scene_with_predicted_tree(sc, state.model, cfg,
                                                            pc_size=cfg.pc_size)
    xyz, counts, calls, sec = one_wave(torch, sc2, dbvh2, cam, dev, "cuda_bvh4")
    launches = counts.get("bvh4_traverse", 0)
    check(launches == calls and set(counts) == {"bvh4_traverse"},
          f"predicted-tree wave: launches {counts}, {calls} traversal calls")
    close, rel = film_agreement(xyz, ref_film)
    check(close >= 0.995 and rel <= 1e-3,
          f"predicted-tree film agrees with the SAH film on {close:.5f} of pixels, mean rel "
          f"diff {rel:.3g}")
    trav = {name: wave_traversal_ms(torch, s, b, cam, dev)
            for name, (s, b) in (("SAH", (sc, dbvh)), ("predicted", (sc2, dbvh2)))}
    print(f"phase 18: 18.3 the model after {n_adam} Adam steps (18.1's warm-up, timed, "
          f"counted and profiled steps) on the bench scene's cloud: tree_loss "
          f"{pm['tree_loss']:.6g}, pen_loss {pm['pen_loss']:.6g}, "
          f"{pm['out_of_bounds_splits']:.0f} of {n_thetas // batch} thetas out of [0, 1]; "
          f"predicted planes {planes[0].cpu().numpy().round(4).tolist()}; "
          f"plane-tree cost (tree_eval, the bench cloud of {cfg.pc_size} prims) SAH/EPO "
          f"predicted {costs['predicted'][0]:.4f}/{costs['predicted'][1]:.4f}, greedy "
          f"{costs['greedy'][0]:.4f}/{costs['greedy'][1]:.4f}; rebuilt BVH {dbvh2.n_nodes} "
          f"binary nodes (SAH {dbvh.n_nodes}); its bench wave through cuda_bvh4 in {sec:.3f} s, "
          f"{launches} launches = traversal calls, film vs the SAH film: {close:.6f} of pixels, "
          f"mean rel diff {rel:.3g}; bvh4_traverse device ms over the wave's batches warm / "
          f"L2 flushed: SAH {trav['SAH'][0]:.4f} / {trav['SAH'][1]:.4f} ({trav['SAH'][2]} "
          f"batches), predicted {trav['predicted'][0]:.4f} / {trav['predicted'][1]:.4f} "
          f"({trav['predicted'][2]} batches) {secs()}", flush=True)

    # 18.4 one joint step on phase 14's configuration, the tree at full width
    rcfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    tsc2 = scene_mod.to_device(sc2, dev)
    lst = lightsamplers.build(tsc2, rcfg.light_sampler, dev)
    isect = dispatch.make_intersectors(sc2, dbvh2, dev)
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
    jclouds = torch.as_tensor(joint.scene_cloud(sc2, cfg.pc_size, batch=batch), device=dev)
    jstep = joint.make_joint_step(cfg, cam, scfg, rcfg)
    jstate = joint.JointState(state.model, tsc2.mat_coeffs.detach().clone().requires_grad_(True))
    run = lambda s: jstep(s, tsc2, None, lst, jclouds, pix, 0, isect)
    jstate, _ = run(jstate)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    isect.n_calls = 0
    ms, (jstate, jm) = event_ms(torch, lambda: run(jstate))
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(counts.get("bvh4_traverse", 0) == isect.n_calls > 0
          and counts.get("material_grad", 0) == 2 * DEPTH  # two a bounce
          and set(counts) == {"bvh4_traverse", "material_grad"},
          f"joint step launches {counts}, {isect.n_calls} traversal calls")
    jm = {k: float(v) for k, v in jm.items()}
    for k in ("gnorm_tree", "gnorm_mat"):
        check(math.isfinite(jm[k]) and jm[k] > 0, f"joint step {k} {jm[k]}")
    check(all(math.isfinite(v) for v in jm.values()), f"joint step metrics {jm}")
    print(f"phase 18: 18.4 joint step (bench wave on the predicted BVH, depth {DEPTH}, RR off, "
          f"tree batch {batch}): forward + backward + update {ms:.1f} ms by CUDA events, peak "
          f"memory {peak:.1f} MiB above {base / 2**20:.1f} MiB, {counts['bvh4_traverse']} "
          f"launches = traversal calls, {counts['material_grad']} material_grad launches; "
          f"{jm} {secs()}", flush=True)
    return launches + counts["bvh4_traverse"], counts["material_grad"]


def untextured(sc):
    """The parsed scene without its textures: base colors from the material
    rows, mix amounts 0.5, the 1-texel placeholder atlas (what a scene with
    no texture carries)."""
    import numpy as np
    from nn_bvh_tpu_torch.geometry import scene as scene_mod

    params = np.array(sc.mat_params, copy=True)
    params[:, 5] = -1.0
    mix = (np.asarray(sc.mat_type) == scene_mod.MAT_MIX) & (params[:, 8] < 0)
    params[mix, 8] = 0.5
    return sc.replace(mat_params=params, tex_atlas=np.zeros((1, 4), np.float32),
                      tex_desc=np.zeros((1, 1, 3), np.int32))


def phase_scene_input(torch, dev, d) -> tuple:
    """Phase 19 (see the module doc), its pbrt files written into directory
    d -> (bvh4_traverse launches of its main path (the CLI render and the
    timed waves), the paths write_pbrt_bench returned)."""
    import contextlib
    import io
    import os

    import numpy as np
    from nn_bvh_tpu_torch import accel, native
    from nn_bvh_tpu_torch.cli import render
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.geometry import pbrt_parser
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.utils import image
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

    t0 = time.perf_counter()
    total = 0
    paths = bench_scene.write_pbrt_bench(d)
    print(f"phase 19: wrote the pbrt bench scene (three binary plymesh files, a "
          f"{bench_scene.PBRT_TEX}^2 PNG, a 128^2 equal-area EXR) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(d, "out.exr")
    buf = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(buf):
        img = render.main([paths["bench"], "--outfile", out, "--stats"])
    counts = launch_counts()
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    cli_launches = counts.get("bvh4_traverse", 0)
    check(set(counts) == {"bvh4_traverse"} and cli_launches > 0,
          f"19.1: launches {counts}")
    check(native.available(), "19.1: the native BVH builder was not used")
    check(np.array_equal(image.read_exr(out), img), "19.1: out.exr differs from the image")
    check(bool(np.isfinite(img).all()) and img.mean() > 0, f"19.1: image mean {img.mean()}")
    total += cli_launches
    print(f"phase 19.1: cli.render {paths['bench']} on the card: parse {stats['parse_s']} s, "
          f"atlas pack {stats['atlas_pack_s']} s ({stats['atlas_mib']} MiB), scene build "
          f"{stats['compile_s']} s, BVH build (native) {stats['bvh_s']} s, render "
          f"{stats['render_s']} s for {stats['spp']} spp ({stats['rays_per_s']} rays/s, "
          f"R*(2*depth+1)*spp/s), peak memory {stats.get('peak_mem_mib')} MiB; "
          f"{stats['tris']} triangles, {stats['lights']} lights; {cli_launches} "
          f"bvh4_traverse launches; out.exr read back bit-equal; image mean "
          f"{img.mean():.6f}", flush=True)

    res = pbrt_parser.parse_file(paths["bench"])
    sc, dbvh, _ = accel.build_scene_bvh(res.builder.build())
    cam = camera_mod.make_perspective(res.cam_to_world, res.fov, res.width, res.height)
    cfg = integrator.IntegratorConfig(max_depth=res.max_depth, mis=True, rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=res.spp)
    rs = np.random.RandomState(19)
    res.builder.add_projection_light((0, 7, -4), (0, -1, 0.55),
                                     rs.rand(256, 256, 3).astype(np.float32),
                                     scale=40.0, fov=40.0)
    res.builder.add_goniometric_light((3, 4, -3), (rs.rand(128, 128, 3) + 0.2)
                                      .astype(np.float32), scale=15.0)
    sc_l, dbvh_l, _ = accel.build_scene_bvh(res.builder.build())
    labels = ("19.2 textured", "19.2 untextured", "19.3 textured + two textured lights")
    waves = scene_waves(torch, 19, dict(zip(labels, ((sc, dbvh), (untextured(sc), dbvh),
                                                     (sc_l, dbvh_l)))), cam, cfg, scfg,
                        dev, rounds=5)
    total += sum(w["launches"] for w in waves.values())
    (ms_t, k_t), (ms_u, k_u), (ms_l, k_l) = ((waves[k]["ms"], waves[k]["kernels"])
                                             for k in labels)
    diff = lambda a, b: a - b if a and b else "not measured"
    print(f"phase 19.2: texturing costs {ms_t - ms_u:.2f} ms a wave ({ms_t / ms_u:.3f}x) "
          f"and {diff(k_t, k_u)} CUDA kernels a wave; phase 19.3: the two textured "
          f"lights {ms_l - ms_t:.2f} ms and {diff(k_l, k_t)} kernels", flush=True)

    t1 = time.perf_counter()
    sc_c, dbvh_c, cam_c, res_c = pbrt_parser.load_scene(paths["cloud"])
    check(sc_c.n_media == 1 and int(sc_c.med_grid_id[0]) == 0, "19.4: no cloud grid")
    cfg_c = integrator.IntegratorConfig(kind="volpath", max_depth=res_c.max_depth, rr_depth=2)
    print(f"phase 19.4: parsed the cloud scene in {time.perf_counter() - t1:.1f} s", flush=True)
    label = "19.4 cloud medium, VolPath (the phased wave), one wave"
    total += scene_waves(torch, 19, {label: (sc_c, dbvh_c)}, cam_c, cfg_c,
                         samplers.make_sampler("sobol", seed=0, spp=16), dev, rounds=1,
                         profile=False)[label]["launches"]
    print(f"phase 19: done in {time.perf_counter() - t0:.0f} s", flush=True)
    return total, paths


def render_run(torch, label, render, isect, plain_render, t0, unit=None,
               unit_name="a render", small=None):
    """One render of the integrators phase on the card (render(): an image,
    through `isect`): its seconds by CUDA events, bvh4_traverse launches
    (= isect's traversal calls, no other kernel), peak memory, CUDA kernels
    and copies (torch.profiler) of unit() (`unit_name`: an iteration or a
    mutation step; None: a second render, whose image must equal the first
    bit for bit for the line's "repeatable"), the image finite with mean > 0, and
    plain_render() (the same seed through the plain traversal) by phase
    5's rule; with `small` ((label, render at a smaller size through
    intersectors i)), that smaller render through isect against it through
    plain_render's intersectors instead. The host seconds of the profile and
    of the plain render end the line -> (image, launches, kernels of the
    unit)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    isect.n_calls = 0
    ms, img = event_ms(torch, render)
    counts = launch_counts()
    launches = counts.get("bvh4_traverse", 0)
    calls = isect.n_calls
    check(set(counts) == {"bvh4_traverse"} and launches == calls,
          f"{label}: launches {counts} for {calls} traversal calls")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()) and mean > 0, f"{label}: bad image, mean {mean}")
    again = []
    t_prof = time.perf_counter()
    n_k = cuda_kernel_count(torch, unit or (lambda: again.append(render())))
    t_plain = time.perf_counter()
    img_k, what = img, ""
    if small is None:
        img_p = plain_render()
    else:
        what, fn = small
        img_k, img_p = fn(isect), plain_render(fn)
        what = f" at {what}"
    t_end = time.perf_counter()
    close, rel = film_agreement(img_k, img_p)
    check(close >= 0.995 and rel <= 1e-3, f"{label}: image agrees with the plain traversal's "
          f"on {close:.5f} of pixels, mean rel diff {rel:.3g}")
    repeat = f", repeatable: {bool(torch.equal(again[0], img))}" if again else ""
    print(f"phase {label}: {ms / 1e3:.3f} s (CUDA events), {launches} bvh4_traverse launches = "
          f"traversal calls, CUDA kernels and copies (torch.profiler) {unit_name}: "
          f"{n_k if n_k is not None else 'not measured'}, peak memory {peak:.1f} MiB above "
          f"{base / 2**20:.1f} MiB; image mean {mean:.6f}{repeat}; the same seed through the "
          f"plain traversal{what}: {close:.6f} of pixels agree, mean rel diff {rel:.3g} (profile "
          f"{t_plain - t_prof:.1f} s, plain render {t_end - t_plain:.1f} s) "
          f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    return img, launches, n_k


def phase_integrators(torch, sc, dbvh, cam, dev, ref_xyz, bench_pbrt: str) -> int:
    """Phase 20: RandomWalk, AO, LightPath, BDPT, SPPM and MLT on the bench
    configuration through cuda_bvh4, and cli.render with bdpt, --stats and
    --pixelstats (see the module doc) -> bvh4_traverse launches of its
    main path."""
    import contextlib
    import io
    import os

    import numpy as np
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.cli import render
    from nn_bvh_tpu_torch.core import colorspace, rng
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.tools.bench_scene import bench_config
    from nn_bvh_tpu_torch.utils import image
    from nn_bvh_tpu_torch.wavefront import bdpt, integrator, lightpath, mlt, sppm

    t0 = time.perf_counter()
    cfg, scfg = bench_config()
    plain = lambda: dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    total = 0
    # 20.1: the RandomWalk and AO waves (the JAX CLI's settings: no MIS, no NEE)
    for kind in ("randomwalk", "ao"):
        kcfg = cfg._replace(kind=kind, mis=False, rr_depth=99, sample_lights=False)
        label = f"20.1 {kind}"
        total += scene_waves(torch, "20.1", {label: (sc, dbvh)}, cam, kcfg, scfg, dev)[label][
            "launches"]

    # 20.2-20.4: the render functions at 1 spp (SPPM: 2 iterations of R photons)
    R = cam.width * cam.height
    C, K, n_boot = mlt.chain_counts(1, R)
    sppm_state = []

    def run_sppm(isect, n_iterations=2):
        st = sppm.run_sppm(sc, dbvh, cam, n_iterations=n_iterations, photons_per_iter=R,
                           cfg=cfg, device=dev, isect=isect)
        sppm_state[:] = [st]
        return sppm.develop(st, n_iterations, R, cam.height, cam.width)

    def sppm_iteration():
        run_sppm(lightpath.make_intersectors(sc, dbvh, dev), 1)

    scene_d = scene_mod.to_device(sc, dev)
    ls_tables = lightsamplers.build(sc, cfg.light_sampler, dev)
    mlt_isect = dispatch.make_intersectors(sc, dbvh, dev)
    u_step = rng.hash_float(torch.arange(C, device=dev)[:, None],
                            torch.arange(mlt._n_dims(cfg), device=dev)[None, :], 0, 17)

    def mlt_step():
        mlt.trace_table(scene_d, cam, cfg, u_step, 0, 1, ls_tables, mlt_isect)

    # name -> (label, render through the intersectors i, profiled unit)
    runs = {
        "lightpath": ("20.2 lightpath, 1 spp", lambda i: lightpath.render_lightpath(
            sc, dbvh, cam, spp=1, seed=0, cfg=cfg, device=dev, isect=i), ()),
        "bdpt": ("20.2 bdpt, 1 spp", lambda i: bdpt.render_bdpt(
            sc, dbvh, cam, spp=1, seed=0, cfg=cfg, device=dev, isect=i), ()),
        "sppm": ("20.3 sppm, 2 iterations of R photons", run_sppm,
                 (sppm_iteration, "an iteration")),
        "mlt": (f"20.4 mlt, 1 spp ({C} chains, {K} steps, {n_boot} bootstrap batches)",
                lambda i: mlt.render_mlt(sc, dbvh, cam, spp=1, seed=0, cfg=cfg, device=dev,
                                         isect=i),
                (mlt_step, f"a mutation step's trace of {C:,} chains")),
    }
    # MLT's plain render at 400x400 took 51-70 s (432 plain traversal calls),
    # and the whole script ran past the 1,200 s it is allowed on a slower
    # host: MLT's kernel is held against the plain traversal on a render of
    # the same seed at MLT_CHECK_RES
    cam_s = bench_scene.bench_camera(MLT_CHECK_RES)
    C_s = mlt.chain_counts(1, cam_s.width * cam_s.height)[0]
    small = {"mlt": (f"{MLT_CHECK_RES}x{MLT_CHECK_RES} ({C_s} chains)",
                     lambda i: mlt.render_mlt(sc, dbvh, cam_s, spp=1, seed=0, cfg=cfg,
                                              device=dev, isect=i))}
    means = {}
    for name, (label, fn, unit) in runs.items():
        isect = mlt_isect if name == "mlt" else lightpath.make_intersectors(sc, dbvh, dev)
        check(isect.backend == "cuda_bvh4", f"CUDA picked {isect.backend}")
        img, n, n_k = render_run(torch, label, lambda: fn(isect), isect,
                                 lambda g=fn: g(plain()), t0, *unit, small=small.get(name))
        total += n
        means[name] = float(img.mean())
        if name == "sppm":
            print(f"phase 20.3: sppm dropped {int(sppm_state[0].dropped)} photons over the 2 "
                  f"iterations (k_cap 16)", flush=True)

    # 20.5: each mean against the Path image's (phase 5's film, sample 0)
    path_mean = float(colorspace.xyz_to_linear_srgb(ref_xyz).mean())
    # the JAX package's own bands: tests/test_lightpath.py:51, tests/test_mlt.py:39
    # (absolute 0.03 or 15%, the larger), BDPT's 5%; SPPM's ratio is printed
    bands = {"lightpath": 0.12 * path_mean, "mlt": max(0.03, 0.15 * path_mean),
             "bdpt": 0.05 * path_mean, "sppm": None}
    for name, band in bands.items():
        diff = means[name] - path_mean
        if band is not None:
            check(abs(diff) <= band, f"20.5 {name}: mean {means[name]:.5f} against Path's "
                  f"{path_mean:.5f}, outside +-{band:.5f}")
        print(f"phase 20.5: {name} mean {means[name]:.6f} / Path mean {path_mean:.6f} = "
              f"{means[name] / path_mean:.4f}"
              + (f" (band +-{band:.5f})" if band is not None else " (printed, not held)"),
              flush=True)

    # 20.6: cli.render on phase 19's pbrt bench scene: bdpt with --stats,
    # then --pixelstats
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "bdpt.exr")
        buf = io.StringIO()
        reset_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            img = render.main([bench_pbrt, "--integrator", "bdpt", "--spp", "1", "--stats",
                               "--outfile", out])
        counts = launch_counts()
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(set(counts) == {"bvh4_traverse"}, f"20.6: launches {counts}")
        check(np.array_equal(image.read_exr(out), img) and np.isfinite(img).all()
              and img.mean() > 0, f"20.6: bdpt image mean {img.mean()}")
        check(stats["dist_avg_path_length"] > 1, f"20.6: stats {stats}")
        total += counts["bvh4_traverse"]
        print(f"phase 20.6: cli.render --integrator bdpt --spp 1 --stats: render "
              f"{stats['render_s']} s, dist_avg_path_length {stats['dist_avg_path_length']}, "
              f"rays_live_per_s {stats['rays_live_per_s']}, peak memory "
              f"{stats.get('peak_mem_mib')} MiB, {counts['bvh4_traverse']} bvh4_traverse "
              f"launches, image mean {img.mean():.6f}, EXR read back bit-equal "
              f"[{time.perf_counter() - t1:.1f} s]", flush=True)
        buf = io.StringIO()
        reset_counts()
        prefix = os.path.join(d, "ps")
        with contextlib.redirect_stdout(buf):
            render.main([bench_pbrt, "--spp", "1", "--pixelstats", prefix,
                         "--outfile", os.path.join(d, "path.exr")])
        counts = launch_counts()
        totals = json.loads(buf.getvalue().strip().splitlines()[-1])
        pngs = [image.read_png(f"{prefix}-{n}.png") for n in integrator.STAT_NAMES]
        check(all(p.shape == img.shape and np.isfinite(p).all() for p in pngs)
              and totals["stats/bounces"] > 0, f"20.6: pixelstats {totals}")
        total += counts.get("bvh4_traverse", 0)
        listed = ", ".join(f"{k} {v:.0f}" for k, v in totals.items())
        print(f"phase 20.6: cli.render --pixelstats: {listed}; four PNGs read back; "
              f"{counts.get('bvh4_traverse', 0)} bvh4_traverse launches", flush=True)
    print(f"phase 20: done in {time.perf_counter() - t0:.0f} s, {total} bvh4_traverse launches",
          flush=True)
    return total


class Listener:
    """A TCP listener on localhost that records every byte it receives on
    one connection (the tev viewer's side of cli.render --display-server)."""

    def __init__(self):
        import socket
        import threading

        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.data = bytearray()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn, _ = self.srv.accept()
        with conn:
            while chunk := conn.recv(1 << 20):
                self.data += chunk

    def packets(self) -> list:
        """The packets received once the client has closed: [(type byte,
        body)] (each packet a little-endian uint32 length with itself
        counted, then its type byte)."""
        import struct

        self.thread.join(timeout=60)
        self.srv.close()
        check(not self.thread.is_alive(), "the display client did not close its socket")
        out, i = [], 0
        while i < len(self.data):
            n = struct.unpack_from("<I", self.data, i)[0]
            out.append((self.data[i + 4], bytes(self.data[i + 5:i + n])))
            i += n
        check(i == len(self.data), "a display packet is cut short")
        return out


def phase_film_cameras(torch, sc, dbvh, cam, dev, ref_xyz, bench_pbrt: str) -> int:
    """Phase 21: the cameras, sensors, spectral film, G-buffer and image
    tools on the bench configuration through cuda_bvh4 (see the module doc)
    -> bvh4_traverse launches of its main path."""
    import contextlib
    import io
    import os

    import numpy as np
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.cli import imgtool, pspec, render
    from nn_bvh_tpu_torch.core import colorspace, samplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.tools import bench_scene, determinism
    from nn_bvh_tpu_torch.utils import image
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod, film as film_mod, integrator

    t0 = time.perf_counter()
    secs = lambda: f"[{time.perf_counter() - t0:.0f} s]"
    cfg, scfg = bench_scene.bench_config()
    W, H = cam.width, cam.height
    R = W * H
    total = 0
    m = cam.cam_to_world
    cams = {"orthographic": camera_mod.make_orthographic(m, 4.0, W, H),
            "equirect": camera_mod.make_spherical(m, W, H, "equirect"),
            "equalarea": camera_mod.make_spherical(m, W, H, "equalarea"),
            "realistic": camera_mod.make_realistic(m, W, H, focus_distance=1000.0)}
    for name, c in cams.items():
        label = f"21.1 {name} camera"
        total += scene_waves(torch, "21.1", {label: (sc, dbvh)}, c, cfg, scfg, dev,
                             profile=False, check_batches=True)[label]["launches"]

    # the realistic camera's vignetted lanes of sample 0, held apart
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    sid = torch.zeros(R, dtype=torch.int32, device=dev)
    scfg_d = samplers.to_device(scfg, dev)
    u_pix = torch.stack(samplers.get_2d(scfg_d, pix, sid, integrator.DIM_PIXEL), -1)
    u_lens = torch.stack(samplers.get_2d(scfg_d, pix, sid, integrator.DIM_LENS), -1)
    o, d = camera_mod.generate_rays(cams["realistic"], pix, u_pix, u_lens)
    vig = o.abs().amax(-1) > 1e6
    k_isect = dispatch.make_intersectors(sc, dbvh, dev)
    p_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="plain")
    parts = []
    for part, mask in (("vignetted", vig), ("traced", ~vig)):
        n = int(mask.sum())
        if n == 0:
            parts.append(f"0 {part} lanes")
            continue
        oo, dd = o[mask].contiguous(), d[mask].contiguous()
        tt = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
        hk, hp = k_isect.closest(oo, dd, tt), p_isect.closest(oo, dd, tt)
        ties = bench_scene.check_hits(hk, hp, tt, False, f"21.1 realistic {part} lanes")
        hits = int((hk.prim >= 0).sum())
        parts.append(f"{n} {part} lanes ({hits} hit, {ties} tie lanes)")
    print(f"phase 21.1: realistic camera, sample 0: {'; '.join(parts)}; each part's camera batch "
          f"held against the plain traversal, contract met {secs()}", flush=True)

    # 21.2: a measured sensor and a white-balanced PixelSensor, Path and VolPath
    sensors = {"measured canon_eos_5d_mkiv 5000 K":
               film_mod.make_measured_sensor("canon_eos_5d_mkiv", 5000.0),
               "PixelSensor 3000 K": film_mod.make_sensor(3000.0)}
    for sname, sensor in sensors.items():
        for kname, kcfg in (("Path, make_wave_fn", cfg),
                            ("VolPath, the phased wave", cfg._replace(kind="volpath"))):
            label = f"21.2 {sname}, {kname}"
            r = scene_waves(torch, "21.2", {label: (sc, dbvh)}, cam, kcfg, scfg, dev, rounds=1,
                            profile=False, sensor=sensor)[label]
            total += r["launches"]
            img_k = film_mod.develop(r["film_k"], sensor=sensor)
            img_p = film_mod.develop(r["film_p"], sensor=sensor)
            close, rel = film_agreement(img_k, img_p)
            check(bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0
                  and close >= 0.995 and rel <= 1e-3,
                  f"{label}: image mean {float(img_k.mean())}, {close} of pixels agree with "
                  f"the plain traversal's, mean rel diff {rel}")
            print(f"phase 21.2: {label}: developed image of sample 0 mean "
                  f"{float(img_k.mean()):.6f}, the plain traversal's agrees on {close:.6f} of "
                  f"pixels, mean rel diff {rel:.3g} {secs()}", flush=True)

    # 21.3: one wave's samples into a SpectralFilm on the card and on the CPU
    ls = lightsamplers.build(sc, cfg.light_sampler, dev)
    reset_counts()
    k_isect.n_calls = 0
    L, lam, lam_pdf, fw = integrator.trace_wave(scene_mod.to_device(sc, dev), None, cam, scfg_d,
                                                cfg, pix, 0, ls, k_isect)[:4]
    counts = launch_counts()
    check(set(counts) == {"bvh4_traverse"} and counts["bvh4_traverse"] == k_isect.n_calls,
          f"21.3: launches {counts} for {k_isect.n_calls} traversal calls")
    total += counts["bvh4_traverse"]
    perm = torch.as_tensor(np.random.RandomState(21).permutation(R).astype(np.int32), device=dev)
    errs = []
    for seq, idx in ((True, pix), (False, perm)):
        outs = []
        for device, move in ((dev, lambda t: t), ("cpu", lambda t: t.cpu())):
            sf = film_mod.add_samples_spectral(
                film_mod.make_spectral_film(H, W, device=device), move(idx), move(L),
                move(lam), move(lam_pdf), move(fw), sequential=seq)
            outs.append(film_mod.develop_spectral(sf).cpu())
        check(bool(torch.isfinite(outs[0]).all()) and float(outs[0].mean()) > 0,
              "21.3: spectral film empty")
        err = float((outs[0] - outs[1]).abs().max())
        rel = err / max(float(outs[1].abs().max()), 1e-30)
        check(torch.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5),
              f"21.3: card vs CPU max |diff| {err}")
        errs.append(f"{'sequential' if seq else 'scatter'} max |diff| {err:.3g} "
                    f"({rel:.3g} of the largest bucket)")
    print(f"phase 21.3: SpectralFilm (16 buckets) of one bench wave on the card vs the CPU: "
          f"{'; '.join(errs)}; {counts['bvh4_traverse']} bvh4_traverse launches {secs()}",
          flush=True)

    # 21.4: the G-buffer, then imgtool denoise guided by its normal and albedo
    reset_counts()
    k_isect.n_calls = 0
    ms_g, g_k = event_ms(torch, lambda: integrator.render_gbuffer(sc, dbvh, cam, isect=k_isect))
    counts = launch_counts()
    check(counts == {"bvh4_traverse": 1} and k_isect.n_calls == 1, f"21.4: launches {counts}")
    total += 1
    checked = bench_scene.CheckedIntersectors(k_isect, p_isect, "21.4 render_gbuffer")
    g_c = integrator.render_gbuffer(sc, dbvh, cam, isect=checked)
    g_p = integrator.render_gbuffer(sc, dbvh, cam, isect=p_isect)
    check(torch.equal(g_k["mask"], g_p["mask"]), "21.4: hit masks differ")
    worst = []
    differ = torch.zeros(H, W, dtype=torch.bool, device=dev)
    for k in g_k:
        check(torch.equal(g_k[k], g_c[k]), f"21.4: {k} differs run to run")
        dk = (g_k[k] - g_p[k]).abs().amax(-1)
        differ |= dk > 1e-5
        worst.append(f"{k} {float(dk.max()):.3g}")
    check(int(differ.sum()) <= checked.ties,
          f"21.4: {int(differ.sum())} pixels differ from the plain traversal's AOVs, "
          f"{checked.ties} tie lanes")
    with tempfile.TemporaryDirectory() as d:
        noisy = colorspace.xyz_to_linear_srgb(ref_xyz).reshape(H, W, 3).cpu().numpy()
        for name, a in (("noisy", noisy), ("nrm", g_k["ns"].cpu().numpy()),
                        ("alb", g_k["albedo"].cpu().numpy())):
            image.write_pfm(os.path.join(d, f"{name}.pfm"), a)
        t1 = time.perf_counter()
        imgtool.main(["denoise", os.path.join(d, "noisy.pfm"), os.path.join(d, "dn.pfm"),
                      "--normal", os.path.join(d, "nrm.pfm"), "--albedo",
                      os.path.join(d, "alb.pfm"), "--radius", "2"])
        dn_s = time.perf_counter() - t1
        dn = image.read_pfm(os.path.join(d, "dn.pfm"))
    tv = lambda a: float(np.abs(np.diff(a, axis=0)).mean() + np.abs(np.diff(a, axis=1)).mean())
    check(dn.shape == noisy.shape and np.isfinite(dn).all() and tv(dn) < tv(noisy),
          f"21.4: denoised variation {tv(dn)} against {tv(noisy)}")
    print(f"phase 21.4: render_gbuffer {W}x{H}: {ms_g:.2f} ms (CUDA events), 1 bvh4_traverse "
          f"launch, hit rate {float(g_k['mask'].mean()):.4f}, camera batch held against the "
          f"plain traversal ({checked.ties} tie lanes); max |AOV - plain| {', '.join(worst)} "
          f"({int(differ.sum())} pixels above 1e-5); imgtool denoise (radius 2) of the 1-spp "
          f"bench image by its normal and albedo: {dn_s:.1f} s, mean variation "
          f"{tv(noisy):.4f} -> {tv(dn):.4f} {secs()}", flush=True)

    # 21.5: cli.render with a measured sensor, a white balance and --display-server
    path = os.path.join(os.path.dirname(bench_pbrt), "bench_sensor.pbrt")
    with open(bench_pbrt) as f:
        text = f.read()
    check('Film "rgb"' in text, "21.5: no Film line")
    with open(path, "w") as f:
        f.write(text.replace('Film "rgb"', 'Film "rgb" "string sensor" "canon_eos_5d_mkiv" '
                             '"float whitebalance" [5000]', 1))
    lis = Listener()
    buf = io.StringIO()
    spp = 4
    reset_counts()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        img = render.main([path, "--spp", str(spp), "--stats", "--outfile",
                           os.path.join(os.path.dirname(bench_pbrt), "sensor.exr"),
                           "--display-server", f"127.0.0.1:{lis.port}"])
    cli_s = time.perf_counter() - t1
    counts = launch_counts()
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(counts) == {"bvh4_traverse"}, f"21.5: launches {counts}")
    total += counts["bvh4_traverse"]
    packets = lis.packets()
    updates = [b for t, b in packets if t == 3]
    check(packets[0][0] == 4 and len(updates) == 3 * spp and len(packets) == 1 + 3 * spp,
          f"21.5: {len(packets)} packets, {len(updates)} updates for {spp} waves")
    head = 1 + len(b"render\0") + 2 + 16
    last = np.stack([np.frombuffer(b[head:], np.float32) for b in updates[-3:]], -1)
    check(last.shape == (W * H, 3) and np.isfinite(last).all() and last.mean() > 0,
          "21.5: the last update is not an image")
    check(np.isfinite(img).all() and img.mean() > 0, f"21.5: image mean {img.mean()}")
    print(f"phase 21.5: cli.render {os.path.basename(path)} (canon_eos_5d_mkiv, white balance "
          f"5000 K) --spp {spp} --display-server: {len(updates)} image updates ({spp} waves x "
          f"3 channels) received, {len(lis.data)} bytes; render {stats['render_s']} s, "
          f"{counts['bvh4_traverse']} bvh4_traverse launches; image mean {img.mean():.6f} "
          f"(the last wave as streamed, no sensor: {last.mean():.6f}) [{cli_s:.1f} s] {secs()}",
          flush=True)

    # 21.6: tools/determinism
    buf = io.StringIO()
    reset_counts()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = determinism.main([])
    counts = launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and rep["bit_identical"] and rep["backend"] == "cuda_bvh4"
          and set(counts) == {"bvh4_traverse"}, f"21.6: {rep}, launches {counts}")
    total += counts["bvh4_traverse"]
    print(f"phase 21.6: tools/determinism: {json.dumps(rep)}, {counts['bvh4_traverse']} "
          f"bvh4_traverse launches [{time.perf_counter() - t1:.1f} s] {secs()}", flush=True)

    # 21.7: pspec's power spectrum on the card against the CPU
    sets = np.stack([pspec.sample_points("sobol", 256, s, 0) for s in range(8)])
    ms_p, P_k = event_ms(torch, lambda: pspec.power_spectrum(sets, 65, dev))
    t1 = time.perf_counter()
    P_c = pspec.power_spectrum(sets, 65, "cpu")
    cpu_ms = (time.perf_counter() - t1) * 1e3
    err = float(np.abs(P_k - P_c).max())
    check(np.allclose(P_k, P_c, rtol=1e-4, atol=1e-4 * float(P_c.mean())),
          f"21.7: power spectrum max |diff| {err}")
    print(f"phase 21.7: pspec.power_spectrum (sobol, 8 sets of 256 points, 65^2 frequencies) "
          f"on the card {ms_p:.2f} ms (CUDA events), on the CPU {cpu_ms:.1f} ms; max |diff| "
          f"{err:.3g} (mean P {float(P_c.mean()):.4f})", flush=True)
    print(f"phase 21: done in {time.perf_counter() - t0:.0f} s, {total} bvh4_traverse launches",
          flush=True)
    return total


DIST_RES = 128   # 22.2's film side
CHECK_WAVES = 4  # 22.1's waves through the plain traversal


def _last_json(out: str, key: str) -> dict:
    """The last line of a process's output that is a JSON object with `key`."""
    for line in reversed(out.splitlines()):
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)
    raise AssertionError(f"no JSON line with {key!r} in:\n{out[-3000:]}")


def dist_worker(out_dir: str, device: str | None) -> int:
    """One rank of 22.2 and 22.5 (run as `chip_smoke.py --worker OUT_DIR
    [DEVICE]` under torchrun's environment, dist.multihost.run_local): the
    bench wave's pixel bands at DIST_RES through the rank's card and a gloo
    gather, then one data-parallel train step and one joint step at phase
    18's full width. Rank 0 writes the image and the steps' results into
    OUT_DIR; every rank prints its launches, traversal calls and seconds as
    one JSON line."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    from nn_bvh_tpu_torch import devices
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.dist import multihost, sharding
    from nn_bvh_tpu_torch.learn import joint, trainer, treenet
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.tools import bench_scene
    from nn_bvh_tpu_torch.wavefront import integrator

    check(multihost.initialize(timeout_s=300), "the worker joined no process group")
    mesh = sharding.make_mesh(device=device)
    dev = mesh.device
    devices.full_float32()
    rep = {"rank": mesh.rank, "world_size": mesh.world_size, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    sc, dbvh, _ = bench_scene.build_bench_scene()
    cam = bench_scene.bench_camera(DIST_RES)
    cfg, scfg = bench_scene.bench_config()
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    rep["startup_s"] = time.perf_counter() - t_start

    # 22.2 the rank's band, gathered
    reset_counts()
    t0 = time.perf_counter()
    img = sharding.render_sharded(sc, dbvh, cam, mesh, spp=scfg.spp, sampler="sobol", seed=0,
                                  cfg=cfg, isect=isect)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rep["render_s"] = time.perf_counter() - t0
    rep["render_launches"] = launch_counts().get("bvh4_traverse", 0)
    rep["render_calls"] = isect.n_calls
    results = {"image": img.cpu()}

    # 22.5 one data-parallel train step (the whole batch of 8 split 4 + 4)
    tcfg = treenet.TreeNetConfig()
    state = trainer.make_train_state(tcfg, seed=0, device=dev)
    clouds = torch.as_tensor(bench_scene.treenet_scene().next_batch(8), device=dev)
    t0 = time.perf_counter()
    state, m = trainer.make_train_step(tcfg, mesh)(state, clouds)
    results["train"] = {"metrics": {k: float(v) for k, v in m.items()},
                        "grads": [p.grad.cpu() for p in state.model.parameters()]}
    rep["train_s"] = time.perf_counter() - t0

    # 22.5 one data-parallel joint step (phase 14's wave, RR off; pixels and clouds split)
    model = treenet.init_params(tcfg, seed=0, device=dev)
    rcfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    jscfg = samplers.make_sampler("sobol", seed=0, spp=16)
    cam_j = bench_scene.bench_camera()
    tsc = scene_mod.to_device(sc, dev)
    lst = lightsamplers.build(tsc, rcfg.light_sampler, dev)
    jisect = dispatch.make_intersectors(sc, dbvh, dev)
    pix = torch.arange(cam_j.width * cam_j.height, dtype=torch.int32, device=dev)
    jclouds = torch.as_tensor(joint.scene_cloud(sc, tcfg.pc_size, batch=8), device=dev)
    jstate = joint.JointState(model, tsc.mat_coeffs.detach().clone().requires_grad_(True))
    reset_counts()
    t0 = time.perf_counter()
    jstep = joint.make_joint_step(tcfg, cam_j, jscfg, rcfg, mesh=mesh, axis=sharding.RAY_AXIS)
    new, jm = jstep(jstate, tsc, None, lst, jclouds, pix, 0, jisect)
    rep["joint_s"] = time.perf_counter() - t0
    rep["joint_launches"] = launch_counts().get("bvh4_traverse", 0)
    rep["joint_calls"] = jisect.n_calls
    results["joint"] = {"metrics": {k: float(v) for k, v in jm.items()},
                        "params": [p.detach().cpu() for p in new.model.parameters()],
                        "mat_coeffs": new.mat_coeffs.detach().cpu()}
    if mesh.rank == 0:
        torch.save(results, os.path.join(out_dir, "dist.pt"))
    torch.distributed.barrier()
    rep["total_s"] = time.perf_counter() - t_start
    print(json.dumps(rep), flush=True)
    return 0


class _Killed(Exception):
    """Raised by 22.3's wave callback to stop a render after its checkpoint."""


def phase_dist(torch, sc, dbvh, cam, dev, batches, bench_pbrt: str,
               worker: list | None = None, device_args: tuple = ()) -> int:
    """Phase 22 (see the module doc) -> bvh4_traverse launches of its main
    path (22.1, 22.3, 22.7 in this process; 22.2 and 22.5 as the ranks
    report them). `worker` is the command of 22.2/22.5's ranks (default:
    this script with --worker) and `device_args` extra CLI arguments of
    22.4's ranks (a CPU rehearsal passes its own)."""
    import contextlib
    import io
    import math

    import numpy as np
    from nn_bvh_tpu_torch.accel import build, dispatch, kdtree
    from nn_bvh_tpu_torch.dist import multihost, sharding
    from nn_bvh_tpu_torch.geometry import pbrt_parser, scene as scene_mod
    from nn_bvh_tpu_torch.learn import joint, treenet
    from nn_bvh_tpu_torch.scatter import lightsamplers
    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.tools import bench_scene, crown_gate, crown_grad
    from nn_bvh_tpu_torch.utils import image
    from nn_bvh_tpu_torch.wavefront import integrator

    repo = os.path.dirname(os.path.abspath(__file__))
    worker = worker or [sys.executable, os.path.abspath(__file__), "--worker"]
    t0 = time.perf_counter()
    secs = lambda: f"[{time.perf_counter() - t0:.0f} s]"
    cfg, scfg = bench_scene.bench_config()
    spp = scfg.spp
    mesh = sharding.make_mesh(device=dev)
    check(mesh.world_size == 1, f"22: this process's mesh {mesh}")
    total = 0

    def sharded(backend, cam_=cam, stop=None, **kw):
        """render_sharded at world size 1 through `backend`, stopped after
        `stop` waves if given -> (image or None when stopped, the band's xyz
        after the last wave run, ms a wave (median of the waves after the
        first, CUDA events), launches, traversal calls, the band's xyz
        after CHECK_WAVES waves)."""
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        marks, last = [], {}
        user_cb = kw.pop("wave_callback", None)

        def cb(s, xyz, w):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            last["xyz"] = xyz
            if s + 1 == CHECK_WAVES:
                last["early"] = xyz.clone()
            if user_cb is not None:
                user_cb(s, xyz, w)
            if s + 1 == stop:
                raise _Killed

        reset_counts()
        img = None
        try:
            img = sharding.render_sharded(sc, dbvh, cam_, mesh, spp=spp, sampler="sobol",
                                          seed=0, cfg=cfg, wave_callback=cb, isect=isect, **kw)
        except _Killed:
            pass
        torch.cuda.synchronize()
        counts = launch_counts()
        waves = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        ms = float(np.median(waves)) if waves else float("nan")
        return img, last["xyz"], ms, counts, isect.n_calls, last.get("early")

    # 22.1 world size 1 at full width, kernel against plain: the plain
    # traversal takes ~2 s a wave on the card, so it runs the first
    # CHECK_WAVES waves of the same render and is held against the kernel's
    # film after as many
    img_k, _, ms_k, counts, calls, early_k = sharded("cuda_bvh4")
    launches = counts.get("bvh4_traverse", 0)
    check(launches == calls > 0 and set(counts) == {"bvh4_traverse"},
          f"22.1: launches {counts}, {calls} traversal calls")
    total += launches
    _, xyz_p, ms_p, _, _, _ = sharded("plain", stop=CHECK_WAVES)
    close, rel = film_agreement(early_k, xyz_p)
    check(close >= 0.995 and rel <= 1e-3,
          f"22.1: film XYZ agrees with the plain traversal's on {close:.5f} of pixels, mean "
          f"rel diff {rel:.3g}")
    mean = float(img_k.mean())
    check(bool(torch.isfinite(img_k).all()) and mean > 0, f"22.1: bad image, mean {mean}")
    print(f"phase 22.1: render_sharded, world size 1 ({cam.width}x{cam.height}, depth {DEPTH}, "
          f"Sobol {spp} spp, cuda_bvh4): {ms_k:.1f} ms a wave (median of {spp - 1} waves by "
          f"CUDA events; the plain traversal {ms_p:.1f}, median of {CHECK_WAVES - 1}), "
          f"{launches} launches = traversal calls; film XYZ after {CHECK_WAVES} waves vs the "
          f"plain traversal's: {close:.6f} of pixels, mean rel diff {rel:.3g}; image mean "
          f"{mean:.6f} {secs()}", flush=True)

    # 22.3 a render state saved after 8 of 16 waves, resumed
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "state")

        def save_after_8(s, xyz, w):
            if s == 7:
                multihost.save_render_state(ck, xyz, w, s + 1, mesh=mesh)

        sharded("cuda_bvh4", wave_callback=save_after_8, stop=8)
        total += launch_counts().get("bvh4_traverse", 0)
        xyz0, w0, nxt, _ = multihost.load_render_state(ck, mesh=mesh)
        nbytes = os.path.getsize(ck + ".proc0.npz")
        img_r, _, _, counts, _, _ = sharded("cuda_bvh4", film_state=(xyz0, w0),
                                            start_sample=nxt)
        total += counts.get("bvh4_traverse", 0)
    check(nxt == 8 and torch.equal(img_r, img_k),
          f"22.3: resumed at {nxt}, max |diff| {float((img_r - img_k).abs().max())}")
    print(f"phase 22.3: render state after 8 of {spp} waves ({nbytes} bytes, "
          f"{ck.rsplit(os.sep, 1)[-1]}.proc0.npz), resumed: image bit-equal to 22.1's {secs()}",
          flush=True)

    # 22.2 + 22.5: two ranks on this card (gloo)
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        outs = multihost.run_local(worker + [d] + ([str(dev)] if dev.type != "cuda" else []),
                                   2, timeout_s=600, cwd=repo)
        wall = time.perf_counter() - t1
        for r, (rc, out) in enumerate(outs):
            check(rc == 0, f"22.2: rank {r} failed:\n{out[-3000:]}")
        reps = [_last_json(out, "rank") for _, out in outs]
        res = torch.load(os.path.join(d, "dist.pt"))
    for r in reps:
        check(r["world_size"] == 2 and r["backend"] == "gloo"
              and r["render_launches"] == r["render_calls"] > 0
              and r["joint_launches"] == r["joint_calls"] > 0, f"22.2: rank report {r}")
        total += r["render_launches"] + r["joint_launches"]
    cam_d = bench_scene.bench_camera(DIST_RES)
    img_1, _, ms_1, counts, _, _ = sharded("cuda_bvh4", cam_=cam_d)
    total += counts.get("bvh4_traverse", 0)
    img_2 = res["image"].to(dev)
    bit = torch.equal(img_2, img_1)
    close, rel = film_agreement(img_2.reshape(-1, 3), img_1.reshape(-1, 3))
    check(close >= 0.995 and rel <= 1e-3,
          f"22.2: the gathered image agrees with world size 1's on {close:.5f} of pixels, "
          f"mean rel diff {rel:.3g}")
    print(f"phase 22.2: two processes on one card, gloo, {DIST_RES}x{DIST_RES} x {spp} spp: "
          f"{wall:.1f} s of wall time with each process's start-up (rank start-up "
          f"{[round(r['startup_s'], 1) for r in reps]} s, render "
          f"{[round(r['render_s'], 2) for r in reps]} s), bvh4_traverse launches "
          f"{[r['render_launches'] for r in reps]} = traversal calls; gathered image "
          f"{'bit-equal to' if bit else 'against'} world size 1's ({close:.6f} of pixels, mean "
          f"rel diff {rel:.3g}; world size 1 {ms_1:.1f} ms a wave) {secs()}", flush=True)

    # 22.5 against the single-process step (phase 18's rule)
    tcfg = treenet.TreeNetConfig()
    model = treenet.init_params(tcfg, seed=0, device=dev)
    clouds = torch.as_tensor(bench_scene.treenet_scene().next_batch(8), device=dev)
    loss, _ = treenet.loss_fn(model, tcfg, clouds)
    whole = torch.autograd.grad(loss, list(model.parameters()))
    tm = res["train"]["metrics"]
    err = max(max_rel_to_max(g.to(dev), 2 * w) for g, w in zip(res["train"]["grads"], whole))
    loss = float(loss.detach())
    check(abs(tm["loss"] - loss) <= 1e-4 * abs(loss),
          f"22.5: DP loss {tm['loss']} vs {loss}")
    check(err <= 1e-3, f"22.5: DP gradients differ from the single process's by {err:.3g}")
    # the joint step: the halves' losses averaged, their gradients summed
    model = treenet.init_params(tcfg, seed=0, device=dev)
    rcfg = integrator.IntegratorConfig(max_depth=DEPTH, mis=True, rr_depth=99)
    jscfg = samplers.make_sampler("sobol", seed=0, spp=16)
    tsc = scene_mod.to_device(sc, dev)
    lst = lightsamplers.build(tsc, rcfg.light_sampler, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    jclouds = torch.as_tensor(joint.scene_cloud(sc, tcfg.pc_size, batch=8), device=dev)
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
    mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)
    loss_fn = joint.make_joint_loss(tcfg, cam, jscfg, rcfg)
    params = list(model.parameters())
    halves = []
    for r in range(2):
        h = pix.shape[0] // 2
        lj, aux = loss_fn(joint.JointState(model, mc), tsc, None, lst, jclouds[4 * r:4 * r + 4],
                          pix[r * h:(r + 1) * h], 0, isect)
        halves.append((lj.item(), torch.autograd.grad(lj, params + [mc])))
    lj = sum(h[0] for h in halves) / 2
    gsum = [a + b for a, b in zip(halves[0][1], halves[1][1])]
    jmet = res["joint"]["metrics"]
    check(abs(jmet["loss"] - lj) <= 1e-4 * abs(lj), f"22.5: DP joint loss {jmet['loss']} vs {lj}")
    lr = 1e-3
    jerr = 0.0
    for p0, g, new in zip(params + [mc], gsum, res["joint"]["params"] + [res["joint"]["mat_coeffs"]]):
        step_ref = -lr * g
        slack = 4 * torch.finfo(torch.float32).eps * float(p0.detach().abs().max())
        e = (float(((new.to(dev) - p0.detach()) - step_ref).abs().max()) - slack) / max(
            float(step_ref.abs().max()), 1e-30)
        jerr = max(jerr, e)
    check(jerr <= 1e-3, f"22.5: DP joint step differs from the single process's by {jerr:.3g}")
    gn = math.sqrt(sum(float((g * g).sum()) for g in gsum[:-1]))
    print(f"phase 22.5: data-parallel steps on two ranks of one card (gloo): train step "
          f"(levels {tcfg.levels}, capacity {tcfg.capacity}, {tcfg.pc_size} prims, batch 8 as "
          f"4 + 4) {[round(r['train_s'], 3) for r in reps]} s, loss {tm['loss']:.7g} vs one "
          f"process {float(loss):.7g}, gradients (the ranks' sum, as JAX's step) within "
          f"{err:.3g} of twice the single process's; joint step (bench wave {cam.width}x"
          f"{cam.height} as two bands, depth {DEPTH}, RR off) {[round(r['joint_s'], 3) for r in reps]}"
          f" s, {[r['joint_launches'] for r in reps]} launches = traversal calls, loss "
          f"{jmet['loss']:.7g} vs {lj:.7g}, update within {jerr:.3g} of the halves' (phase 18's "
          f"rule), gnorm_tree {jmet['gnorm_tree']:.6g} vs {gn:.6g} {secs()}", flush=True)

    # 22.4 cli.render --sharded on the bench pbrt scene, two ranks
    with tempfile.TemporaryDirectory() as d:
        out2 = os.path.join(d, "two.pfm")
        t1 = time.perf_counter()
        outs = multihost.run_local(
            [sys.executable, "-m", "nn_bvh_tpu_torch.cli.render", bench_pbrt, "--sharded",
             "--res", f"{DIST_RES}x{DIST_RES}", "--spp", "4", "--outfile", out2, "--stats",
             *device_args], 2, timeout_s=600, cwd=repo)
        wall = time.perf_counter() - t1
        for r, (rc, out) in enumerate(outs):
            check(rc == 0, f"22.4: rank {r} failed:\n{out[-3000:]}")
        check(["wrote" in out for _, out in outs] == [True, False],
              "22.4: rank 0, and only rank 0, writes the image")
        stats = _last_json(outs[0][1], "render_s")
        got = image.read_pfm(out2)
    psc, pdbvh, pcam, pres = pbrt_parser.load_scene(bench_pbrt)
    pcam = pcam._replace(width=DIST_RES, height=DIST_RES)
    ccfg = integrator.IntegratorConfig(max_depth=pres.max_depth, mis=True, kind="path",
                                       rr_depth=2, sample_lights=True)
    reset_counts()
    want = sharding.render_sharded(psc, pdbvh, pcam, mesh, spp=4, sampler="sobol",
                                   cfg=ccfg).cpu().numpy()
    total += launch_counts().get("bvh4_traverse", 0)
    close, rel = film_agreement(torch.as_tensor(got).reshape(-1, 3),
                                torch.as_tensor(want).reshape(-1, 3))
    check(close >= 0.995 and rel <= 1e-3 and np.isfinite(got).all() and got.mean() > 0,
          f"22.4: the CLI's image against world size 1's: {close:.5f} of pixels, {rel:.3g}")
    print(f"phase 22.4: cli.render --sharded on the bench .pbrt, two ranks, {DIST_RES}x"
          f"{DIST_RES} x 4 spp: {wall:.1f} s of wall time; rank 0's stats {json.dumps(stats)}; "
          f"its PFM {'bit-equal to' if np.array_equal(got, want) else 'against'} "
          f"render_sharded at world size 1 ({close:.6f} of pixels, mean rel diff {rel:.3g}) "
          f"{secs()}", flush=True)

    # 22.6 the kd-tree on the bench geometry against bvh4_traverse
    tri = scene_mod.host(sc.tri_p)[:sc.n_tris]
    t1 = time.perf_counter()
    kt = kdtree.build_kdtree(*build.triangle_bounds(tri))
    build_s = time.perf_counter() - t1
    o, dd, t_max = batches["incoherent"]
    tp = torch.as_tensor(tri, device=dev)
    k_isect = dispatch.make_intersectors(sc, dbvh, dev, backend="cuda_bvh4")
    kern = lambda any_hit: k_isect.fn(*k_isect.tables, o, dd, t_max, any_hit)
    st_c, st_a = {}, {}
    kdtree.intersect_closest(kt, tp, o, dd, t_max)  # warm-up
    ms_c, hk = event_ms(torch, lambda: kdtree.intersect_closest(kt, tp, o, dd, t_max, stats=st_c))
    ms_a, occ_k = event_ms(torch, lambda: kdtree.intersect_any(kt, tp, o, dd, t_max, stats=st_a))
    hb, occ_b = kern(False), kern(True)
    ms_b = bench_scene.device_ms(lambda: kern(False))
    ms_ba = bench_scene.device_ms(lambda: kern(True))
    reset_counts()  # bvh4_traverse ran here only as the kd-tree's reference
    M, scan = len(kt.prim_idx), kdtree.scan_width(kt)
    unscanned = set()
    for leaf in kdtree.clamped_leaves(kt):
        first, count = int(kt.node_data[leaf, 2]), int(kt.node_data[leaf, 3])
        unscanned |= (set(kt.prim_idx[first:first + count].tolist())
                      - set(kt.prim_idx[M - scan:M - scan + count].tolist()))
    live = t_max > 0
    diff = live & (hk.prim != hb.prim)
    tie = diff & (hk.prim >= 0) & (hb.prim >= 0) & (hk.t == hb.t)
    clamp = diff & ~tie & torch.isin(hb.prim, torch.as_tensor(sorted(unscanned) or [-2],
                                                               device=dev, dtype=hb.prim.dtype))
    same = live & (hk.prim == hb.prim) & (hb.prim >= 0)
    check(int((diff & ~tie & ~clamp).sum()) == 0,
          f"22.6: closest prim differs on {int((diff & ~tie & ~clamp).sum())} lanes")
    check(torch.equal(hk.t[same], hb.t[same]), "22.6: t differs on lanes of equal prim")
    check(bool((hk.prim[~live] == -1).all()), "22.6: a dead lane hit")
    odiff = live & (occ_k != occ_b)
    ocl = int((odiff & clamp).sum())
    check(int(odiff.sum()) == ocl, f"22.6: occlusion differs on {int(odiff.sum())} live lanes")
    print(f"phase 22.6: kd-tree on the bench geometry ({sc.n_tris} triangles): host build "
          f"{build_s:.2f} s, {kt.n_nodes} nodes, max_leaf {kt.max_leaf} (scan {scan}), "
          f"{len(kdtree.clamped_leaves(kt))} clamped leaves; on phase 3's incoherent batch "
          f"({o.shape[0]} rays, {int(live.sum())} live): closest {ms_c:.2f} ms, {st_c['steps']} "
          f"lockstep steps, {st_c['lane_steps']} lane-steps; any-hit {ms_a:.2f} ms, "
          f"{st_a['steps']} steps (CUDA events, one call each); bvh4_traverse {ms_b:.4f} / "
          f"{ms_ba:.4f} ms (device_ms); prims equal to bvh4_traverse's but {int(tie.sum())} "
          f"tie lanes and {int(clamp.sum())} lanes of the mirrored clamped scan, t bit-equal "
          f"on equal prims, occlusion equal on live lanes but {ocl} clamp lanes {secs()}",
          flush=True)

    # 22.7 crown_grad's check on the bench .pbrt; host-only, crown_gate on the committed EXRs
    reset_counts()
    t1 = time.perf_counter()
    g = crown_grad.grad_check(bench_pbrt, res=64, device=dev, mat_id=0, rr_depth=99)
    counts = launch_counts()
    check(g["value"] < crown_grad.GATE and max(abs(x) for x in g["grad_fd"]) > 0
          and counts.get("bvh4_traverse", 0) > 0
          and set(counts) == {"bvh4_traverse", "material_grad"},
          f"22.7: crown_grad {g}, launches {counts}")
    total += counts["bvh4_traverse"]
    g_rr = crown_grad.grad_check(bench_pbrt, res=64, device=dev, mat_id=0)  # printed, not held
    buf = io.StringIO()
    ours = os.path.join(repo, "data", "golden", "crown-ours-volpath-250x350-64spp.exr")
    with contextlib.redirect_stdout(buf):
        rc = crown_gate.main(["--use-existing", "--no-copy", "--ours", ours])
    check(rc == 0 and "GATE: PASS" in buf.getvalue(), f"22.7: crown_gate {buf.getvalue()}")
    print(f"phase 22.7: crown_grad.grad_check on the bench .pbrt at 64x64 (paint, material 0, "
          f"Russian roulette off as phase 14): {json.dumps(g)} [{time.perf_counter() - t1:.1f} "
          f"s], {counts['bvh4_traverse']} launches; with the integrator's roulette (central "
          f"differences across its jumps; printed, not held) {g_rr['value']:.4g}; host-only "
          f"(numpy, no render of the port): crown_gate --use-existing on the committed EXRs: "
          f"{' | '.join(buf.getvalue().strip().splitlines())}", flush=True)
    print(f"phase 22: done in {time.perf_counter() - t0:.0f} s, {total} bvh4_traverse launches",
          flush=True)
    return total


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        return dist_worker(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nn_bvh_tpu_torch import kernels
    from nn_bvh_tpu_torch.tools import bench_scene


    dev = torch.device("cuda", 0)
    t_run = [time.perf_counter()] * 2  # the run's start, the last lap's end

    def lap(label):
        now = time.perf_counter()
        print(f"{label}: {now - t_run[1]:.1f} s, {now - t_run[0]:.1f} s into the run",
              flush=True)
        t_run[1] = now

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    sources = ("bvh4_traverse", "binary_traverse", "bvh8_traverse", "kernel_lab", "material_grad")
    t0 = time.perf_counter()
    kernels.build(*sources)
    for name in sources:
        kernels.load(name)
    print(f"phase 2: built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        log = kernels.ptxas_log(name)
        for line in kernels.ptxas_lines(log):
            print(f"phase 2: {name}: {line}")
        check(kernels.spill_bytes(log) == 0, f"{name} spills: {kernels.ptxas_lines(log)}")
    mg_row = phase_material_grad(torch, dev)
    lap("phases 1-2")

    t0 = time.perf_counter()
    sc, dbvh, cam = bench_scene.build_bench_scene()
    print(f"phase 3: bench scene {sc.n_tris} triangles, {sc.n_lights} lights, "
          f"{dbvh.n_nodes} binary nodes, built in {time.perf_counter() - t0:.2f} s")
    check(sc.n_tris == 52996, f"bench scene has {sc.n_tris} triangles, expected 52996")
    batches = bench_scene.probe_batches(sc, cam, dev)
    R = cam.width * cam.height

    rows = {}
    for name, backend, plain, source, replaces in KERNELS:
        phase = 3 if backend == "cuda_bvh4" else 6
        times, max_err, p_isect = phase_kernel_vs_plain(torch, sc, dbvh, batches, dev,
                                                        backend, plain, phase)
        rows[name] = dict(times=times, max_err=max_err, p_isect=p_isect)
        if backend == "cuda_bvh4":
            rows[name]["launches"] = phase_main_path(torch, sc, dbvh, cam, dev)
            ref_film = phase_same_seed(torch, sc, dbvh, cam, dev)
    phase_deep_tree(torch, dev, R)
    lap("phases 3-7")

    for name, backend, *_ in KERNELS[1:]:
        xyz, counts, calls, sec = one_wave(torch, sc, dbvh, cam, dev, backend)
        launches = counts.get(name, 0)
        check(launches == calls and 0 < calls <= 2 * DEPTH + 1,
              f"{backend}: {launches} kernel launches for {calls} traversal calls")
        check(sum(counts.values()) == launches, f"{backend}: other kernels launched: {counts}")
        close, rel = film_agreement(xyz, ref_film)
        check(close >= 0.995 and rel <= 1e-3,
              f"{backend}: film agrees with cuda_bvh4 on {close:.5f} of pixels, "
              f"mean rel diff {rel:.3g}")
        rows[name]["launches"] = launches
        print(f"phase 8: {backend} wave {sec:.3f} s, {launches} kernel launches = {calls} "
              f"traversal calls, film vs cuda_bvh4: {close:.6f} of pixels, mean rel "
              f"diff {rel:.3g}")

    lap("phase 8")
    out = []
    o, d, t_max = batches["incoherent"]
    for name, backend, plain, source, replaces in KERNELS:
        row = rows[name]
        bound, by, work = bound_ms(torch, row["p_isect"], o, d, t_max)
        rep = row["times"][("incoherent", "closest")]
        print(f"phase 9: {name}: incoherent closest {rep['kernel']:.4f} ms device, "
              f"bound {bound:.4f} ms ({by}; {work})")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": row["launches"], "max_abs_err": row["max_err"],
                    "ms": rep["kernel"], "plain_ms": rep["plain"], "bound_ms": bound,
                    "bound_by": by, "library_ms": None})
    lab_launches = phase_lab_main_path(torch)
    lap("phases 9-10")
    lab_rows = phase_lab_variants(torch, sc, dbvh, cam, dev)
    lap("phases 11-12")
    for name, replaces in LAB_REPLACES.items():
        out.append({"name": name, "route": "cuda", "source": LAB_SOURCE, "replaces": replaces,
                    "launches": lab_launches[name], **lab_rows[name], "library_ms": None})
    phase_wave_batches(torch, sc, dbvh, cam, dev)
    lap("phase 13")
    phase_gradients(torch, sc, dbvh, cam, dev)
    lap("phase 14")
    phase_volpath(torch, sc, dbvh, cam, dev)
    lap("phase 15")
    phase_materials(torch, dev)
    lap("phase 16")
    out[0]["launches"] += phase_lights(torch, dev)
    lap("phase 17")
    launches, mg_row["launches"] = phase_learner(torch, sc, dbvh, cam, dev, ref_film)
    out[0]["launches"] += launches
    lap("phase 18")
    with tempfile.TemporaryDirectory() as d:
        launches, paths = phase_scene_input(torch, dev, d)
        out[0]["launches"] += launches
        lap("phase 19")
        out[0]["launches"] += phase_integrators(torch, sc, dbvh, cam, dev, ref_film,
                                                paths["bench"])
        lap("phase 20")
        out[0]["launches"] += phase_film_cameras(torch, sc, dbvh, cam, dev, ref_film,
                                                 paths["bench"])
        lap("phase 21")
        out[0]["launches"] += phase_dist(torch, sc, dbvh, cam, dev, batches, paths["bench"])
        lap("phase 22")
    out.append(mg_row)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
