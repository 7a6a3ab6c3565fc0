"""nn_bvh_tpu_torch: the PyTorch + CUDA port of nn_bvh_tpu.

The JAX package `nn_bvh_tpu` is the reference; this package mirrors its
layout (core/, geometry/, accel/, scatter/, wavefront/) and its function
names, so each function has a counterpart of the same name there.

Conventions of the port:

- It imports torch and numpy, never jax and never `nn_bvh_tpu` (every route
  into that package loads JAX). The numpy host code the slice needs (scene
  builder, SAH builder, BVH4 collapse) is carried over as numpy.
- Entry points run on the CUDA card unless the caller asks for the CPU,
  with `device="cpu"` or with tensors that already sit there
  (`devices.resolve_device`). Nothing falls back to the CPU when CUDA is
  missing: they raise.
- Dtypes are explicit: every tensor the port makes is float32, int32 or
  int64 on purpose (host numpy arrays are float64 by default and
  `torch.from_numpy` keeps that). The learner's entry points (its CLIs)
  turn TF32 off for their process (`devices.full_float32`); the library's
  functions leave the setting alone.
- Randomness is the counter hash of `core/rng.py`; no `torch.Generator`
  sits on the render path. The learner's initial weights come from a
  `torch.Generator` seeded from `--seed`; no global RNG is used.
- Hand-written CUDA kernels live in `csrc/` and are built at first use by
  `kernels.load` into `build/kernels/` at the repository root; the native
  BVH builder is built by g++ into `build/native/`.

What is ported is everything the JAX package renders with: every
integrator (Path, SimplePath, RandomWalk, AO, VolPath with the phased
wave, LightPath, BDPT, SPPM, MLT) over every material, light, light
sampler and sampler kind, quadrics, motion blur, textures and media; every
camera (perspective, orthographic, spherical, realistic) and the film
surface (white-balanced and measured sensors, the spectral film, the
G-buffer); every traversal backend of the JAX package (BVH4, binary,
deep-stack binary, BVH8) as a CUDA kernel, and the SAH kd-tree aggregate
(`accel/kdtree.py`, a plain torch walk); gradients of shading with
respect to material and light parameters by autograd; the treeNet split
learner with the joint render+train step (`learn/`; randomness there
comes from a torch.Generator seeded by the caller); scene input (the pbrt
parser with PLY, Loop subdivision and curves, the native SAH builder in
`native/`); the CLIs (`cli/`: render, train, tree_bench, imgtool, pspec,
format), `utils/` (image I/O, noise, stats, the tev display client) and
the tools (`tools/`, the reference-bound crown and probe tools among
them); and `dist/` on torch.distributed: the pixel-band sharded render,
render-state checkpoints and data-parallel train and joint steps, under
`cli.render --sharded` and `cli.train --dp`. The JAX package's
`utils/cache.py` and `utils/pytree.py` configure JAX (its compile cache,
its pytree registration) and have no counterpart.
"""
