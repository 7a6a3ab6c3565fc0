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

What is ported is the bench path: the Path integrator (MIS + RR) over
every material of the JAX package (with its subsurface stage) and area
lights, with every traversal backend
of the JAX package (BVH4, binary, deep-stack binary, BVH8) as a CUDA kernel,
VolPath over homogeneous and grid media (`wavefront/volpath.py`, with the
phased wave), gradients of shading with respect to material and light
parameters by autograd, the traversal profiler (`tools/trav_prof.py`),
the treeNet split learner with the joint render+train step (`learn/`,
its CLIs `cli/train.py` and `cli/tree_bench.py`; randomness there comes
from a torch.Generator seeded by the caller), textures (`geometry/
texture.py`), and scene input: the pbrt parser with PLY, Loop subdivision
and curves, the native SAH builder (`native/`), image I/O (`utils/`) and
the render CLI (`cli/render.py`). Anything else raises
NotImplementedError naming the ROADMAP item that ports it.
"""
