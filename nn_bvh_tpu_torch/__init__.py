"""nn_bvh_tpu_torch: the PyTorch + CUDA port of nn_bvh_tpu.

The JAX package `nn_bvh_tpu` is the reference; this package mirrors its
layout (core/, geometry/, accel/, scatter/, wavefront/) and its function
names, so each function has a counterpart of the same name there.

Conventions of the port:

- It imports torch and numpy, never jax and never `nn_bvh_tpu` (every route
  into that package loads JAX). The numpy host code the slice needs (scene
  builder, SAH builder, BVH4 collapse) is carried over as numpy.
- Devices are explicit: every public entry takes a `device` or tensors that
  already sit on one. Nothing falls back to the CPU when CUDA is missing.
- Dtypes are explicit: every tensor the port makes is float32, int32 or
  int64 on purpose (host numpy arrays are float64 by default and
  `torch.from_numpy` keeps that).
- Randomness is the counter hash of `core/rng.py`; no `torch.Generator`
  sits on the render path.
- Hand-written CUDA kernels live in `csrc/` and are built at first use by
  `kernels.load` into `build/kernels/` at the repository root.

What this slice covers is the bench path: the Path integrator (MIS + RR)
over diffuse/conductor materials and area lights, with the BVH4 traversal
as a CUDA kernel. Anything else raises NotImplementedError naming the
ROADMAP item that ports it.
"""
