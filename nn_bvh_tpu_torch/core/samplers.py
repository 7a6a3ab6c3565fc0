"""Stateless per-ray samplers (port of nn_bvh_tpu/core/samplers.py:102-185,
SOBOL and INDEPENDENT kinds).

    u = get_1d(cfg, pixel_index, sample_index, dim)
    (u, v) = get_2d(cfg, pixel_index, sample_index, dim)

pixel/sample are int tensors on the device the samples should land on;
dim is a Python int. Results are bit-identical to the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng, lowdiscrepancy as ld

INDEPENDENT = 0
STRATIFIED = 1
SOBOL = 2


class SamplerConfig(NamedTuple):
    kind: int
    seed: int
    spp: int
    width: int = 0


def make_sampler(kind: str = "sobol", seed: int = 0, spp: int = 16,
                 width: int = 0) -> SamplerConfig:
    kinds = {"independent": INDEPENDENT, "sobol": SOBOL, "paddedsobol": SOBOL}
    if kind not in kinds:
        raise NotImplementedError(
            f"sampler {kind!r} is not ported yet (ROADMAP queue 1, item 2)")
    return SamplerConfig(kinds[kind], seed, spp, width)


def _log2_ceil(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def get_1d(cfg: SamplerConfig, pixel: torch.Tensor, sample: torch.Tensor,
           dim: int) -> torch.Tensor:
    """One sample dimension in [0,1) as float32."""
    if cfg.kind == INDEPENDENT:
        return rng.hash_float(pixel, sample, dim, cfg.seed)
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), log_n, pad_seed)
        x, _ = ld.owen_scrambled_sobol_2d(idx, pad_seed ^ 0x55555555, pad_seed,
                                          n_bits=log_n)
        return x
    raise NotImplementedError(f"sampler kind {cfg.kind} is not ported yet")


def get_2d(cfg: SamplerConfig, pixel: torch.Tensor, sample: torch.Tensor,
           dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A 2D sample in [0,1)^2; consumes dims (dim, dim+1)."""
    if cfg.kind == INDEPENDENT:
        return (rng.hash_float(pixel, sample, dim, cfg.seed),
                rng.hash_float(pixel, sample, dim + 1, cfg.seed))
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), log_n, pad_seed)
        return ld.owen_scrambled_sobol_2d(idx, pad_seed ^ 0x55555555,
                                          rng.mix_bits(pad_seed), n_bits=log_n)
    raise NotImplementedError(f"sampler kind {cfg.kind} is not ported yet")
