"""Stateless per-ray samplers (port of nn_bvh_tpu/core/samplers.py).

    u = get_1d(cfg, pixel_index, sample_index, dim)
    (u, v) = get_2d(cfg, pixel_index, sample_index, dim)

pixel/sample are int tensors on the device the samples should land on;
dim is a Python int. Results are bit-identical to the JAX package.

Kinds: independent, stratified, sobol (padded Sobol', also "paddedsobol"),
halton, zsobol, fullsobol (one global Sobol' sequence over generated
matrices) and pmj02bn (generated pmj02 sets). The tables of the last two
(`sobol_v`, `pmj`) ride in the config as tensors, made on the CPU;
`to_device` moves them to the device that draws, and a draw on another
device raises. The TABLE kind reads u-values from a (lanes, D) table
(`table[sample, clip(dim)]`): MLT's primary-sample-space chains drive the
Path wave through it (wavefront/mlt.py), handing each lane's chain index
in as its sample index. As in the JAX package it has no name in
`make_sampler`; mlt builds its SamplerConfig directly.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import rng, lowdiscrepancy as ld

INDEPENDENT = 0
STRATIFIED = 1
SOBOL = 2
HALTON = 3
ZSOBOL = 4
TABLE = 5         # MLT's u-vector kind (no name: wavefront/mlt.py builds it)
SOBOL_GLOBAL = 6
PMJ02 = 7

KINDS = {"independent": INDEPENDENT, "stratified": STRATIFIED, "sobol": SOBOL,
         "paddedsobol": SOBOL, "zsobol": ZSOBOL, "pmj02bn": PMJ02,
         "fullsobol": SOBOL_GLOBAL, "halton": HALTON}
_INV_2_32 = 1.0 / 4294967296.0


class SamplerConfig(NamedTuple):
    kind: int
    seed: int
    spp: int
    width: int = 0                    # image width: ZSobol's 2-D pixel coordinates
    sobol_v: torch.Tensor | None = None  # (64, 32) uint32 in int64 (SOBOL_GLOBAL)
    pmj: torch.Tensor | None = None      # (N, 2) float32 pmj02 set (PMJ02)
    table: torch.Tensor | None = None    # (lanes, D) float32 u-values (TABLE); the
    #   sample index of a draw is the row


@functools.lru_cache(maxsize=2)
def _sobol_matrices_cached(n_dims: int = 64):
    return ld.generate_sobol_matrices(n_dims)


@functools.lru_cache(maxsize=4)
def _pmj02_cached(n: int, seed: int = 0):
    return ld.generate_pmj02(n, seed)


def make_sampler(kind: str = "sobol", seed: int = 0, spp: int = 16,
                 width: int = 0) -> SamplerConfig:
    """The sampler `kind` (a KINDS name); its tables on the CPU (`to_device`
    moves them)."""
    if kind not in KINDS:
        # the JAX package's make_sampler names no other kind either: MLT's
        # TABLE kind is a SamplerConfig that wavefront/mlt.py builds
        raise ValueError(f"sampler {kind!r} has no name in make_sampler (its kinds: "
                         f"{', '.join(KINDS)}); MLT's TABLE kind is built by "
                         "wavefront/mlt.py")
    k = KINDS[kind]
    sobol_v = pmj = None
    if k == SOBOL_GLOBAL:
        sobol_v = torch.as_tensor(_sobol_matrices_cached().astype("int64"))
    elif k == PMJ02:
        n = 1 << max(2, int(spp - 1).bit_length())
        pmj = torch.as_tensor(_pmj02_cached(max(n, 4), seed=0))
    return SamplerConfig(k, seed, spp, width, sobol_v=sobol_v, pmj=pmj)


def to_device(cfg: SamplerConfig, device) -> SamplerConfig:
    """The config with its tables on `device`."""
    mv = lambda t: None if t is None else t.to(device)
    return cfg._replace(sobol_v=mv(cfg.sobol_v), pmj=mv(cfg.pmj), table=mv(cfg.table))


def _pixel_xy(cfg: SamplerConfig, pixel: torch.Tensor):
    p = rng.u32(pixel)
    if cfg.width > 0:
        return p % cfg.width, p // cfg.width
    return p, torch.zeros_like(p)


def _log2_ceil(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 (rounded to nearest) times 2**-32, unclamped."""
    return bits.to(torch.float32) * _INV_2_32


def _scramble(bits, seed):
    return ld.reverse_bits32(ld.fast_owen_scramble(ld.reverse_bits32(bits), seed))


def _pmj_bits(cfg: SamplerConfig, sample: torch.Tensor, axis) -> torch.Tensor:
    idx = rng.u32(sample) % cfg.pmj.shape[0]
    return (cfg.pmj[idx, axis] * 4294967296.0).to(torch.int64)


def get_1d(cfg: SamplerConfig, pixel: torch.Tensor, sample: torch.Tensor,
           dim: int) -> torch.Tensor:
    """One sample dimension in [0,1) as float32."""
    if cfg.kind == TABLE:
        return cfg.table[sample.long(), min(max(int(dim), 0), cfg.table.shape[1] - 1)]
    if cfg.kind == INDEPENDENT:
        return rng.hash_float(pixel, sample, dim, cfg.seed)
    if cfg.kind == STRATIFIED:
        u = rng.hash_float(pixel, sample, dim, cfg.seed)
        return (sample.to(torch.float32) + u) / cfg.spp
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), log_n, pad_seed)
        x, _ = ld.owen_scrambled_sobol_2d(idx, pad_seed ^ 0x55555555, pad_seed,
                                          n_bits=log_n)
        return x
    if cfg.kind == HALTON:
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), _log2_ceil(cfg.spp), pad_seed)
        return ld.radical_inverse(0, idx + (pad_seed >> 16))
    if cfg.kind == ZSOBOL:
        px, py = _pixel_xy(cfg, pixel)
        idx = ld.zsobol_shuffled_index(px, py, sample, _log2_ceil(cfg.spp), dim, cfg.seed)
        x, _ = ld.owen_scrambled_sobol_2d(idx, rng.hash_combine(dim, cfg.seed),
                                          rng.hash_combine(dim, cfg.seed ^ 0x9E377))
        return x
    if cfg.kind == SOBOL_GLOBAL:
        d = int(dim) % cfg.sobol_v.shape[0]
        v = ld.sobol_sample_dim(cfg.sobol_v[d], sample)
        return _to_float(_scramble(v, rng.hash_combine(pixel, d, cfg.seed)))
    if cfg.kind == PMJ02:
        bits = _pmj_bits(cfg, sample, int(dim) % 2)
        return _to_float(_scramble(bits, rng.hash_combine(pixel, dim, cfg.seed)))
    raise ValueError(f"sampler kind {cfg.kind} is unknown")


def get_2d(cfg: SamplerConfig, pixel: torch.Tensor, sample: torch.Tensor,
           dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A 2D sample in [0,1)^2; consumes dims (dim, dim+1)."""
    if cfg.kind == TABLE:
        d = min(max(int(dim), 0), cfg.table.shape[1] - 2)
        row = sample.long()
        return cfg.table[row, d], cfg.table[row, d + 1]
    if cfg.kind == INDEPENDENT:
        return (rng.hash_float(pixel, sample, dim, cfg.seed),
                rng.hash_float(pixel, sample, dim + 1, cfg.seed))
    if cfg.kind == STRATIFIED:
        # jittered n x n grid over the sample index, strata order per pixel/dim
        n = int(math.ceil(math.sqrt(cfg.spp)))
        perm = rng.hash_combine(pixel, dim, cfg.seed)
        s = ((rng.u32(sample) + perm) & rng.M32) % (n * n)
        jx = rng.hash_float(pixel, sample, dim, cfg.seed)
        jy = rng.hash_float(pixel, sample, dim + 1, cfg.seed)
        return ((s % n).to(torch.float32) + jx) / n, ((s // n).to(torch.float32) + jy) / n
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), log_n, pad_seed)
        return ld.owen_scrambled_sobol_2d(idx, pad_seed ^ 0x55555555,
                                          rng.mix_bits(pad_seed), n_bits=log_n)
    if cfg.kind == HALTON:
        pad_seed = rng.hash_combine(pixel, dim, cfg.seed)
        idx = ld.owen_shuffle_index(rng.u32(sample), _log2_ceil(cfg.spp), pad_seed)
        a = idx + (pad_seed >> 16)
        return ld.radical_inverse(0, a), ld.radical_inverse(1, a)
    if cfg.kind == ZSOBOL:
        px, py = _pixel_xy(cfg, pixel)
        idx = ld.zsobol_shuffled_index(px, py, sample, _log2_ceil(cfg.spp), dim, cfg.seed)
        return ld.owen_scrambled_sobol_2d(idx, rng.hash_combine(dim, cfg.seed),
                                          rng.hash_combine(dim, cfg.seed ^ 0x9E377))
    if cfg.kind == SOBOL_GLOBAL:
        v_all = cfg.sobol_v
        n_dims = v_all.shape[0]
        d = int(dim) % n_dims
        vx = ld.sobol_sample_dim(v_all[d], sample)
        vy = ld.sobol_sample_dim(v_all[(d + 1) % n_dims], sample)
        return (_to_float(_scramble(vx, rng.hash_combine(pixel, d, cfg.seed))),
                _to_float(_scramble(vy, rng.hash_combine(pixel, d + 1, cfg.seed))))
    if cfg.kind == PMJ02:
        ux, uy = _pmj_bits(cfg, sample, 0), _pmj_bits(cfg, sample, 1)
        return (_to_float(_scramble(ux, rng.hash_combine(pixel, dim, cfg.seed))),
                _to_float(_scramble(uy, rng.hash_combine(pixel, dim, cfg.seed ^ 0x71F3))))
    raise ValueError(f"sampler kind {cfg.kind} is unknown")
