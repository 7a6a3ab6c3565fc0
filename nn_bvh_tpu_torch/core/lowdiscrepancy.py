"""Base-2 Sobol' dims (0, 1) + Owen scrambling (port of the Sobol path of
nn_bvh_tpu/core/lowdiscrepancy.py:23-96).

uint32 values ride in int64 tensors (see core/rng.py). The other sequences
of the JAX module (ZSobol, Halton, global Sobol', pmj02) are not in this
slice: ROADMAP queue 1 lists them.
"""

from __future__ import annotations

import torch

from . import rng
from .rng import M32, mul32


def _sobol_direction_numbers() -> list[tuple[int, int]]:
    """32 (dim0, dim1) direction numbers: van der Corput and the primitive
    polynomial x+1 (m_k = m_{k-1} ^ 2 m_{k-1})."""
    v = []
    m = 1
    for k in range(32):
        v.append((1 << (31 - k), (m << (31 - k)) & M32))
        m = m ^ (2 * m)
    return v


_SOBOL_V = _sobol_direction_numbers()


def sobol_2d_bits(index: torch.Tensor, n_bits: int = 32):
    """Sobol' sample `index` for dims (0, 1) as uint32 bit patterns.
    `n_bits` bounds the loop when index < 2**n_bits is known (the skipped
    bits are zero, so the result is the same)."""
    x = torch.zeros_like(index)
    y = torch.zeros_like(index)
    for k in range(n_bits):
        bit = (index >> k) & 1
        vx, vy = _SOBOL_V[k]
        x = x ^ (bit * vx)
        y = y ^ (bit * vy)
    return x, y


def reverse_bits32(v: torch.Tensor) -> torch.Tensor:
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return (v >> 16) | ((v << 16) & M32)


def fast_owen_scramble(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras hash-based Owen scramble on bit-reversed uint32s."""
    v = v ^ mul32(v, 0x3D20ADEA)
    v = (v + seed) & M32
    v = (v * ((seed >> 16) | 1)) & M32  # factor < 2**16: no int64 overflow
    v = v ^ mul32(v, 0x05526C56)
    v = v ^ mul32(v, 0x53A22864)
    return v


def owen_scrambled_sobol_2d(index: torch.Tensor, seed_x: torch.Tensor,
                            seed_y: torch.Tensor, n_bits: int = 32):
    """Owen-scrambled Sobol' dims (0,1) -> two float32 tensors in [0,1)."""
    xb, yb = sobol_2d_bits(index, n_bits)
    xb = reverse_bits32(fast_owen_scramble(reverse_bits32(xb), seed_x))
    yb = reverse_bits32(fast_owen_scramble(reverse_bits32(yb), seed_y))
    return rng.uint32_to_float01(xb), rng.uint32_to_float01(yb)


def owen_shuffle_index(index: torch.Tensor, n_pow2_log: int,
                       seed: torch.Tensor) -> torch.Tensor:
    """Owen-shuffle a sample index within a 2**n block (index padding)."""
    shifted = (index << (32 - n_pow2_log)) & M32
    return fast_owen_scramble(shifted, seed) >> (32 - n_pow2_log)
