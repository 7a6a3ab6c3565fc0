"""Counter-based, stateless random numbers (port of nn_bvh_tpu/core/rng.py).

Every random number on the render path is a pure hash of (pixel, sample,
dimension, seed) counters, exactly as in the JAX package, so both packages
draw the same bits and no `torch.Generator` is involved.

uint32 arithmetic is emulated in int64: every value stays in [0, 2**32),
each multiply and add is masked with 0xFFFFFFFF, and only masked,
non-negative values are shifted (so right shifts are logical). Multiplies by
a constant of 2**31 or more are split in two 16-bit halves so that no int64
product overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ONE_OVER_2_32 = 2.3283064365386963e-10  # 0x1p-32


def u32(v, device=None) -> torch.Tensor:
    """Any int tensor or Python int -> int64 tensor holding uint32 values
    (negative int32 values wrap modulo 2**32, as a uint32 cast does)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return torch.tensor(int(v) & M32, dtype=torch.int64, device=device)


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2**32 for uint32-valued int64 `a` and a constant or
    uint32-valued tensor `c`."""
    if isinstance(c, int) and c < (1 << 31):
        return (a * c) & M32
    lo = c & 0xFFFF
    hi = c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def mix_bits(v: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (murmur3 fmix32 strengthened), rng.py:mix_bits."""
    v = v ^ (v >> 16)
    v = mul32(v, 0x7FEB352D)
    v = v ^ (v >> 15)
    v = mul32(v, 0x846CA68B)
    v = v ^ (v >> 16)
    return v


def hash_combine(*vals) -> torch.Tensor:
    """Combine integer streams into one well-mixed uint32 (int64 tensor)."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    h = u32(0x9E3779B9, dev)
    for v in vals:
        v = u32(v, dev)
        s = (v + 0x9E3779B9 + ((h << 6) & M32) + (h >> 2)) & M32
        h = mix_bits(h ^ s)
    return h


def uint32_to_float01(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> [0,1) float32. int64 -> float32 rounds to nearest like the
    uint32 -> float32 conversion of the JAX package."""
    return torch.clamp(u.to(torch.float32) * _ONE_OVER_2_32,
                       max=1.0 - 2.0 ** -24)


def hash_float(*vals) -> torch.Tensor:
    return uint32_to_float01(hash_combine(*vals))
