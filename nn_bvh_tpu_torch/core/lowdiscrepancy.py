"""Low-discrepancy sequences (port of nn_bvh_tpu/core/lowdiscrepancy.py):
base-2 Sobol' dims (0, 1) with Owen scrambling and index shuffling, ZSobol's
Morton-order base-4 digit permutation, Halton's radical inverse, and the
generated global Sobol' matrices and pmj02 point sets (host numpy, as in
the JAX package).

uint32 values ride in int64 tensors (see core/rng.py).
"""

from __future__ import annotations

import functools
from itertools import permutations

import numpy as np
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


# ---------------------------------------------------------------------------
# ZSobol sample-index scrambling (Morton order, base-4 digit permutations)
# ---------------------------------------------------------------------------

def encode_morton2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Interleave the low 16 bits of x and y."""
    def part(v):
        v = v & 0xFFFF
        v = (v ^ (v << 8)) & 0x00FF00FF
        v = (v ^ (v << 4)) & 0x0F0F0F0F
        v = (v ^ (v << 2)) & 0x33333333
        v = (v ^ (v << 1)) & 0x55555555
        return v

    return (part(y) << 1) | part(x)


def _pack_perms4() -> list:
    """The 24 permutations of 4 elements, perm[i] in bits 2i..2i+1."""
    return [sum(pi << (2 * i) for i, pi in enumerate(p)) for p in permutations(range(4))]


_PERMS4 = _pack_perms4()


@functools.lru_cache(maxsize=8)
def _perms4_on(device: torch.device) -> torch.Tensor:
    return torch.tensor(_PERMS4, dtype=torch.int64, device=device)


def zsobol_shuffled_index(pixel_x: torch.Tensor, pixel_y: torch.Tensor,
                          sample: torch.Tensor, log2_spp: int, dim: int,
                          seed: int) -> torch.Tensor:
    """ZSobolSampler::GetSampleIndex in uint32: the Morton index of the
    pixel with the sample bits appended, its base-4 digits permuted top-down
    by a permutation hashed from (prefix, dim, seed)."""
    log2_spp = int(log2_spp)
    n_base4 = (2 * 13 + log2_spp + 1) // 2
    morton = ((encode_morton2(pixel_x, pixel_y) << log2_spp) & M32) | rng.u32(sample)
    perms = _perms4_on(morton.device)
    out = torch.zeros_like(morton)
    for i in range(n_base4):
        shift = 2 * (n_base4 - 1 - i)
        digit = (morton >> shift) & 3
        prefix = morton >> (shift + 2)
        p = rng.hash_combine(prefix, dim, seed) % 24
        newd = (perms[p] >> (2 * digit)) & 3
        out = ((out << 2) & M32) | newd
    return out


# ---------------------------------------------------------------------------
# Halton radical inverse (first primes)
# ---------------------------------------------------------------------------

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


@functools.lru_cache(maxsize=None)
def _radical_constants(base_index: int):
    """(base, n_digits, modulus, inv): inv is inv_base multiplied into 1.0
    n_digits times in float32, the JAX loop's carry (the same for every
    lane)."""
    base = _PRIMES[base_index]
    inv_base = np.float32(1.0 / base)
    n_digits = int(np.floor(32 / np.log2(base)))
    modulus = base ** n_digits if base ** n_digits < 2 ** 32 else 0
    inv = np.float32(1.0)
    for _ in range(n_digits):
        inv = np.float32(inv * inv_base)
    return base, n_digits, modulus, float(inv)


def radical_inverse(base_index: int, a: torch.Tensor) -> torch.Tensor:
    """Radical inverse of uint32 `a` in the base_index-th prime base, folded
    into base**n_digits < 2**32 first; float32 in [0, 1 - 2**-24]."""
    base, n_digits, modulus, inv = _radical_constants(base_index)
    a = rng.u32(a)
    if modulus:
        a = a % modulus
    rev = torch.zeros_like(a)
    for _ in range(n_digits):
        rev = rev * base + a % base
        a = a // base
    inv_t = torch.tensor(inv, dtype=torch.float32, device=a.device)
    return torch.clamp(rev.to(torch.float32) * inv_t, max=1.0 - 2.0 ** -24)


# ---------------------------------------------------------------------------
# Generated global Sobol' matrices (host numpy, the JAX package's generator)
# ---------------------------------------------------------------------------

def _is_primitive_poly(poly: int, degree: int) -> bool:
    """poly: bit i = coefficient of x^i. Primitive iff x has multiplicative
    order 2^degree - 1 in GF(2)[x]/(poly)."""
    n = (1 << degree) - 1
    if degree == 1:
        return poly == 0b11
    mask = (1 << degree) - 1

    def fmul(u, v):
        acc = 0
        while v:
            if v & 1:
                acc ^= u
            v >>= 1
            u <<= 1
            if u >> degree & 1:
                u ^= poly
            u &= mask | (1 << degree)
            u &= mask
        return acc

    def powx(e):
        r, b = 1, 2
        while e:
            if e & 1:
                r = fmul(r, b)
            b = fmul(b, b)
            e >>= 1
        return r

    if powx(n) != 1:
        return False
    f, p, facs = n, 2, set()
    while p * p <= f:
        while f % p == 0:
            facs.add(p)
            f //= p
        p += 1
    if f > 1:
        facs.add(f)
    return all(powx(n // q) != 1 for q in facs)


def _primitive_polys(count: int) -> list:
    """First `count` primitive polynomials as (degree, interior coefficient
    bits), in degree order."""
    out = []
    degree = 1
    while len(out) < count:
        for poly in range(1 << degree, 1 << (degree + 1)):
            if not poly & 1:
                continue
            if _is_primitive_poly(poly, degree):
                out.append((degree, (poly >> 1) & ((1 << (degree - 1)) - 1)))
                if len(out) >= count:
                    break
        degree += 1
    return out


def generate_sobol_matrices(n_dims: int = 64, n_bits: int = 32) -> np.ndarray:
    """(n_dims, n_bits) uint32 direction numbers, MSB-aligned; dim 0 is van
    der Corput, the others the Bratley-Fox recurrence over generated
    primitive polynomials with initial values drawn from RandomState(0x5350)."""
    V = np.zeros((n_dims, n_bits), np.uint32)
    for i in range(n_bits):
        V[0, i] = np.uint32(1 << (31 - i))
    polys = _primitive_polys(n_dims - 1)
    rs = np.random.RandomState(0x5350)
    for d in range(1, n_dims):
        s, a = polys[d - 1]
        m = [1]
        for i in range(1, s):
            m.append(int(rs.randint(0, 1 << i)) * 2 + 1)
        for i in range(s, n_bits):
            v = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v ^= m[i - k] << k
            m.append(v & 0xFFFFFFFF)
        for i in range(n_bits):
            V[d, i] = np.uint32((m[i] << (31 - i)) & 0xFFFFFFFF)
    return V


def sobol_sample_dim(V_dim: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """uint32 Sobol' value of `index` for one dimension's (32,) matrix (an
    int64 tensor on index's device; on another device this raises)."""
    idx = rng.u32(index)
    out = torch.zeros_like(idx)
    for b in range(32):
        out = out ^ (((idx >> b) & 1) * V_dim[b].expand_as(idx))
    return out


# ---------------------------------------------------------------------------
# Generated pmj02 point sets (host numpy, the JAX package's generator)
# ---------------------------------------------------------------------------

def generate_pmj02(n: int, seed: int = 0) -> np.ndarray:
    """(n, 2) progressive (0,2) points: an Owen-scrambled Sobol' (0,2)
    sequence, kept to its top 24 bits so k * 2**-24 is exact in float32."""
    idx = np.arange(n, dtype=np.uint64)
    x = np.zeros(n, np.uint32)
    v = idx.astype(np.uint32)
    for b in range(32):
        x = (x << np.uint32(1)) | ((v >> np.uint32(b)) & np.uint32(1))
    cols = []
    vk = 1 << 31
    for _ in range(32):
        cols.append(vk)
        vk = vk ^ (vk >> 1)
    cols = np.array(cols, dtype=np.uint32)
    y = np.zeros(n, np.uint32)
    for b in range(32):
        y ^= ((idx >> np.uint64(b)) & np.uint64(1)).astype(np.uint32) * cols[b]

    def owen(u, s):
        r = np.zeros_like(u)
        for b in range(32):
            r = (r << np.uint32(1)) | ((u >> np.uint32(b)) & np.uint32(1))
        r = (r + np.uint32(s & 0xFFFFFFFF)) * np.uint32(0x9E3779B9)
        r ^= r * np.uint32(0x6C50B47C)
        r ^= r * np.uint32(0xB82F1E52)
        r ^= r * np.uint32(0xC7AFE638)
        r ^= r * np.uint32(0x8D22F6E6)
        u = np.zeros_like(r)
        for b in range(32):
            u = (u << np.uint32(1)) | ((r >> np.uint32(b)) & np.uint32(1))
        return u

    rs = np.random.RandomState(seed)
    sx, sy = rs.randint(0, 1 << 31, 2, dtype=np.int64)
    x = owen(x, int(sx) * 2 + 1)
    y = owen(y, int(sy) * 2 + 1)
    pts = (np.stack([x, y], 1) >> np.uint32(8)).astype(np.float64)
    return (pts * (2.0 ** -24)).astype(np.float32)
