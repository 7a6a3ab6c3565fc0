"""The port's samplers against the JAX package on the CPU, bit for bit:
get_1d and get_2d of every kind (independent, stratified, sobol,
paddedsobol, halton, zsobol, fullsobol, pmj02bn) on a grid of pixels,
samples and dims, and the pieces under them: the generated global Sobol'
matrices, the pmj02 point sets, the ZSobol Morton indices and the Halton
radical inverses. Every comparison is of the float32 bit patterns (or the
uint32 values) and allows no difference.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu.core import lowdiscrepancy as j_ld, samplers as j_samplers
from nn_bvh_tpu_torch.core import lowdiscrepancy as ld, rng, samplers

torch.set_num_threads(1)

KINDS = ["independent", "stratified", "sobol", "paddedsobol", "halton", "zsobol",
         "fullsobol", "pmj02bn"]
DIMS = [0, 1, 2, 3, 5, 12, 33, 63, 64, 101]


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.float32
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


def grid(n_pix: int = 1024, spp: int = 8, seed: int = 0):
    """Pixels of a 64-wide image (scattered over 2**13 rows) x samples."""
    rs = np.random.RandomState(seed)
    pix = rs.randint(0, 64 * 8192, n_pix).astype(np.int32)
    return np.tile(pix, spp), np.repeat(np.arange(spp, dtype=np.int32), n_pix)


@pytest.mark.parametrize("spp", [8, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_sampler_streams_bit_identical(kind, spp):
    pix, smp = grid(spp=spp, seed=spp)
    jc = j_samplers.make_sampler(kind, seed=5, spp=spp, width=64)
    tc = samplers.make_sampler(kind, seed=5, spp=spp, width=64)
    jp, js = jnp.asarray(pix), jnp.asarray(smp)
    tp, ts = torch.from_numpy(pix), torch.from_numpy(smp)
    for dim in DIMS:
        assert (bits(j_samplers.get_1d(jc, jp, js, dim))
                == bits(samplers.get_1d(tc, tp, ts, dim))).all(), dim
        for ja, ta in zip(j_samplers.get_2d(jc, jp, js, dim), samplers.get_2d(tc, tp, ts, dim)):
            assert (bits(ja) == bits(ta)).all(), dim


def test_sampler_tables_equal_jax():
    tc = samplers.make_sampler("fullsobol")
    np.testing.assert_array_equal(tc.sobol_v.numpy(),
                                  np.asarray(j_samplers.make_sampler("fullsobol").sobol_v))
    for spp in (1, 4, 16, 64):
        np.testing.assert_array_equal(
            samplers.make_sampler("pmj02bn", spp=spp).pmj.numpy(),
            np.asarray(j_samplers.make_sampler("pmj02bn", spp=spp).pmj))
    np.testing.assert_array_equal(ld.generate_sobol_matrices(20, 32),
                                  j_ld.generate_sobol_matrices(20, 32))
    np.testing.assert_array_equal(ld.generate_pmj02(256, seed=3), j_ld.generate_pmj02(256, seed=3))
    assert ld._primitive_polys(40) == j_ld._primitive_polys(40)
    assert ld._PERMS4 == np.asarray(j_ld._PERMS4).tolist()


def test_zsobol_index_and_morton_equal_jax():
    rs = np.random.RandomState(2)
    x = rs.randint(0, 1 << 13, 4096).astype(np.uint32)
    y = rs.randint(0, 1 << 13, 4096).astype(np.uint32)
    s = rs.randint(0, 64, 4096).astype(np.uint32)
    np.testing.assert_array_equal(
        ld.encode_morton2(torch.from_numpy(x.astype(np.int64)),
                          torch.from_numpy(y.astype(np.int64))).numpy(),
        np.asarray(j_ld.encode_morton2(jnp.asarray(x), jnp.asarray(y))).astype(np.int64))
    for log2_spp in (0, 4, 6):
        for dim in (0, 7, 40):
            j = j_ld.zsobol_shuffled_index(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(s % (1 << log2_spp)), log2_spp,
                                           jnp.uint32(dim), jnp.uint32(9))
            t = ld.zsobol_shuffled_index(torch.from_numpy(x.astype(np.int64)),
                                         torch.from_numpy(y.astype(np.int64)),
                                         torch.from_numpy((s % (1 << log2_spp)).astype(np.int64)),
                                         log2_spp, dim, 9)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("base_index", range(len(ld._PRIMES)))
def test_radical_inverse_bit_identical(base_index):
    rs = np.random.RandomState(base_index)
    a = np.concatenate([np.arange(512), rs.randint(0, 2 ** 32, 4096, dtype=np.uint64),
                        [2 ** 32 - 1]]).astype(np.uint32)
    j = j_ld.radical_inverse(base_index, jnp.asarray(a))
    t = ld.radical_inverse(base_index, torch.from_numpy(a.astype(np.int64)))
    assert (bits(j) == bits(t)).all()


def test_sobol_sample_dim_equal_jax():
    V = ld.generate_sobol_matrices(8)
    idx = np.arange(5000, dtype=np.uint32) * 977
    for d in range(8):
        j = j_ld.sobol_sample_dim(jnp.asarray(V[d]), jnp.asarray(idx))
        t = ld.sobol_sample_dim(torch.from_numpy(V[d].astype(np.int64)),
                                torch.from_numpy(idx.astype(np.int64)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_samples_in_unit_interval():
    """fullsobol and pmj02bn convert without a clamp, as JAX does; every
    other kind stays below 1."""
    pix, smp = grid(spp=16)
    for kind in KINDS:
        tc = samplers.make_sampler(kind, seed=1, spp=16, width=64)
        u = samplers.get_1d(tc, torch.from_numpy(pix), torch.from_numpy(smp), 3)
        assert bool((u >= 0).all()) and bool((u <= 1).all()), kind
        if kind not in ("fullsobol", "pmj02bn"):
            assert bool((u < 1).all()), kind
    assert rng.M32 == 0xFFFFFFFF
