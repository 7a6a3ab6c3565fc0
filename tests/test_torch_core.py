"""Parity of the torch port's core/ against the JAX package on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both packages.
Tolerances: integer streams (samplers, hashes, sort keys) must be
bit-identical; float math agrees to rtol 1e-5 (the slack covers ulp
differences of transcendental functions between XLA and torch), with
atol 1e-6 where a value cancels to near zero; the host rgb2spec fit is the
same numpy code (atol 1e-6).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu.core import (samplers as j_samplers, rng as j_rng, vecmath as j_vm,
                             sampling as j_sampling, spectrum as j_spectrum,
                             rgb2spec as j_rgb2spec, colorspace as j_colorspace)
from nn_bvh_tpu.accel import pallas_traverse as j_pt
from nn_bvh_tpu_torch.core import (samplers, rng, vecmath as vm, sampling, spectrum,
                                   rgb2spec, colorspace)
from nn_bvh_tpu_torch.accel import dispatch

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def unit_vectors(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# integer streams: bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sobol", "independent"])
@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_streams_bit_identical(kind, seed):
    """get_1d / get_2d over pixels 0..4095 x samples 0..15 x dims 0..40."""
    pix = np.tile(np.arange(4096, dtype=np.int32), 16)
    smp = np.repeat(np.arange(16, dtype=np.int32), 4096)
    jc = j_samplers.make_sampler(kind, seed=seed, spp=16)
    tc = samplers.make_sampler(kind, seed=seed, spp=16)
    jp, js = jnp.asarray(pix), jnp.asarray(smp)
    tp, ts = torch.from_numpy(pix), torch.from_numpy(smp)
    for dim in range(41):
        a = samplers.get_1d(tc, tp, ts, dim)
        assert a.dtype == torch.float32
        assert (bits(j_samplers.get_1d(jc, jp, js, dim)) == bits(a)).all(), dim
        for ja, ta in zip(j_samplers.get_2d(jc, jp, js, dim),
                          samplers.get_2d(tc, tp, ts, dim)):
            assert (bits(ja) == bits(ta)).all(), dim


def test_hash_float_bit_identical():
    rs = np.random.RandomState(1)
    pix = rs.randint(0, 2 ** 31 - 1, 50000).astype(np.int32)
    smp = rs.randint(0, 1 << 16, 50000).astype(np.int32)
    for depth in range(5):
        a = j_rng.hash_float(jnp.asarray(pix), jnp.asarray(smp),
                             jnp.uint32(depth), jnp.uint32(0x77))
        b = rng.hash_float(torch.from_numpy(pix), torch.from_numpy(smp), depth, 0x77)
        assert (bits(a) == bits(b)).all()


def test_mix_bits_and_mul32_wrap():
    rs = np.random.RandomState(2)
    v = rs.randint(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)
    a = np.asarray(j_rng.mix_bits(jnp.asarray(v)))
    b = rng.mix_bits(torch.from_numpy(v.astype(np.int64))).numpy()
    assert (a.astype(np.int64) == b).all()
    c = 0x846CA68B
    assert (rng.mul32(torch.from_numpy(v.astype(np.int64)), c).numpy()
            == (v.astype(np.uint64) * c % (1 << 32)).astype(np.int64)).all()


def test_ray_sort_key_bit_identical():
    rs = np.random.RandomState(3)
    n = 20000
    o = ((rs.rand(n, 3) - 0.5) * 12).astype(np.float32)
    d = unit_vectors(rs, n)
    t_max = np.where(rs.rand(n) < 0.3, -1.0, 1.0).astype(np.float32)
    blo = np.array([-5.0, 0.0, -5.0], np.float32)
    bext = np.array([10.0, 6.0, 10.0], np.float32)
    a = np.asarray(j_pt.ray_sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(blo),
                                     jnp.asarray(bext), jnp.asarray(t_max)))
    b = dispatch.ray_sort_key(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(blo), torch.from_numpy(bext),
                              torch.from_numpy(t_max)).numpy()
    assert (a.astype(np.int64) == b).all()
    order_j = np.argsort(a, kind="stable")
    assert (order_j == torch.argsort(torch.from_numpy(b), stable=True).numpy()).all()


# ---------------------------------------------------------------------------
# float math: rtol 1e-5
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vec_inputs():
    rs = np.random.RandomState(4)
    n = 4096
    return dict(a=unit_vectors(rs, n), b=unit_vectors(rs, n), c=unit_vectors(rs, n),
                p=((rs.rand(n, 3) - 0.5) * 20).astype(np.float32),
                u=rs.rand(n, 2).astype(np.float32),
                u1=rs.rand(n).astype(np.float32))


VEC_CASES = {
    "normalize": (lambda m, x: m.normalize(x["p"])),
    "cross": (lambda m, x: m.cross(x["a"], x["b"])),
    "coordinate_system": (lambda m, x: m.coordinate_system(x["a"])[0]),
    "coordinate_system_b": (lambda m, x: m.coordinate_system(x["a"])[1]),
    "to_local": (lambda m, x: m.to_local(x["a"], x["b"])),
    "from_local": (lambda m, x: m.from_local(x["a"], x["b"])),
    "spherical_triangle_area": (lambda m, x: m.spherical_triangle_area(x["a"], x["b"], x["c"])),
    "offset_ray_origin": (lambda m, x: m.offset_ray_origin(x["p"], x["a"], x["b"])),
    "face_forward": (lambda m, x: m.face_forward(x["a"], x["b"])),
    "reflect": (lambda m, x: m.reflect(x["a"], x["b"])),
    "tan2_cos_phi": (lambda m, x: m.cos_phi(x["a"]) * m.sin_phi(x["b"])),
}


@pytest.mark.parametrize("case", sorted(VEC_CASES))
def test_vecmath_parity(vec_inputs, case):
    fn = VEC_CASES[case]
    j = fn(j_vm, {k: jnp.asarray(v) for k, v in vec_inputs.items()})
    t = fn(vm, {k: torch.from_numpy(v) for k, v in vec_inputs.items()})
    assert t.dtype == torch.float32
    close(j, t)


SAMPLING_CASES = {
    "disk_concentric": (lambda m, x: m.sample_uniform_disk_concentric(x["u"])),
    "cosine_hemisphere": (lambda m, x: m.sample_cosine_hemisphere(x["u"])),
    "uniform_sphere": (lambda m, x: m.sample_uniform_sphere(x["u"])),
    "uniform_triangle": (lambda m, x: m.sample_uniform_triangle(x["u"])),
    "power_heuristic": (lambda m, x: m.power_heuristic(1.0, x["u"][:, 0] * 5, 1.0,
                                                       x["u"][:, 1] * 5)),
    "visible_wavelengths": (lambda m, x: m.sample_visible_wavelengths(x["u1"])),
    "visible_wavelengths_pdf": (lambda m, x: m.visible_wavelengths_pdf(
        360.0 + 470.0 * x["u1"])),
}


@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_sampling_parity(vec_inputs, case):
    fn = SAMPLING_CASES[case]
    close(fn(j_sampling, {k: jnp.asarray(v) for k, v in vec_inputs.items()}),
          fn(sampling, {k: torch.from_numpy(v) for k, v in vec_inputs.items()}))


def test_spherical_triangle_sampling_parity():
    rs = np.random.RandomState(5)
    n = 4096
    v0 = np.array([-1.0, 2.0, 0.5], np.float32) + rs.randn(n, 3).astype(np.float32) * 0.1
    v1 = np.array([1.0, 2.0, 0.5], np.float32) + rs.randn(n, 3).astype(np.float32) * 0.1
    v2 = np.array([0.0, 2.5, 1.5], np.float32) + rs.randn(n, 3).astype(np.float32) * 0.1
    # shading points 0.5-1 away: the Arvo construction is ill-conditioned in
    # float32 for tiny solid angles (A = alpha+beta+gamma-pi cancels), where
    # ulp differences of acos grow to 1e-2; this checks the formula there
    p = (np.array([0.0, 1.2, 0.8]) + (rs.rand(n, 3) - 0.5) * [1.0, 0.4, 1.0]).astype(np.float32)
    u = rs.rand(n, 2).astype(np.float32)
    jb, jpdf, jdeg = j_sampling.sample_spherical_triangle(*map(jnp.asarray, (v0, v1, v2, p, u)))
    tb, tpdf, tdeg = sampling.sample_spherical_triangle(*map(torch.from_numpy, (v0, v1, v2, p, u)))
    # the barycentrics pass through acos of dihedral cosines near +-1, whose
    # slope 1/sqrt(1-x^2) turns one ulp into ~1e-4 on a few lanes: atol 2e-4
    close(jb, tb, atol=2e-4)
    close(jpdf, tpdf)
    assert (np.asarray(jdeg) == tdeg.numpy()).all()


def test_wavelengths_and_xyz_parity():
    rs = np.random.RandomState(6)
    u = rs.rand(8192).astype(np.float32)
    jl, jp = j_spectrum.sample_wavelengths_visible(jnp.asarray(u))
    tl, tp = spectrum.sample_wavelengths_visible(torch.from_numpy(u))
    close(jl, tl)
    close(jp, tp)
    vals = rs.rand(8192, 4).astype(np.float32) * 3
    close(j_spectrum.spectrum_to_xyz(jnp.asarray(vals), jl, jp),
          spectrum.spectrum_to_xyz(torch.from_numpy(vals), tl, tp))
    close(j_spectrum.illuminant_d_normalized(jl), spectrum.illuminant_d_normalized(tl))
    assert spectrum.CIE_Y_INTEGRAL == j_spectrum.CIE_Y_INTEGRAL
    assert spectrum.ILLUM_D_Y == j_spectrum.ILLUM_D_Y


def test_rgb2spec_host_fit_matches():
    """The bench colours (bench.py materials + the emitter)."""
    rgb = np.array([[0.6, 0.5, 0.4], [0.9, 0.75, 0.5], [0.5, 0.5, 0.5],
                    [1.0, 0.9, 0.8]], np.float32)
    jc, js = j_rgb2spec.rgb_to_coeffs_host(rgb)
    tc, ts = rgb2spec.rgb_to_coeffs_host(rgb)
    np.testing.assert_allclose(tc, jc, atol=1e-6)
    np.testing.assert_allclose(ts, js, atol=1e-6)
    lam = np.linspace(360, 830, 4 * 16, dtype=np.float32).reshape(16, 4)
    coeffs = np.repeat(tc, 4, axis=0)
    close(j_rgb2spec.eval_sigmoid_poly(jnp.asarray(coeffs), jnp.asarray(lam)),
          rgb2spec.eval_sigmoid_poly(torch.from_numpy(coeffs), torch.from_numpy(lam)))


def test_colorspace_matrices_match():
    np.testing.assert_array_equal(colorspace.SENSOR_XYZ_TO_SRGB,
                                  j_colorspace.SENSOR_XYZ_TO_SRGB)
    np.testing.assert_array_equal(colorspace.XYZ_TO_RGB_SRGB,
                                  j_colorspace.XYZ_TO_RGB["srgb"])
    rs = np.random.RandomState(8)
    xyz = rs.rand(1000, 3).astype(np.float32)
    close(j_colorspace.xyz_to_linear_srgb(jnp.asarray(xyz)),
          colorspace.xyz_to_linear_srgb(torch.from_numpy(xyz)))


def test_unported_sampler_raises():
    # every kind of the JAX package's make_sampler is ported; MLT's table
    # kind has no name there and comes with its integrator
    with pytest.raises(ValueError, match="TABLE kind is built by wavefront/mlt.py"):
        samplers.make_sampler("table")
