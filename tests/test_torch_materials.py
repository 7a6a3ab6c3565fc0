"""The port's materials against the JAX package on the CPU: tables, lobes,
hash streams and the host numpy functions.

- Tables: the twelve materials of the material scene
  (`bench_scene.add_material_kinds`) built by each package's SceneBuilder
  give equal tables: material rows, named-spectrum tables, measured
  coefficients and alpha, the subsurface tables, the feature flags.
- Lobes: for every material kind (and the subsurface exit lobe),
  gather_material, evaluate and sample (both modes) on 4,096 lanes drawn
  from a numpy seed, through each package on its own copy of that scene.
  f, pdf and wi within atol 1e-5 + rtol 1e-4; boolean outputs equal. A lane
  may miss either only where a draw sits within rounding of a threshold
  (Fresnel reflect or refract, the hair lobe choice, the coated walk's
  choices): such lanes are counted and bounded per kind (LANES_OFF).
- The lobe gates: a context holding one kind's tag computes that kind's
  lanes exactly as the context of every kind does.
- Hash streams bit-identical to JAX: the layered walk's (_hash_vec, the
  draws of _Rng, coated_sample's seed), the mix draw (salt 0x77, VolPath's
  salt 31) and the subsurface salts 0x5501-0x5505, 0x5510 + k.
- Host numpy functions: named spectra, the RGL tensor-file round trip
  (equal bytes), its resampler (rtol 1e-6 + atol 1e-7: the CIE curves are
  float32 jnp in JAX, numpy here), the beam-diffusion table (equal arrays).
- The BSSRDF device functions: sr_eval, sr_sample, sr_pdf, r_max within
  rtol 1e-5 + atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu.core import named_spectra as j_named, rng as j_rng
from nn_bvh_tpu.geometry import scene as j_scene
from nn_bvh_tpu.scatter import bxdf as j_bxdf, bssrdf as j_bss, layered as j_layered
from nn_bvh_tpu.scatter import measured as j_measured
from nn_bvh_tpu_torch.core import named_spectra, rng
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import bxdf, bssrdf, layered, measured
from nn_bvh_tpu_torch.tools import bench_scene

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-4, 1e-5
KINDS = bench_scene.MATERIAL_KINDS + ("conductor", "sss exit")
# lanes of 4,096 on which a lobe may miss the tolerance or a boolean may
# differ, where a draw sits within rounding of a threshold. Observed on the
# CPU: 2 lanes of the coated conductor's sample (the walk's choices) and 2
# of hair's (the lobe choice), both modes; 0 elsewhere, and no boolean.
LANES_OFF = {"coated diffuse": 4, "coated conductor": 4, "hair": 4}
LANES_OFF_DEFAULT = 2


def tables(mod):
    b = mod.SceneBuilder()
    ids = bench_scene.add_material_kinds(b)
    b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), ids[-1])
    return b.build(), dict(zip(bench_scene.MATERIAL_KINDS, ids)) | {"conductor": 1}


@pytest.fixture(scope="module")
def scenes():
    (jsc, ids), (tsc, tids) = tables(j_scene), tables(scene)
    assert ids == tids
    return jax.tree.map(jnp.asarray, jsc), scene.to_device(tsc, "cpu"), ids, jsc, tsc


def test_tables_match_jax(scenes):
    *_, jsc, tsc = scenes
    for k in scene.CompiledScene._fields:
        a, b = getattr(jsc, k), getattr(tsc, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
    assert tsc.feat_coated and tsc.feat_mix and tsc.feat_hair and tsc.feat_measured
    assert tsc.feat_spectral and tsc.feat_subsurface
    assert tsc.spec_tables.shape == (2, named_spectra.DENSE_N)
    assert tsc.sss_profile.shape == (1, bssrdf.N_RHO, bssrdf.N_RADIUS)


@pytest.fixture(scope="module")
def draws():
    rs = np.random.RandomState(0)
    wo = rs.randn(N, 3).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) * np.where(rs.rand(N) < 0.8, 1, -1)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rs.randn(N, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    return dict(wo=wo, wi=wi, uc=rs.rand(N).astype(np.float32),
                u2=rs.rand(N, 2).astype(np.float32),
                lam=(360 + 470 * rs.rand(N, 4)).astype(np.float32),
                uv=rs.rand(N, 2).astype(np.float32), u_mix=rs.rand(N).astype(np.float32))


def ctxs(scenes, draws, kind):
    jsc, tsc, ids = scenes[:3]
    mat = np.full(N, ids["subsurface" if kind == "sss exit" else kind], np.int32)
    a = {k: draws[k] for k in ("lam", "uv", "u_mix")}
    jc = j_bxdf.gather_material(jsc, jnp.asarray(mat), jnp.asarray(a["lam"]),
                                uv=jnp.asarray(a["uv"]), u_mix=jnp.asarray(a["u_mix"]))
    tc = bxdf.gather_material(tsc, torch.from_numpy(mat), torch.from_numpy(a["lam"]),
                              uv=torch.from_numpy(a["uv"]), u_mix=torch.from_numpy(a["u_mix"]))
    if kind == "sss exit":
        jc = jc._replace(mat_type=jnp.full((N,), j_scene.MAT_SSS_EXIT, jnp.int32))
        tc = tc._replace(mat_type=torch.full((N,), scene.MAT_SSS_EXIT, dtype=torch.int32))
    return jc, tc


def lanes_off(a, b, rtol=RTOL, atol=ATOL):
    ok = np.isclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)
    return ~(ok.all(-1) if ok.ndim > 1 else ok)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_material_matches_jax(scenes, draws, kind):
    jc, tc = ctxs(scenes, draws, kind)
    assert np.array_equal(np.asarray(jc.mat_type), tc.mat_type.numpy())
    for name in bxdf.MaterialCtx._fields[:-1]:
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    if kind == "mix":  # both sub-materials drawn, by the same u_mix
        picked = set(np.unique(tc.mat_type.numpy()).tolist())
        assert picked == {scene.MAT_DIFFUSE, scene.MAT_CONDUCTOR}


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_matches_jax(scenes, draws, kind):
    jc, tc = ctxs(scenes, draws, kind)
    jf, jp = j_bxdf.evaluate(jc, jnp.asarray(draws["wo"]), jnp.asarray(draws["wi"]))
    tf, tp = bxdf.evaluate(tc, torch.from_numpy(draws["wo"]), torch.from_numpy(draws["wi"]))
    assert tf.dtype == tp.dtype == torch.float32 and tf.shape == (N, 4)
    off = lanes_off(jf, tf) | lanes_off(jp, tp)
    assert off.sum() <= LANES_OFF.get(kind, LANES_OFF_DEFAULT), (kind, int(off.sum()))
    assert np.isfinite(tf.numpy()).all() and np.isfinite(tp.numpy()).all()
    if kind in ("dielectric", "thin dielectric", "diffuse transmission", "subsurface"):
        assert not tf.numpy().any()  # deltas; no evaluate branch (the reference's own)
    else:
        assert (tp.numpy() > 0).mean() > 0.2


@pytest.mark.parametrize("mode", ["radiance", "importance"])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_matches_jax(scenes, draws, kind, mode):
    jc, tc = ctxs(scenes, draws, kind)
    js = j_bxdf.sample(jc, jnp.asarray(draws["wo"]), jnp.asarray(draws["uc"]),
                       jnp.asarray(draws["u2"]), mode=mode)
    ts = bxdf.sample(tc, torch.from_numpy(draws["wo"]), torch.from_numpy(draws["uc"]),
                     torch.from_numpy(draws["u2"]), mode=mode)
    off = np.zeros(N, bool)
    for name in ("valid", "specular", "transmission"):
        off |= np.asarray(getattr(js, name)) != getattr(ts, name).numpy()
    v = np.asarray(js.valid) & ts.valid.numpy()
    for name in ("wi", "f", "pdf", "eta"):
        off[v] |= lanes_off(np.asarray(getattr(js, name))[v], getattr(ts, name).numpy()[v])
    assert off.sum() <= LANES_OFF.get(kind, LANES_OFF_DEFAULT), (kind, int(off.sum()))
    if kind == "subsurface":
        assert not ts.valid.numpy().any()  # no sample branch (the reference's own)
    else:
        assert ts.valid.numpy().mean() > 0.5, kind
    if kind in ("dielectric", "rough dielectric", "thin dielectric", "diffuse transmission"):
        assert ts.transmission.numpy().any()


@pytest.mark.parametrize("kind", KINDS)
def test_lobe_gates_compute_the_same(scenes, draws, kind):
    """The port computes only the lobes of the scene's materials
    (MaterialCtx.kinds): a context that holds only this kind's tag (and the
    mirror and exit lobes a subsurface lane can take) gives the values of
    the context that holds every tag."""
    _, tc = ctxs(scenes, draws, kind)
    tags = set(np.unique(tc.mat_type.numpy()).tolist())
    one = tc._replace(kinds=frozenset(tags))
    wo, wi = torch.from_numpy(draws["wo"]), torch.from_numpy(draws["wi"])
    for a, b in zip(bxdf.evaluate(one, wo, wi), bxdf.evaluate(tc, wo, wi)):
        assert torch.equal(a, b)
    uc, u2 = torch.from_numpy(draws["uc"]), torch.from_numpy(draws["u2"])
    for a, b in zip(bxdf.sample(one, wo, uc, u2), bxdf.sample(tc, wo, uc, u2)):
        assert torch.equal(a, b)


def test_fresnel_helpers_match_jax(draws):
    c = draws["wo"][:, 2]
    eta = (0.5 + 2.0 * draws["uc"]).astype(np.float32)
    tc, te = torch.from_numpy(c), torch.from_numpy(eta)
    jc, je = jnp.asarray(c), jnp.asarray(eta)
    for a, b in ((bxdf.fr_dielectric(tc, te), j_bxdf.fr_dielectric(jc, je)),
                 (bxdf.fresnel_moment1(te), j_bxdf.fresnel_moment1(je)),
                 (bxdf.sss_exit_f(te, tc.abs()), j_bxdf.sss_exit_f(je, jnp.abs(jc)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    wo, wi = draws["wo"], draws["wi"]
    wm = (wo + wi) / np.linalg.norm(wo + wi, axis=1, keepdims=True)
    a = draws["u2"][:, 0] * 0.8 + 0.05
    np.testing.assert_allclose(
        bxdf.tr_d_visible(*map(torch.from_numpy, (wo, wm, a, a))).numpy(),
        np.asarray(j_bxdf.tr_d_visible(*map(jnp.asarray, (wo, wm, a, a)))), rtol=RTOL,
        atol=ATOL)


# ---------------------------------------------------------------------------
# hash streams
# ---------------------------------------------------------------------------

def test_layered_hash_stream_bit_identical(draws):
    v = draws["wo"]
    for salt in (0x51AB0F00, 0x2C1B3C6D, 0x7F4A7C15, 0x94D049BB, 0x2545F491):
        t = layered._hash_vec(torch.from_numpy(v), salt)
        j = j_layered._hash_vec(jnp.asarray(v), salt)
        assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64)), hex(salt)
    t_rng = layered._lane_rng(layered._hash_vec(torch.from_numpy(v), 1),
                              layered._hash_vec(torch.from_numpy(-v), 2), 0)
    j_rng_ = j_layered._Rng(j_layered._hash_vec(jnp.asarray(v), 1),
                            j_layered._mix(j_layered._hash_vec(jnp.asarray(-v), 2)
                                           + jnp.uint32(0)))
    for _ in range(40):
        assert np.array_equal(t_rng.next().numpy(), np.asarray(j_rng_.next()))
    # coated_sample's seed: the bits of uc and of (u2, uc)
    uc, u2 = draws["uc"], draws["u2"]
    t_seed = layered._mix(layered._bits(torch.from_numpy(uc)) ^ layered._hash_vec(
        torch.from_numpy(np.concatenate([u2, uc[:, None]], -1)), 0x63D83595))
    j_seed = j_layered._mix(jax.lax.bitcast_convert_type(jnp.asarray(uc), jnp.uint32)
                            ^ j_layered._hash_vec(jnp.concatenate(
                                [jnp.asarray(u2), jnp.asarray(uc)[:, None]], -1), 0x63D83595))
    assert np.array_equal(t_seed.numpy(), np.asarray(j_seed).astype(np.int64))


@pytest.mark.parametrize("salt", [0x77, 31, 0x5501, 0x5502, 0x5503, 0x5504, 0x5505,
                                  0x5510, 0x5511, 0x5512])
def test_mix_and_subsurface_salts_bit_identical(salt):
    rs = np.random.RandomState(salt)
    pix = rs.randint(0, 2 ** 31 - 1, N).astype(np.int32)
    sidx = rs.randint(0, 1024, N).astype(np.int32)
    for depth in (0, 3):
        t = rng.hash_float(torch.from_numpy(pix), torch.from_numpy(sidx), depth, salt)
        j = j_rng.hash_float(jnp.asarray(pix), jnp.asarray(sidx), jnp.uint32(depth),
                             jnp.uint32(salt))
        assert np.array_equal(t.numpy(), np.asarray(j)), (salt, depth)


# ---------------------------------------------------------------------------
# host numpy functions
# ---------------------------------------------------------------------------

def test_named_spectra_match_jax(tmp_path):
    assert named_spectra.names() == j_named.names()
    for name in ("metal-Au-eta", "metal-Au-k", "stdillum-D65", "glass-BK7"):
        assert named_spectra.has(name) == j_named.has(name)
        if not j_named.has(name):
            continue
        for a, b in zip(named_spectra.get(name), j_named.get(name)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(named_spectra.dense(name), j_named.dense(name))
        lam = np.linspace(300, 900, 77)
        np.testing.assert_array_equal(named_spectra.eval_at(name, lam),
                                      j_named.eval_at(name, lam))
    spd = tmp_path / "t.spd"
    spd.write_text("# wavelength value\n700 0.5\n400 0.25  # blue\n550 1.0\n")
    for a, b in zip(named_spectra.read_spd(str(spd)), j_named.read_spd(str(spd))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(named_spectra.dense(str(spd)), j_named.dense(str(spd)))
    with pytest.raises(KeyError):
        named_spectra.get("metal-unobtainium-eta")


def rgl_fields(H=16, W=16, T=6, L=4):
    """Consistent isotropic RGL fields (tests/test_measured_rgl.py's
    'linear' warp)."""
    theta_i = np.linspace(0, np.pi / 2, T).astype(np.float32)
    x = np.linspace(0, 1, W)
    vndf = np.broadcast_to((1.0 + 3.0 * x)[None, None, None, :], (1, T, H, W)).astype(np.float32)
    base = 0.2 + 0.6 * x[None, :] + 0.2 * np.linspace(0, 1, H)[:, None]
    spectra = np.stack([base * (0.5 + 0.5 * li / (L - 1)) for li in range(L)])
    return dict(theta_i=theta_i, phi_i=np.array([0.0], np.float32),
                wavelengths=np.linspace(400.0, 700.0, L).astype(np.float32),
                ndf=(1.0 + x[None, :] * np.ones((H, 1))).astype(np.float32),
                sigma=np.linspace(1.0, 0.3, W)[None, :].repeat(2, 0).astype(np.float32),
                vndf=vndf.copy(),
                spectra=np.broadcast_to(spectra[None, None], (1, T, L, H, W)).astype(np.float32),
                description=np.frombuffer(b"synthetic", np.uint8).copy())


def test_rgl_round_trip_and_resampler_match_jax(tmp_path):
    fields = rgl_fields()
    measured.write_bsdf(str(tmp_path / "port.bsdf"), fields)
    j_measured.write_bsdf(str(tmp_path / "jax.bsdf"), fields)
    assert (tmp_path / "port.bsdf").read_bytes() == (tmp_path / "jax.bsdf").read_bytes()
    back = j_measured.read_bsdf(str(tmp_path / "port.bsdf"))
    mine = measured.read_bsdf(str(tmp_path / "port.bsdf"))
    for k, v in fields.items():
        assert mine[k].dtype == v.dtype and np.array_equal(mine[k], v), k
        assert np.array_equal(back[k], v), k
    tab = measured.bsdf_to_table(mine, res=(8, 8, 8))
    np.testing.assert_allclose(tab, j_measured.bsdf_to_table(back, res=(8, 8, 8)),
                               rtol=1e-6, atol=1e-7)
    assert measured.fit_ggx_alpha(tab) == j_measured.fit_ggx_alpha(tab)
    np.testing.assert_array_equal(measured.table_to_coeffs(tab), j_measured.table_to_coeffs(tab))
    measured.save_table(str(tmp_path / "t.npz"), tab)
    np.testing.assert_array_equal(j_measured.load_table(str(tmp_path / "t.npz")), tab)
    (tmp_path / "bad.bsdf").write_bytes(b"not a tensor file")
    with pytest.raises(ValueError, match="not a tensor file"):
        measured.read_bsdf(str(tmp_path / "bad.bsdf"))


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.4, 1.5)])
def test_beam_diffusion_table_matches_jax(g, eta):
    t = bssrdf.compute_beam_diffusion_table(g, eta, n_samples=40)
    j = j_bss.compute_beam_diffusion_table(g, eta, n_samples=40)
    for name in bssrdf.BSSRDFTable._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_bssrdf_device_functions_match_jax():
    t = bssrdf.compute_beam_diffusion_table(0.0, 1.33, n_samples=40)
    tt = bssrdf.BSSRDFTable(*(torch.from_numpy(np.ascontiguousarray(a)) for a in t))
    jt = j_bss.BSSRDFTable(*(jnp.asarray(a) for a in t))
    rs = np.random.RandomState(9)
    sig = (0.5 + 5 * rs.rand(N)).astype(np.float32)
    rho = rs.rand(N).astype(np.float32)
    r = (rs.rand(N) * 2).astype(np.float32)
    u = rs.rand(N).astype(np.float32)
    T = [torch.from_numpy(x) for x in (sig, rho, r, u)]
    J = [jnp.asarray(x) for x in (sig, rho, r, u)]
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    close(bssrdf.sr_eval(tt, *T[:3]), j_bss.sr_eval(jt, *J[:3]))
    close(bssrdf.sr_pdf(tt, *T[:3]), j_bss.sr_pdf(jt, *J[:3]))
    close(bssrdf.r_max(tt, *T[:2]), j_bss.r_max(jt, *J[:2]))
    for a, b in zip(bssrdf.sr_sample(tt, T[0], T[1], T[3]), j_bss.sr_sample(jt, J[0], J[1], J[3])):
        close(a, b)
