"""The port's dist/ (nn_bvh_tpu_torch/dist/) on the CPU: the sharded render,
the torchrun-style launch and the render-state checkpoints, held against
the JAX package's dist/ and against themselves across process counts.

The scene is tests/test_multihost.py's (a diffuse sphere on a floor under
a two-sided area light, 8x8, depth 1, independent sampler), built by each
package's own SceneBuilder. Tolerances:
- render_sharded at world size 1 against JAX's render_sharded on
  make_mesh(2) (two of conftest's virtual CPU devices): JAX's own
  cross-program band, rtol 1e-5 + atol 1e-6 (tests/test_determinism.py:65-69),
  with SimplePath and with Path MIS. With MIS, 8 bounce rays of this
  scene's 4 waves (pixels HELD_APART) hit the emissive quad's last leaf,
  triangles 122-123 of the 128 padded rows. JAX's XLA traversal reads a
  leaf as dynamic_slice_in_dim(tri_p, offset, 8), whose start clamps to
  128 - 8 = 120, so it tests triangles 120-121 in their place and reports
  a miss: a reference fault, not mirrored (ROADMAP queue 3). A float64
  Moller-Trumbore over every triangle is the witness: on every ray of
  the render it agrees with the port's traversal, and the lanes where it
  disagrees with JAX's are exactly those 8. Those pixels are held apart
  (brighter in the port by the quad's emission) and the rest held to the
  band;
- two gloo processes against world size 1: bit for bit (each lane's
  arithmetic is the same whatever band it is traced in, and the gather
  only concatenates);
- a render killed after 2 of 4 waves and resumed from its render state:
  bit for bit with the uninterrupted render;
- a render state that JAX's save_render_state wrote loads in the port
  with every array equal, and the port's loads in JAX;
- `cli.render --sharded` on a small .pbrt file: at world size 1 the image
  of the CLI without the flag; on two gloo ranks (torchrun's environment)
  render_sharded's image bit for bit, written by rank 0 alone.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import traverse as j_traverse
from nn_bvh_tpu.dist import multihost as j_multihost, sharding as j_sharding
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.learn import treenet as j_treenet
from nn_bvh_tpu.wavefront import (camera as j_camera, film as j_film,
                                  integrator as j_integrator)
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.dist import multihost, sharding
from nn_bvh_tpu_torch.geometry import scene, transform as xf
from nn_bvh_tpu_torch.learn import treenet
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(__file__), "..")
SPP = 4

# one definition of the scene for both packages and the worker processes
SCENE_SRC = r'''
def make_scene(scene_mod, accel, xf, camera_mod):
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0, width=8, height=8)
    return sc, dbvh, cam
'''
exec(SCENE_SRC)

WORKER = SCENE_SRC + r'''
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.dist import multihost, sharding
from nn_bvh_tpu_torch.geometry import scene as scene_mod, transform as xf
from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

out, spp = sys.argv[1], int(sys.argv[2])
assert multihost.initialize(timeout_s=120)
mesh = sharding.make_mesh(device="cpu")
assert (mesh.world_size, mesh.rank) == (2, int(os.environ["RANK"]))
assert torch.distributed.get_backend() == "gloo"
sc, dbvh, cam = make_scene(scene_mod, accel, xf, camera_mod)
cfg = integrator.IntegratorConfig(max_depth=1, mis=True)
kw = dict(spp=spp, sampler="independent", cfg=cfg)
full = sharding.render_sharded(sc, dbvh, cam, mesh, **kw)
ck = os.path.join(out, "state")

class Killed(Exception):
    pass

def kill_after_two(s, xyz, weight):
    if s == 1:
        multihost.save_render_state(ck, xyz, weight, s + 1, mesh=mesh)
        raise Killed

try:
    sharding.render_sharded(sc, dbvh, cam, mesh, wave_callback=kill_after_two, **kw)
except Killed:
    pass
xyz, weight, nxt, _ = multihost.load_render_state(ck, mesh=mesh)
assert nxt == 2 and xyz.shape == (32, 3) and weight.shape == (32,)
resumed = sharding.render_sharded(sc, dbvh, cam, mesh, film_state=(xyz, weight),
                                  start_sample=nxt, **kw)
if mesh.rank == 0:
    np.save(os.path.join(out, "full.npy"), full.numpy())
    np.save(os.path.join(out, "resumed.npy"), resumed.numpy())
torch.distributed.barrier()
print("rank", mesh.rank, "done", flush=True)
'''


PBRT = """LookAt 0 1.5 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8] "string filename" "out.pfm"
Sampler "independent" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 3 -1 1 3 -1 1 3 1 -1 3 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.6 0.4 0.3]
Shape "trianglemesh" "point3 P" [-4 0 -4 4 0 -4 4 0 4 -4 0 4] "integer indices" [0 1 2 0 2 3]
AttributeBegin
  Translate 0 0.6 0
  Shape "sphere" "float radius" [0.6]
AttributeEnd
"""


def port_scene():
    return make_scene(scene, accel, xf, camera)


def port_render(mis: bool = True, **kw):
    sc, dbvh, cam = port_scene()
    mesh = sharding.make_mesh(device="cpu")
    cfg = integrator.IntegratorConfig(max_depth=1, mis=mis)
    return sharding.render_sharded(sc, dbvh, cam, mesh, spp=SPP, sampler="independent",
                                   cfg=cfg, **kw).numpy()


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """The worker's two gloo ranks on the CPU -> their output directory."""
    d = tmp_path_factory.mktemp("dist2")
    script = d / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = multihost.run_local([sys.executable, str(script), str(d), str(SPP)], 2,
                               timeout_s=300, env=env, cwd=REPO)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    assert sorted(p.name for p in d.glob("state.proc*.npz")) == ["state.proc0.npz",
                                                                  "state.proc1.npz"]
    return d


# the pixels whose bounce ray JAX's XLA traversal misses (see the docstring)
HELD_APART = [37, 45, 47, 51, 54, 55, 57, 58]


class RecordingIntersectors(dispatch.Intersectors):
    """The port's traversal, keeping each closest-hit call's rays and hit."""

    def __init__(self, base):
        super().__init__(**base.like())
        self.calls = []

    def closest(self, o, d, t_max):
        hit = super().closest(o, d, t_max)
        self.calls.append((o, d, t_max, hit))
        return hit


def closest_f64(tri: np.ndarray, o, d, t_max) -> np.ndarray:
    """Closest triangle of each ray by Moller-Trumbore in float64 over every
    triangle (-1: none) -> (R,) prim ids."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    best, prim = t_max.astype(np.float64).copy(), np.full(len(o), -1)
    for i, (v0, v1, v2) in enumerate(tri.astype(np.float64)):
        e1, e2 = v1 - v0, v2 - v0
        p = np.cross(d, e2)
        det = p @ e1
        inv = 1.0 / np.where(det == 0, 1e-300, det)
        s = o - v0
        u = (s * p).sum(-1) * inv
        q = np.cross(s, e1)
        v = (d * q).sum(-1) * inv
        t = (q @ e2) * inv
        h = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < best)
        best, prim = np.where(h, t, best), np.where(h, i, prim)
    return prim


@pytest.mark.parametrize("mis", [False, True])
def test_world_size_one_matches_jax_mesh_of_two(mis):
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices (conftest sets XLA_FLAGS)")
    jsc, jdbvh, jcam = make_scene(j_scene, j_accel, j_xf, j_camera)
    jcfg = j_integrator.IntegratorConfig(max_depth=1, mis=mis, use_pallas=False)
    want = np.asarray(j_sharding.render_sharded(jsc, jdbvh, jcam, j_sharding.make_mesh(2),
                                                spp=SPP, sampler="independent", cfg=jcfg))
    sc, dbvh, cam = port_scene()
    rec = RecordingIntersectors(dispatch.make_intersectors(sc, dbvh, "cpu"))
    got = port_render(mis=mis, isect=rec)
    assert got.shape == want.shape == (8, 8, 3) and got.mean() > 0
    if not mis:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    tri = np.asarray(jsc.tri_p)
    assert tri.shape[0] == 128 and jsc.n_tris == 124
    missed = set()
    for o, d, t_max, hit in rec.calls:
        assert o.shape[0] == 64   # one lane a pixel
        args = [x.numpy() for x in (o, d, t_max)]
        np.testing.assert_array_equal(hit.prim.numpy(), closest_f64(tri[:jsc.n_tris], *args))
        j_prim = np.asarray(j_traverse.intersect_closest(jdbvh, jnp.asarray(tri),
                                                         *map(jnp.asarray, args)).prim)
        bad = np.nonzero(j_prim != hit.prim.numpy())[0]
        assert (j_prim[bad] == -1).all() and np.isin(hit.prim.numpy()[bad], [122, 123]).all()
        missed |= set(bad.tolist())
    assert sorted(missed) == HELD_APART
    keep = np.setdiff1d(np.arange(64), HELD_APART)
    np.testing.assert_allclose(got.reshape(64, 3)[keep], want.reshape(64, 3)[keep],
                               rtol=1e-5, atol=1e-6)
    assert (got.reshape(64, 3)[HELD_APART].sum(-1) > want.reshape(64, 3)[HELD_APART].sum(-1)).all()


@pytest.mark.parametrize("mis", [False, True])
def test_world_size_one_is_the_unsharded_render(mis):
    sc, dbvh, cam = port_scene()
    want = integrator.render(sc, dbvh, cam, spp=SPP, sampler="independent", device="cpu",
                             cfg=integrator.IntegratorConfig(max_depth=1, mis=mis))
    np.testing.assert_array_equal(port_render(mis=mis), want.numpy())


def test_two_processes_match_world_size_one(two_process):
    np.testing.assert_array_equal(np.load(two_process / "full.npy"), port_render())


def test_checkpoint_resumes_bit_for_bit(two_process):
    np.testing.assert_array_equal(np.load(two_process / "resumed.npy"),
                                  np.load(two_process / "full.npy"))


def test_pixel_count_must_divide_the_ranks():
    sc, dbvh, cam = port_scene()
    mesh = sharding.Mesh(3, 0, torch.device("cpu"))   # 64 pixels over 3 ranks
    with pytest.raises(ValueError, match="pixel count 64"):
        sharding.render_sharded(sc, dbvh, cam, mesh, spp=1)
    with pytest.raises(ValueError, match="process group of 1"):
        sharding.make_mesh(2, device="cpu")


def test_local_band_and_local_rows():
    assert multihost.local_band(64) == (0, 64)
    assert j_multihost.local_band(64, j_sharding.make_mesh(2)) == (0, 64)
    for rank, band in ((0, (0, 16)), (2, (32, 48)), (3, (48, 64))):
        mesh = sharding.Mesh(4, rank, torch.device("cpu"))
        assert multihost.local_band(64, mesh) == band
        rows = sharding.local_rows(torch.arange(64), mesh)
        assert (int(rows[0]), int(rows[-1]) + 1) == band
    with pytest.raises(ValueError, match="do not split"):
        sharding.local_rows(torch.arange(6), sharding.Mesh(4, 0, torch.device("cpu")))


def test_initialize_is_a_noop_for_one_process_and_needs_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize()


def test_jax_render_state_loads_in_the_port(tmp_path):
    rs = np.random.RandomState(3)
    xyz = rs.rand(64, 3).astype(np.float32)
    weight = rs.rand(64).astype(np.float32)
    mc = rs.rand(5, 3).astype(np.float32)
    ls = rs.rand(2).astype(np.float32)
    j_multihost.save_render_state(str(tmp_path / "j"), jnp.asarray(xyz), jnp.asarray(weight),
                                  7, params=(jnp.asarray(mc), jnp.asarray(ls)))
    got = multihost.load_render_state(str(tmp_path / "j"), params_template=[mc, ls])
    np.testing.assert_array_equal(got[0], xyz)
    np.testing.assert_array_equal(got[1], weight)
    assert got[2] == 7
    assert all(torch.equal(a, torch.as_tensor(b)) for a, b in zip(got[3], (mc, ls)))

    # treeNet weights: the TreeNet's state_dict order is JAX's leaf order
    j_cfg = j_treenet.TreeNetConfig(levels=3, capacity=8, pc_size=32)
    cfg = treenet.TreeNetConfig(**j_cfg._asdict())
    jp = j_treenet.init_params(j_cfg, jax.random.PRNGKey(1))
    j_multihost.save_render_state(str(tmp_path / "t"), jnp.asarray(xyz), jnp.asarray(weight),
                                  3, params=jp)
    model = treenet.init_params(cfg, seed=9, device="cpu")
    _, _, nxt, loaded = multihost.load_render_state(str(tmp_path / "t"), params_template=model)
    assert nxt == 3 and loaded is model
    for a, b in zip(model.state_dict().values(), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # and the other way round
    multihost.save_render_state(str(tmp_path / "p"), torch.as_tensor(xyz),
                                torch.as_tensor(weight), 5, params=model)
    jx, jw, jn, jparams = j_multihost.load_render_state(str(tmp_path / "p"), params_template=jp)
    np.testing.assert_array_equal(jx, xyz)
    assert jn == 5
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_render_sharded(tmp_path, monkeypatch):
    from nn_bvh_tpu_torch.cli import render
    from nn_bvh_tpu_torch.geometry import pbrt_parser
    from nn_bvh_tpu_torch.utils import image

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    f = tmp_path / "s.pbrt"
    f.write_text(PBRT)
    cli = lambda out, *extra: render.main([str(f), "--device", "cpu", "--outfile",
                                           str(tmp_path / out), *extra])
    np.testing.assert_array_equal(cli("one.pfm", "--sharded"), cli("plain.pfm"))

    outs = multihost.run_local(
        [sys.executable, "-m", "nn_bvh_tpu_torch.cli.render", str(f), "--device", "cpu",
         "--sharded", "--outfile", str(tmp_path / "two.pfm")], 2, timeout_s=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=REPO)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    assert ["wrote" in out for _, out in outs] == [True, False]
    sc, dbvh, cam, _ = pbrt_parser.load_scene(str(f))
    cfg = integrator.IntegratorConfig(max_depth=1, mis=True, kind="path", rr_depth=2,
                                      sample_lights=True)
    want = sharding.render_sharded(sc, dbvh, cam, sharding.make_mesh(device="cpu"), spp=2,
                                   sampler="independent", cfg=cfg)
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "two.pfm")), want.numpy())


def test_film_merge_matches_jax():
    rs = np.random.RandomState(4)
    parts = [[rs.rand(12, 3).astype(np.float32), rs.rand(12).astype(np.float32),
              rs.rand(12, 3).astype(np.float32)] for _ in range(3)]
    got = film.merge([film.Film(*map(torch.as_tensor, p), 3, 4) for p in parts])
    want = j_film.merge([j_film.make_film(3, 4)._replace(
        xyz=jnp.asarray(p[0]), weight=jnp.asarray(p[1]), splat_xyz=jnp.asarray(p[2]))
        for p in parts])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(a.shape))
    assert (got.height, got.width) == (3, 4)
