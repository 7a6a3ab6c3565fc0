"""The render CLI of the torch port: `cli.render.main` on a textured .pbrt
file (an imagemap from PNG, a checkerboard, a mix whose amount is a
texture, a plymesh, a loopsubdiv shape and curves) on the CPU, against the
JAX package's `load_scene` + `integrator.render` of the same file with the
JAX CLI's settings, within tests/test_torch_render.py's thresholds (image
mean within 0.5%, >= 99% of pixels within atol 1e-3 + rtol 1e-2). Both
packages build the same tables and BVH from the file (the native builder).
Also: the written EXR, PFM and PNG read back, the port's EXR reader on the
repository's golden EXRs, every other integrator (randomwalk, ao,
lightpath, bdpt, mlt) and --pixelstats through the CLI (finite images and
PNGs that read back; sppm renders as Path), the flags that are not ported
yet, and the CLI with JAX blocked. One JAX Path wave is compiled (16x16, 2
spp, depth 2)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nn_bvh_tpu.geometry import pbrt_parser as j_parser
from nn_bvh_tpu.utils import exr as j_exr
from nn_bvh_tpu.wavefront import integrator as j_integrator
from nn_bvh_tpu_torch.cli import render
from nn_bvh_tpu_torch.core import colorspace
from nn_bvh_tpu_torch.utils import exr, image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP = 2

SCENE = """
LookAt 0 2.5 -6  0 0.6 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [64] "integer yresolution" [48] "string filename" "out.exr"
Sampler "sobol" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.22 0.25]
Texture "wood" "spectrum" "imagemap" "string filename" "floor.png"
Texture "checks" "spectrum" "checkerboard" "float uscale" [6]
  "rgb tex1" [0.1 0.15 0.6] "rgb tex2" [0.9 0.85 0.3]
Texture "mask" "float" "imagemap" "string filename" "mask.png"
MakeNamedMaterial "red" "string type" "diffuse" "rgb reflectance" [0.75 0.15 0.1]
MakeNamedMaterial "metal" "string type" "conductor" "rgb reflectance" [0.9 0.8 0.6]
  "float roughness" [0.2]
MakeNamedMaterial "blend" "string type" "mix" "string materials" ["red" "metal"]
  "texture amount" "mask"
AttributeBegin
  Translate 0 5 0
  AreaLightSource "diffuse" "rgb L" [12 11 10] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 0 -1 1 0 -1 1 0 1 -1 0 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "texture reflectance" "wood"
  Shape "trianglemesh" "point3 P" [-6 0 -6 6 0 -6 6 0 6 -6 0 6] "integer indices" [0 2 1 0 3 2]
    "point2 uv" [0 0 3 0 3 3 0 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "texture reflectance" "checks"
  Translate -1.3 0.8 0
  Shape "plymesh" "string filename" "ball.ply"
AttributeEnd
AttributeBegin
  NamedMaterial "blend"
  Translate 1.2 0.1 -0.5
  Scale 1.4 1.4 1.4
  Shape "loopsubdiv" "integer levels" [3] "point3 P" [0 0 0 1 0 0 0 1 0 0 0 1]
    "integer indices" [0 2 1 0 1 3 0 3 2 1 2 3]
    "point2 uv" [0 0 1 0 0 1 1 1]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.3 0.6 0.3]
  Translate 0 0 -1.5
  Shape "curve" "string type" "flat" "point3 P" [0 0 0  0.1 0.5 0  -0.1 1.0 0  0 1.5 0]
    "float width0" [0.12] "float width1" [0.04]
  Shape "curve" "string type" "flat" "point3 P" [0.4 0 0  0.5 0.5 0.1  0.3 1.0 0  0.4 1.3 0]
    "float width" [0.08]
AttributeEnd
"""


def write_ply(path, n_theta=10, n_phi=16):
    th, ph = np.meshgrid(np.linspace(0, np.pi, n_theta + 1), np.linspace(0, 2 * np.pi, n_phi + 1),
                         indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = lambda i, j: i * (n_phi + 1) + j
    quads = [[idx(i, j), idx(i, j + 1), idx(i + 1, j + 1), idx(i + 1, j)]
             for i in range(n_theta) for j in range(n_phi)]
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
            + "".join(f"property float {p}\n" for p in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
            + f"element face {len(quads)}\nproperty list uchar int vertex_indices\nend_header\n")
    body = np.concatenate([v * 0.7, v, uv], 1).astype("<f4").tobytes()
    body += b"".join(np.uint8(4).tobytes() + np.asarray(q, "<i4").tobytes() for q in quads)
    path.write_bytes(head.encode() + body)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    grain = 0.5 + 0.5 * np.sin(40 * xx + 6 * np.sin(9 * yy))
    floor = np.stack([0.55 * grain + 0.2, 0.35 * grain + 0.12, 0.15 * grain + 0.05], -1)
    image.write_png(str(d / "floor.png"), floor.astype(np.float32))
    image.write_png(str(d / "mask.png"), rs.rand(16, 16, 3).astype(np.float32))
    write_ply(d / "ball.ply")
    (d / "scene.pbrt").write_text(SCENE)
    return d / "scene.pbrt"


def cli(scene, out, *extra):
    return render.main([str(scene), "--device", "cpu", "--res", f"{W}x{H}", "--spp", str(SPP),
                        "--maxdepth", "2", "--outfile", str(out), *extra])


@pytest.fixture(scope="module")
def images(scene_file, tmp_path_factory):
    pytest.importorskip("PIL.Image")  # the JAX parser reads the PNG textures through PIL
    out = tmp_path_factory.mktemp("out") / "img.exr"
    img_t = cli(scene_file, out, "--stats")
    sc, dbvh, cam, res = j_parser.load_scene(str(scene_file))
    cam = cam._replace(width=W, height=H)
    cfg = j_integrator.IntegratorConfig(max_depth=2, mis=True, kind="path", rr_depth=2,
                                        sample_lights=True)
    img_j = np.asarray(j_integrator.render(sc, dbvh, cam, spp=SPP, sampler="sobol", seed=0,
                                           cfg=cfg, sensor=res.make_sensor()))
    return img_t, img_j, out, sc


def test_cli_image_matches_jax(images):
    img_t, img_j, _, sc = images
    assert sc.tex_atlas.shape[0] > 1 and sc.feat_mix
    assert img_t.shape == img_j.shape == (H, W, 3) and img_t.dtype == np.float32
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


def test_written_images_read_back(images, scene_file, tmp_path):
    img_t, _, exr_out, _ = images
    np.testing.assert_array_equal(image.read_exr(str(exr_out)), img_t)
    pfm = cli(scene_file, tmp_path / "img.pfm")
    np.testing.assert_array_equal(pfm, img_t)  # same seed, same image
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "img.pfm")), img_t)
    png = cli(scene_file, tmp_path / "img.png")
    enc = colorspace.srgb_encode(torch.from_numpy(png)).numpy()
    want = (np.clip(enc, 0, 1) * 255 + 0.5).astype(np.uint8).astype(np.float32) / 255.0
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "img.png")), want)


def test_stats_partial_images_and_mse(scene_file, tmp_path, capsys):
    ref = tmp_path / "ref.pfm"
    out = tmp_path / "q.exr"
    img = render.main([str(scene_file), "--device", "cpu", "--quick", "--spp", "4",
                       "--maxdepth", "1", "--outfile", str(out), "--stats",
                       "--write-partial-images"])
    assert img.shape == (12, 16, 3)  # the film's 64x48 at a quarter
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("parse_s", "atlas_pack_s", "bvh_s", "render_s", "rays_per_s", "atlas_mib",
                "rays_live_per_s"):
        assert stats[key] >= 0, key
    assert 1.0 <= stats["dist_avg_path_length"] <= 2.0  # depth 1: a camera segment and one more
    assert stats["spp"] == 1 and stats["tris"] > 100
    assert os.path.exists(str(out) + ".partial.pfm")
    image.write_pfm(str(ref), img)
    render.main([str(scene_file), "--device", "cpu", "--quick", "--spp", "4", "--maxdepth", "1",
                 "--outfile", str(tmp_path / "q2.exr"), "--mse-reference-image", str(ref)])
    err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert err == {"mse": 0.0, "mrse": 0.0}


@pytest.mark.parametrize("flags, item", [
    (["--sharded"], "item 7"), (["--display-server", "localhost:14158"], "item 5")])
def test_unported_flags_raise(scene_file, tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli(scene_file, tmp_path / "x.exr", *flags)


@pytest.mark.parametrize("flags", [
    ["--pixelstats", "PREFIX"], ["--integrator", "bdpt"], ["--integrator", "mlt"],
    ["--integrator", "lightpath"], ["--integrator", "randomwalk"], ["--integrator", "ao"]],
    ids=["pixelstats", "bdpt", "mlt", "lightpath", "randomwalk", "ao"])
def test_other_integrators_and_pixelstats_render(scene_file, tmp_path, capsys, flags):
    """Each integrator the JAX CLI renders besides Path and VolPath, and
    --pixelstats, through the port's CLI on the CPU: a finite image with
    light in it, written and read back; --pixelstats' four PNGs read back
    and its totals line counts bounces."""
    flags = [f.replace("PREFIX", str(tmp_path / "ps")) for f in flags]
    out = tmp_path / "x.exr"
    img = cli(scene_file, out, *flags)
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_array_equal(image.read_exr(str(out)), img)
    if flags[0] == "--pixelstats":
        totals = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert totals["stats/bounces"] >= W * H * 2 and totals["stats/shadow_rays"] > 0
        for name in ("bounces", "shadow_rays", "hits", "rr_terms"):
            png = image.read_png(str(tmp_path / f"ps-{name}.png"))
            assert png.shape == (H, W, 3) and np.isfinite(png).all()
        assert image.read_png(str(tmp_path / "ps-bounces.png")).max() == 1.0


def test_sppm_renders_as_path(scene_file, tmp_path):
    """As in the JAX CLI, an sppm (or function) scene renders as Path."""
    np.testing.assert_array_equal(cli(scene_file, tmp_path / "s.exr", "--integrator", "sppm"),
                                  cli(scene_file, tmp_path / "p.exr", "--integrator", "path"))


def test_runs_on_the_card_by_default(scene_file, tmp_path, monkeypatch):
    """Without --device the CLI asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        render.main([str(scene_file), "--outfile", str(tmp_path / "x.exr")])


def test_cli_renders_with_jax_blocked(scene_file, tmp_path):
    code = ("import sys; sys.modules['jax'] = None; sys.modules['nn_bvh_tpu'] = None\n"
            "from nn_bvh_tpu_torch.cli import render\n"
            f"img = render.main([{str(scene_file)!r}, '--device', 'cpu', '--res', '8x8', "
            f"'--spp', '1', '--maxdepth', '1', '--outfile', {str(tmp_path / 'b.exr')!r}])\n"
            "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
            "print('OK', sorted(m for m in sys.modules if m.startswith('jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK ['jax']" in out.stdout


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "data", "golden"))
                                        if f.endswith(".exr")))
def test_exr_reader_on_golden_images(name):
    path = os.path.join(REPO, "data", "golden", name)
    t, j = exr.read_rgb(path), j_exr.read_rgb(path)
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(image.read_exr(path), j)
