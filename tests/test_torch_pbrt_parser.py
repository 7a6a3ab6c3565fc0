"""Scene input of the torch port against the JAX package on the CPU: the
pbrt parser (both packages parse the same files; the compiled scene tables
must be equal, integers exactly and floats within 1e-6, with the same
warnings and render settings), the PLY reader, Loop subdivision, curve
dicing and the cyHair reader, the image readers (PNG against PIL), the BVH
builders (median, native SAH) and `load_scene` (the same BVH and prim_order
through the native builder in both packages)."""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

from nn_bvh_tpu import accel as j_accel, native as j_native
from nn_bvh_tpu.accel import build as j_build
from nn_bvh_tpu.geometry import curves as j_curves, loopsubdiv as j_loop, ply as j_ply
from nn_bvh_tpu.geometry import pbrt_parser as j_parser
from nn_bvh_tpu.utils import image as j_image
from nn_bvh_tpu_torch import accel, native
from nn_bvh_tpu_torch.accel import build
from nn_bvh_tpu_torch.geometry import curves, loopsubdiv, pbrt_parser, ply, scene
from nn_bvh_tpu_torch.utils import image

KILLEROO = "/root/reference/scenes/killeroos/killeroo-simple-v4.pbrt"

_SETTINGS = ("camera_kind", "fov", "lens_radius", "focal_distance", "width", "height",
             "filename", "sampler", "spp", "integrator", "max_depth", "iso", "exposure",
             "white_balance", "sensor", "transform_times", "warnings")


def pil_image():
    """PIL's Image module, or a skip: the JAX parser reads PNG and JPEG
    textures through PIL, so only the tests whose files hold one need it."""
    return pytest.importorskip("PIL.Image")


def assert_scenes_equal(t, j):
    """Every field of the port's CompiledScene against the JAX one's."""
    for name in scene.CompiledScene._fields:
        tv, jv = getattr(t, name), getattr(j, name)
        if tv is None or jv is None:
            assert tv is None and jv is None, name
            continue
        tv, jv = np.asarray(tv), np.asarray(jv)
        assert tv.shape == jv.shape, (name, tv.shape, jv.shape)
        if np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=name)


def parse_both(path):
    """-> (port ParseResult, JAX ParseResult, port scene, JAX scene), the
    settings and scenes held equal."""
    tr, jr = pbrt_parser.parse_file(str(path)), j_parser.parse_file(str(path))
    for name in _SETTINGS:
        assert getattr(tr, name) == getattr(jr, name), name
    np.testing.assert_array_equal(tr.cam_to_world, jr.cam_to_world)
    tsc, jsc = tr.builder.build(), jr.builder.build()
    assert_scenes_equal(tsc, jsc)
    return tr, jr, tsc, jsc


SCENES = {
    "minimal": """
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [32] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.4 0.5 0.6]
  Shape "trianglemesh" "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
LightSource "point" "rgb I" [10 10 10] "point3 from" [0 3 -1]
""",
    "attribute_stack": """
Camera "perspective"
WorldBegin
Material "diffuse" "rgb reflectance" [0.9 0.1 0.1]
AttributeBegin
  Material "conductor" "float roughness" [0.2]
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
AttributeEnd
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
""",
    "instancing": """
Camera "perspective"
WorldBegin
Material "diffuse"
ObjectBegin "tri"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
ObjectEnd
ObjectInstance "tri"
Translate 5 0 0
Rotate 30 0 1 1
Scale 1 2 1
ObjectInstance "tri"
""",
    "curve": """
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
LookAt 0 0.5 -3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8] "bool twosided" true
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1 2 -1  1 2 -1  1 2 1  -1 2 1]
AttributeEnd
Material "hair" "float eta" [1.55]
Shape "curve" "string type" "flat"
  "point3 P" [0 0 0  0.05 0.33 0  -0.05 0.66 0  0 1 0]
  "float width0" [0.4] "float width1" [0.3]
Shape "curve" "string basis" "bspline" "string type" "ribbon"
  "point3 P" [0 0 0  1 0 0  2 1 0  3 1 0  4 0 0] "normal N" [0 0 1  0 1 0] "float width" [0.1]
""",
    "bilinearmesh": """
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [45]
WorldBegin
Material "diffuse" "rgb reflectance" [0.6 0.2 0.2]
Shape "bilinearmesh"
  "point3 P" [-1 0 2  1 0 2  -1 1 2  1 1.2 2]
  "integer indices" [0 1 2 3]
Shape "bilinearmesh"
  "point3 P" [-1 0 3  1 0 3  -1 1 3  1 1 3]
  "integer indices" [0 1 2 3] "point2 uv" [0 0 2 0 0 2 2 2]
""",
    "cloud": """
LookAt 0 0.5 -3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Integrator "volpath" "integer maxdepth" [6]
WorldBegin
MakeNamedMedium "puff" "string type" "cloud" "float density" [1.0]
  "rgb sigma_s" [1.5 1.5 1.5] "rgb sigma_a" [0.05 0.05 0.05]
  "point3 p0" [-1 -0.5 -1] "point3 p1" [1 1.5 1]
AttributeBegin
  Material ""
  MediumInterface "puff" ""
  Shape "trianglemesh" "point3 P" [-1 -0.5 -1  1 -0.5 -1  1 1.5 -1  -1 1.5 -1  -1 -0.5 1  1 -0.5 1  1 1.5 1  -1 1.5 1]
    "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 5 4 0 1 5  3 6 2 3 7 6  0 7 3 0 4 7  1 6 5 1 2 6]
AttributeEnd
AttributeBegin
  Translate 0 2.5 0
  AreaLightSource "diffuse" "rgb L" [10 10 10] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
""",
    "active_transform": """
LookAt 0 1 -4  0 1 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
TransformTimes 0 1
WorldBegin
AttributeBegin
ActiveTransform EndTime
Translate 1.2 0 0
ActiveTransform All
Shape "trianglemesh" "point3 P" [-0.5 0.5 0  0.5 0.5 0  0 1.5 0]
    "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
Translate 0 0 1
Shape "trianglemesh" "point3 P" [-0.5 0.5 0  0.5 0.5 0  0 1.5 0]
    "integer indices" [0 1 2]
AttributeEnd
""",
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_parsed_scene_equals_jax(tmp_path, name):
    f = tmp_path / "s.pbrt"
    f.write_text(SCENES[name])
    _, _, sc, _ = parse_both(f)
    if name == "instancing":
        assert sc.n_tris == 2
    elif name == "active_transform":
        assert sc.tri_p_end is not None
    elif name == "cloud":
        assert sc.n_media == 1 and sc.med_type.tolist() == [scene.MED_GRID]
    elif name == "curve":
        assert sc.feat_hair and sc.n_tris >= 16


def write_ply(path, verts, faces, endian="<", uvs=None, normals=None):
    fmt = {"<": "binary_little_endian", ">": "binary_big_endian"}[endian]
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals is not None else []) \
        + (["u", "v"] if uvs is not None else [])
    head = [f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n"]
    head += [f"property float {p}\n" for p in props]
    head += [f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n"]
    cols = [verts] + [a for a in (normals, uvs) if a is not None]
    body = np.concatenate(cols, 1).astype(endian + "f4").tobytes()
    for f in faces:
        body += struct.pack(endian + "B", len(f)) + np.asarray(f, endian + "i4").tobytes()
    path.write_bytes("".join(head).encode() + body)


def sphere_mesh(n_theta=6, n_phi=10):
    th, ph = np.meshgrid(np.linspace(0, np.pi, n_theta + 1), np.linspace(0, 2 * np.pi, n_phi + 1),
                         indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = lambda i, j: i * (n_phi + 1) + j
    quads = [[idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)]
             for i in range(n_theta) for j in range(n_phi)]
    return v.astype(np.float32) * 0.5, uv.astype(np.float32), quads


KITCHEN_SINK = """
LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16] "string filename" "ks.exr"
  "string sensor" "nosuchsensor"
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
PixelFilter "gaussian"
WorldBegin
LightSource "infinite" "string filename" "env.exr" "float scale" [0.5]
LightSource "spot" "point3 from" [0 4 0]
LightSource "distant" "point3 from" [0 1 0] "point3 to" [0 0 0] "rgb L" [0.3 0.3 0.3]
Texture "img" "spectrum" "imagemap" "string filename" "tex.png"
Texture "pal" "spectrum" "imagemap" "string filename" "pal.png"
Texture "pfm" "spectrum" "imagemap" "string filename" "tex.pfm"
Texture "exr" "spectrum" "imagemap" "string filename" "tex.exr"
Texture "half" "spectrum" "scale" "texture tex" "exr" "float scale" [0.5]
Texture "checks" "spectrum" "checkerboard" "float uscale" [8]
  "rgb tex1" [0.1 0.1 0.1] "rgb tex2" [0.8 0.7 0.6]
Texture "mask" "float" "imagemap" "string filename" "grey.png"
Texture "missing" "spectrum" "imagemap" "string filename" "nosuch.png"
Texture "marble" "spectrum" "marble"
MakeNamedMaterial "red" "string type" "diffuse" "rgb reflectance" [0.7 0.1 0.1]
MakeNamedMaterial "gold" "string type" "conductor" "spectrum eta" "metal-Au-eta"
  "spectrum k" "metal-Au-k" "float roughness" [0.1]
MakeNamedMaterial "blend" "string type" "mix" "string materials" ["red" "gold"]
  "texture amount" "mask"
MakeNamedMaterial "skin" "string type" "subsurface" "string name" "Skin1"
MakeNamedMaterial "bsdf" "string type" "measured" "string filename" "nosuch.bsdf"
MakeNamedMedium "puff" "string type" "cloud" "float density" [0.8] "float wispiness" [0.5]
  "rgb sigma_s" [1.5 1.5 1.5] "rgb sigma_a" [0.05 0.05 0.05]
  "point3 p0" [-1 -0.5 -1] "point3 p1" [1 1.5 1]
MakeNamedMedium "grid" "string type" "uniformgrid" "integer nx" [2] "integer ny" [2]
  "integer nz" [2] "float density" [0.1 0.2 0.3 0.4 0.5 0.6 0.7 0.8]
  "point3 p0" [2 0 2] "point3 p1" [3 1 3]
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.01 0.01 0.01]
  "rgb sigma_s" [0.1 0.1 0.1]
MakeNamedMedium "odd" "string type" "rgbgrid"
AttributeBegin
  Material "diffuse" "texture reflectance" "checks"
  Shape "trianglemesh" "point3 P" [-4 0 -4 4 0 -4 4 0 4 -4 0 4] "integer indices" [0 1 2 0 2 3]
    "point2 uv" [0 0 1 0 1 1 0 1]
AttributeEnd
AttributeBegin
  NamedMaterial "blend"
  Translate -1.5 0.5 0
  Shape "plymesh" "string filename" "mesh.ply"
AttributeEnd
AttributeBegin
  Material "coateddiffuse" "texture reflectance" "img" "float roughness" [0.05]
  Translate 1.5 0.5 0
  Shape "loopsubdiv" "integer levels" [2] "point3 P" [0 0 0 1 0 0 0 1 0 0 0 1]
    "integer indices" [0 2 1 0 1 3 0 3 2 1 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "texture reflectance" "pal"
  Shape "bilinearmesh" "point3 P" [-1 0 2  1 0 2  -1 1 2  1 1 2] "integer indices" [0 1 2 3]
  Material "dielectric" "texture reflectance" "pfm" "float eta" [1.33]
  Shape "bilinearmesh" "point3 P" [-1 0 3  1 0 3  -1 1 3  1 1.3 3] "integer indices" [0 1 2 3]
AttributeEnd
AttributeBegin
  Material "hair" "float eta" [1.55]
  Shape "curve" "string type" "flat" "point3 P" [0 0 0  0.05 0.33 0  -0.05 0.66 0  0 1 0]
    "float width0" [0.1] "float width1" [0.05]
  Shape "curve" "string basis" "bspline" "point3 P" [0 0 0  1 0 0  2 1 0  3 1 0  4 0 0]
    "float width" [0.05]
AttributeEnd
AttributeBegin
  NamedMaterial "skin"
  Translate 0 1 1
  Shape "sphere" "float radius" [0.4]
  NamedMaterial "bsdf"
  Shape "disk" "float radius" [0.3] "float height" [0.2]
  Material "diffuse" "texture reflectance" "half"
  Shape "cylinder" "float radius" [0.2] "float zmin" [-0.1] "float zmax" [0.3]
AttributeEnd
AttributeBegin
  Material ""
  MediumInterface "puff" "fog"
  Shape "trianglemesh" "point3 P" [-1 -0.5 -1  1 -0.5 -1  1 1.5 -1  -1 1.5 -1]
    "integer indices" [0 2 1 0 3 2]
  MediumInterface "grid" ""
  Shape "trianglemesh" "point3 P" [2 0 2  3 0 2  3 1 2] "integer indices" [0 1 2]
AttributeEnd
Include "inc.pbrt.gz"
ObjectBegin "tri"
  Material "diffuse" "texture reflectance" "missing"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
ObjectEnd
AttributeBegin
  Translate 2 0 -1
  ObjectInstance "tri"
  ActiveTransform EndTime
  Translate 0.3 0 0
  ActiveTransform All
  Material "diffuse" "texture reflectance" "marble"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
AttributeEnd
Shape "cone" "float radius" [1]
Attribute "shape" "float radius" [1]
MediumInterface "nosuch" ""
FooDirective "x" "float y" [1]
"""

INCLUDED = """
AttributeBegin
  AreaLightSource "diffuse" "blackbody L" [5500] "float scale" [4]
  Translate 0 4 0
  Shape "trianglemesh" "point3 P" [-1 0 -1 1 0 -1 1 0 1 -1 0 1] "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Translate 0 3 3
  Shape "sphere" "float radius" [0.2]
AttributeEnd
"""


@pytest.fixture(scope="module")
def kitchen_sink(tmp_path_factory):
    PIL = pil_image()
    d = tmp_path_factory.mktemp("ks")
    rs = np.random.RandomState(0)
    rgb = (rs.rand(20, 24, 3) * 255).astype(np.uint8)
    PIL.fromarray(rgb).save(d / "tex.png", optimize=True)
    PIL.fromarray(rgb).quantize(9).save(d / "pal.png")
    PIL.fromarray(rgb[..., 0]).save(d / "grey.png")
    image.write_pfm(str(d / "tex.pfm"), rs.rand(9, 7, 3).astype(np.float32))
    image.write_exr(str(d / "tex.exr"), (rs.rand(8, 12, 3) * 2).astype(np.float32))
    image.write_exr(str(d / "env.exr"), (rs.rand(16, 16, 3) + 0.2).astype(np.float32))
    v, uv, quads = sphere_mesh()
    write_ply(d / "mesh.ply", v, quads, ">", uvs=uv, normals=v * 2)
    with gzip.open(d / "inc.pbrt.gz", "wt") as f:
        f.write(INCLUDED)
    (d / "ks.pbrt").write_text(KITCHEN_SINK)
    return d / "ks.pbrt"


@pytest.fixture(scope="module")
def ks_parsed(kitchen_sink):
    return parse_both(kitchen_sink)


def test_kitchen_sink_equals_jax(ks_parsed):
    """Every directive and shape the parsers take, image textures from PNG
    (RGB with filters, palette, grey), PFM and EXR, a scaled texture, a
    checkerboard, a texture-driven mix, named spectra and media, an
    Include of a .gz, instancing and motion, and the warnings of what they
    skip."""
    tr, _, sc, _ = ks_parsed
    assert sc.tex_desc.shape[0] == 7  # img, pal, pfm, exr, half, checks, mask
    assert (sc.mat_params[sc.mat_type == scene.MAT_MIX, 8] < 0).all()
    assert sc.n_media == 4 and sc.feat_hair and sc.feat_subsurface and sc.n_quadrics == 4
    assert sc.tri_p_end is not None
    for w in ("light 'spot' unsupported, skipped", "shape 'cone' unsupported, skipped",
              "directive 'FooDirective' unsupported, skipped", "unknown medium 'nosuch'",
              "texture class 'marble' approximated as constant",
              "medium type 'rgbgrid' approximated as homogeneous",
              "sensor 'nosuchsensor' unknown, XYZ sensor used"):
        assert w in tr.warnings, w
    assert any(w.startswith("imagemap 'nosuch.png' unreadable") for w in tr.warnings)
    assert any(w.startswith("measured 'nosuch.bsdf' unreadable") for w in tr.warnings)
    assert tr.make_sensor() is None


def test_load_scene_same_bvh_as_jax(kitchen_sink, ks_parsed):
    """Both packages' load_scene build the same tree and triangle order
    through their native builders."""
    assert native.available() and j_native.available()
    tsc, tbvh, tcam, _ = pbrt_parser.load_scene(str(kitchen_sink))
    jsc, jbvh, jcam, _ = j_parser.load_scene(str(kitchen_sink))
    for name in ("node_lo", "node_hi", "node_meta"):
        np.testing.assert_array_equal(getattr(tbvh, name), np.asarray(getattr(jbvh, name)))
    assert tbvh.n_nodes == int(jbvh.n_nodes)
    assert_scenes_equal(tsc, jsc)
    np.testing.assert_array_equal(tcam.cam_to_world, np.asarray(jcam.cam_to_world))
    assert (tcam.fov, tcam.width, tcam.height) == (jcam.fov, jcam.width, jcam.height)
    n = tsc.n_tris
    lo, hi = build.triangle_bounds(ks_parsed[2].tri_p[:n])
    tb, jb = native.build_sah_native(lo, hi), j_native.build_sah_native(lo, hi)
    np.testing.assert_array_equal(tb.prim_order, jb.prim_order)
    assert build.sah_cost(tb) == j_build.sah_cost(jb)


@pytest.mark.parametrize("method", ["median", "lbvh", "sah_numpy", "sah_native"])
def test_build_scene_bvh_methods_equal_jax(ks_parsed, method):
    tsc, tbvh, tree = accel.build_scene_bvh(ks_parsed[2], method=method)
    jsc, jbvh, jtree = j_accel.build_scene_bvh(ks_parsed[3], method=method)
    np.testing.assert_array_equal(tree.prim_order, jtree.prim_order)
    np.testing.assert_array_equal(tbvh.node_meta, np.asarray(jbvh.node_meta))
    np.testing.assert_array_equal(tsc.tri_shade, np.asarray(jsc.tri_shade))
    assert build.sah_cost(tree) == j_build.sah_cost(jtree)


def test_median_builder_and_sah_cost_equal_jax():
    rs = np.random.RandomState(1)
    lo = (rs.rand(3000, 3) * 10).astype(np.float32)
    hi = lo + (rs.rand(3000, 3) * 0.3).astype(np.float32)
    t, j = build.build_median(lo, hi), j_build.build_median(lo, hi)
    for f in ("node_lo", "node_hi", "node_meta", "prim_order"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    np.testing.assert_array_equal(build.morton_codes(0.5 * (lo + hi), lo.min(0), hi.max(0)),
                                  j_build.morton_codes(0.5 * (lo + hi), lo.min(0), hi.max(0)))
    assert build.sah_cost(t) == j_build.sah_cost(j)
    s = build.build_sah(lo, hi)
    assert build.sah_cost(s) < build.sah_cost(t)


def test_native_fallback_without_library(monkeypatch):
    """Without the native library the SAH method falls back to the numpy
    builder (same topology and bounds)."""
    rs = np.random.RandomState(2)
    b = scene.SceneBuilder()
    m = b.add_material()
    for _ in range(5):
        b.add_sphere(rs.rand(3) * 3, 0.3, m, n_theta=6, n_phi=8)
    sc = b.build()
    _, dn, tn = accel.build_scene_bvh(sc)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _, dp, tp = accel.build_scene_bvh(sc)
    np.testing.assert_array_equal(tp.prim_order, build.build_sah(
        *build.triangle_bounds(sc.tri_p[:sc.n_tris])).prim_order)
    np.testing.assert_array_equal(dn.node_lo, dp.node_lo)
    np.testing.assert_array_equal(dn.node_meta[:, 1], dp.node_meta[:, 1])
    with pytest.raises(ValueError, match="unknown"):
        accel.build_scene_bvh(sc, method="kd")


def test_native_library_that_fails_to_load_is_rebuilt(tmp_path, monkeypatch, capsys):
    """A cached library that does not load (here a file of junk under the
    current name) is reported on stderr and rebuilt, not silently dropped."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    path = native._so_path()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, "wb") as f:
        f.write(b"not a shared library")
    lib = native._build_lib()
    assert lib is not None
    assert "cannot load" in capsys.readouterr().err
    with open(path, "rb") as f:
        assert f.read(4) == b"\x7fELF"


def test_jpeg_texture_falls_back_to_constant(tmp_path):
    """JPEG is read by the JAX parser (through PIL) and not by the port,
    which has no DCT decoder: the port warns and uses the texture's constant
    value (a recorded deviation, ROADMAP queue 3)."""
    PIL = pil_image()
    PIL.fromarray((np.random.RandomState(3).rand(8, 8, 3) * 255).astype(np.uint8)).save(
        tmp_path / "t.jpg")
    (tmp_path / "s.pbrt").write_text("""
Camera "perspective"
WorldBegin
Texture "j" "spectrum" "imagemap" "string filename" "t.jpg"
Material "diffuse" "texture reflectance" "j"
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
""")
    tr = pbrt_parser.parse_file(str(tmp_path / "s.pbrt"))
    jr = j_parser.parse_file(str(tmp_path / "s.pbrt"))
    assert "imagemap 't.jpg' unreadable (NotImplementedError), constant" in tr.warnings
    assert "texture reflectance approximated by constant" in tr.warnings
    assert not jr.warnings
    assert tr.builder.build().mat_params[0, 5] == -1
    assert jr.builder.build().mat_params[0, 5] == 0


def test_sensors_raise_or_fall_back(tmp_path):
    """A measured sensor and a white balance raise (ROADMAP queue 1, item
    8); iso and exposure make the default sensor as in JAX."""
    def parse(film):
        (tmp_path / "s.pbrt").write_text(f'Film "rgb" {film}\nCamera "perspective"\nWorldBegin\n')
        return pbrt_parser.parse_file(str(tmp_path / "s.pbrt"))

    with pytest.raises(NotImplementedError, match="item 8"):
        parse('"string sensor" "canon_eos_100d"').make_sensor()
    with pytest.raises(NotImplementedError, match="item 8"):
        parse('"float whitebalance" [5000]').make_sensor()
    s = parse('"float iso" [200] "float exposuretime" [0.5]').make_sensor()
    assert s.imaging_ratio == 1.0


def test_png_reader_matches_pil(tmp_path):
    """The port's PNG decoder against PIL's convert("RGB"): every filter
    PIL's encoder picks, palette, grey, grey + alpha, RGBA, 1-bit, and the
    repository's golden PNG."""
    PIL = pil_image()
    rs = np.random.RandomState(4)
    yy, xx = np.mgrid[0:37, 0:53]
    rgba = (rs.rand(37, 53, 4) * 255).astype(np.uint8)
    rgba[..., 0] = (xx * 4) % 256
    rgba[..., 1] = (yy * 6) % 256
    src = PIL.fromarray(rgba, "RGBA")
    for mode in ("RGB", "RGBA", "L", "LA", "1"):
        for opt in (False, True):
            p = tmp_path / f"{mode}{opt}.png"
            src.convert(mode).save(p, optimize=opt)
            ref = np.asarray(PIL.open(p).convert("RGB"), np.float32) / 255.0
            np.testing.assert_array_equal(image.read_png(str(p)), ref, err_msg=mode)
    src.convert("RGB").quantize(5).save(tmp_path / "p.png")
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "p.png")),
                                  np.asarray(PIL.open(tmp_path / "p.png").convert("RGB"),
                                             np.float32) / 255.0)
    golden = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                          "crown_firstlight_200x280_1spp.png")
    np.testing.assert_array_equal(image.read_png(golden),
                                  np.asarray(PIL.open(golden).convert("RGB"), np.float32) / 255.0)


def test_png_reader_16_bit(tmp_path):
    """16-bit samples keep all 16 bits (PIL keeps the high byte)."""
    import zlib

    v = (np.random.RandomState(5).rand(9, 11, 3) * 65535).astype(">u2")
    rows = v.reshape(9, -1).view(np.uint8).astype(np.int32)  # Sub filter, 6 bytes a pixel
    sub = (rows - np.pad(rows, ((0, 0), (6, 0)))[:, :-6]) & 255
    raw = b"".join(b"\x01" + r.astype(np.uint8).tobytes() for r in sub)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 16, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    (tmp_path / "t16.png").write_bytes(png)
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "t16.png")),
                                  v.astype(np.float32) / 65535)


@pytest.mark.parametrize("endian", ["ascii", "<", ">"])
def test_ply_equal_jax(tmp_path, endian):
    v, uv, quads = sphere_mesh()
    p = tmp_path / "m.ply"
    if endian == "ascii":
        head = (f"ply\nformat ascii 1.0\nelement vertex {len(v)}\nproperty float x\n"
                f"property float y\nproperty float z\nproperty float s\nproperty float t\n"
                f"element face {len(quads) + 1}\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        rows = [" ".join(f"{x:.6f}" for x in np.concatenate([a, b])) for a, b in zip(v, uv)]
        faces = [f"4 {' '.join(map(str, q))}" for q in quads] + ["3 0 1 2"]
        p.write_text(head + "\n".join(rows + faces) + "\n")
    else:
        write_ply(p, v, quads + [[0, 1, 2]], endian, uvs=uv, normals=v)
    t, j = ply.read_ply(str(p)), j_ply.read_ply(str(p))
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["faces"].shape == (2 * len(quads) + 1, 3)


def test_loopsubdiv_and_curves_equal_jax(tmp_path):
    rs = np.random.RandomState(6)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    for lv in (1, 3):
        for a, b in zip(loopsubdiv.subdivide(v, f, lv), j_loop.subdivide(v, f, lv)):
            np.testing.assert_array_equal(a, b)
    open_v, open_f = v[:3], f[:1]  # boundary rules
    for a, b in zip(loopsubdiv.subdivide(open_v, open_f, 2), j_loop.subdivide(open_v, open_f, 2)):
        np.testing.assert_array_equal(a, b)
    ctrl = rs.rand(7, 3).astype(np.float32)
    for kind in ("flat", "ribbon", "cylinder"):
        for basis in ("bezier", "bspline"):
            a = curves.dice_curve_spans(ctrl, 0.1, 0.05, kind, ctrl[:2] * 0 + [[0, 0, 1], [0, 1, 0]],
                                        np.array([0, 0, 5.0]), basis=basis)
            b = j_curves.dice_curve_spans(ctrl, 0.1, 0.05, kind, ctrl[:2] * 0 + [[0, 0, 1], [0, 1, 0]],
                                          np.array([0, 0, 5.0]), basis=basis)
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(curves.bspline_to_bezier(ctrl), j_curves.bspline_to_bezier(ctrl))
    path = tmp_path / "t.hair"
    pts = rs.rand(12, 3).astype("<f4")
    with open(path, "wb") as fh:
        fh.write(b"HAIR" + struct.pack("<IIII", 3, 12, 1 | 2 | 4, 3) + struct.pack("<ff", 0.1, 0.5)
                 + struct.pack("<fff", 0.2, 0.1, 0.05) + b"\0" * 88
                 + np.full(3, 3, "<u2").tobytes() + pts.tobytes()
                 + np.full(12, 0.02, "<f4").tobytes())
    for (tp, tw), (jp, jw) in zip(curves.read_cyhair(str(path)), j_curves.read_cyhair(str(path)),
                                  strict=True):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tw, jw)


def test_image_io_roundtrip_equal_jax(tmp_path):
    rs = np.random.RandomState(7)
    img = (rs.rand(6, 9, 3) * 3).astype(np.float32)
    image.write_exr(str(tmp_path / "t.exr"), img)
    j_image.write_exr(str(tmp_path / "j.exr"), img)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(image.read_exr(str(tmp_path / "t.exr")), img)
    image.write_pfm(str(tmp_path / "t.pfm"), img)
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "t.pfm")),
                                  j_image.read_pfm(str(tmp_path / "t.pfm")))
    image.write_png(str(tmp_path / "t.png"), img / 3)
    j_image.write_png(str(tmp_path / "j.png"), img / 3)
    a = image.read_png(str(tmp_path / "t.png"))
    b = image.read_png(str(tmp_path / "j.png"))
    assert np.abs(a - b).max() <= 1.0 / 255  # sRGB pow of XLA and torch, one 8-bit step
    assert image.mse(img, img * 1.1) == j_image.mse(img, img * 1.1)
    assert image.mrse(img, img * 1.1) == j_image.mrse(img, img * 1.1)


@pytest.mark.skipif(not os.path.exists(KILLEROO), reason="no reference scenes")
def test_killeroo_parses_like_jax():
    _, _, sc, _ = parse_both(KILLEROO)
    assert sc.n_tris > 50000


def test_pbrt_bench_scene_parses_like_jax(tmp_path):
    """chip_smoke phase 19's scene (bench_scene.write_pbrt_bench, here with
    a 64^2 floor texture): the bench's 52,992 sphere triangles from three
    binary PLY files, equal to the bench builder's, through both parsers."""
    from nn_bvh_tpu_torch.tools import bench_scene

    pil_image()  # the floor texture is a PNG
    paths = bench_scene.write_pbrt_bench(str(tmp_path), size=16, tex=64)
    _, _, sc, _ = parse_both(paths["bench"])
    bench = bench_scene.bench_geometry(scene.SceneBuilder())
    spheres = np.concatenate(bench._tri_p[:24])
    parsed = sc.tri_p[:len(spheres)]
    order = [i for k in range(3) for i in range(k, 24, 3)]  # three files, every third sphere
    np.testing.assert_array_equal(parsed, np.concatenate([bench._tri_p[i] for i in order]))
    assert sc.n_tris == 52992 + 2 + 2 + 256 + 64  # spheres, floor, light, loopsubdiv, curves
