"""The port's image tools and CLIs against the JAX package on the CPU, on
the same inputs made from numpy seeds: every imgtool subcommand (output
files byte-equal, stdout equal; makeequiarea and makesky, whose directions
come from each package's equal_area_square_to_sphere, within 1e-6 of the
map's peak); pspec's sample sets bit-equal for each
sampler and its power spectrum within 1e-4 (rtol 1e-4 + atol 1e-4 x the
mean of P); format's re-formatting, --upgrade and --toply byte-equal on
tests/test_format.py's inputs, both reference quirks included; the tev
client's bytes equal through a local socket; the stats report strings
equal; tools/determinism on the CPU at 32x32; and the measured sensor
through whole renders: cli.render on a .pbrt file with "string sensor"
and "float whitebalance" against the JAX package's load_scene + render
with the JAX CLI's settings within tests/test_torch_render.py's
thresholds (mean within 0.5%, >= 99% of pixels within atol 1e-3 + rtol
1e-2), and VolPath's phased wave with a measured sensor against JAX's
VolPath lanes under tests/test_torch_volpath.py's lane rule. Two JAX
compiles (a Path and a VolPath wave, 16x16)."""

import json
import os
import socket
import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.cli import format as j_format, imgtool as j_imgtool, pspec as j_pspec
from nn_bvh_tpu.geometry import pbrt_parser as j_parser, scene as j_scene, transform as j_xf
from nn_bvh_tpu.utils import display as j_display, stats as j_stats
from nn_bvh_tpu.wavefront import (camera as j_camera, film as j_film,
                                  integrator as j_integrator)
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.cli import format as fmt, imgtool, pspec, render
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.tools import determinism
from nn_bvh_tpu_torch.utils import display, image, stats
from nn_bvh_tpu_torch.wavefront import camera, film, integrator, volpath

torch.set_num_threads(1)


def assert_images_match(img_j, img_t):
    """tests/test_torch_render.py's thresholds."""
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


# ---------------------------------------------------------------------------
# imgtool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Input images: HDR noise, a second one, an image with a firefly, a
    32x16 image, an equirect map with a bright band, and the G-buffer AOVs
    (normal, albedo) of a small scene with its noisy render."""
    d = tmp_path_factory.mktemp("in")
    rs = np.random.RandomState(0)
    a = (rs.rand(8, 8, 3) * 2).astype(np.float32)
    a[0, 0] = (0.0, 0.0, 0.0)  # a dark texel: makeemitters skips it
    spiky = rs.rand(32, 16, 3).astype(np.float32)
    spiky[5, 5] = 1000.0
    equi = np.zeros((32, 64, 3), np.float32)
    equi[12:20] = (1.0, 0.8, 0.6)
    imgs = {"a.pfm": a, "b.pfm": rs.rand(8, 8, 3).astype(np.float32),
            "tall.pfm": rs.rand(32, 16, 3).astype(np.float32), "spiky.pfm": spiky,
            "equi.pfm": equi}
    b = scene.SceneBuilder()
    b.add_quad((-4, -1, -4), (4, -1, -4), (4, -1, 4), (-4, -1, 4),
               b.add_material("diffuse", reflectance=(0.7, 0.6, 0.3)))
    b.add_sphere((0, 0, 1), 0.8, b.add_material("diffuse", reflectance=(0.2, 0.4, 0.8)),
                 n_theta=8, n_phi=16)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    g = integrator.render_gbuffer(sc, dbvh, camera.make_perspective(
        j_xf.look_at((0, 0.5, -3), (0, 0, 1), (0, 1, 0)), 50.0, 16, 16), device="cpu")
    imgs["nrm.pfm"] = g["ns"].numpy()
    imgs["alb.pfm"] = g["albedo"].numpy()
    imgs["noisy.pfm"] = (g["albedo"].numpy() * 0.5
                         + rs.randn(16, 16, 3).astype(np.float32) * 0.05)
    for name, img in imgs.items():
        image.write_pfm(str(d / name), img)
    image.write_exr(str(d / "a.exr"), a)
    return d


IMGTOOL = {
    "convert": ["convert", "a.pfm", "o.pfm", "--exposure", "1.5", "--scale", "0.7", "--clamp",
                "3", "--crop", "1,7,0,6", "--flipy", "--gamma", "2.2"],
    "convert_tonemap_exr": ["convert", "a.exr", "o.exr", "--tonemap", "--downsample", "1"],
    "convert_png": ["convert", "a.pfm", "o.png"],
    "convert_srgb": ["convert", "a.pfm", "o.pfm", "--colorspace", "srgb"],
    "convert_dci-p3": ["convert", "a.pfm", "o.pfm", "--colorspace", "dci-p3"],
    "convert_rec2020": ["convert", "a.pfm", "o.pfm", "--colorspace", "rec2020"],
    "convert_aces2065-1": ["convert", "a.pfm", "o.pfm", "--colorspace", "aces2065-1"],
    "cat": ["cat", "a.pfm"],
    "cat_csv": ["cat", "a.pfm", "--csv"],
    "makeemitters": ["makeemitters", "a.pfm", "--output", "o.pbrt", "--downsample", "1"],
    "makeemitters_stdout": ["makeemitters", "b.pfm"],
    "denoise": ["denoise", "noisy.pfm", "o.pfm", "--normal", "nrm.pfm", "--albedo", "alb.pfm",
                "--radius", "2"],
    "diff": ["diff", "a.pfm", "b.pfm", "--outfile", "o.pfm"],
    "info": ["info", "spiky.pfm"],
    "falsecolor": ["falsecolor", "a.pfm", "o.pfm", "--log"],
    "falsecolor_range": ["falsecolor", "a.pfm", "o.pfm", "--range", "0.1,1.5"],
    "average": ["average", "a.pfm", "b.pfm", "--output", "o.pfm"],
    "error": ["error", "a.pfm", "b.pfm", "--reference", "b.pfm"],
    "makeequiarea": ["makeequiarea", "equi.pfm", "o.pfm", "--resolution", "24"],
    "makesky": ["makesky", "o.pfm", "--resolution", "24", "--elevation", "25"],
    "assemble": ["assemble", "a.pfm:0,0", "b.pfm:8,4", "--output", "o.pfm"],
    "splitn": ["splitn", "tall.pfm", "o%d.pfm", "--n", "3"],
    "bloom": ["bloom", "spiky.pfm", "o.pfm", "--level", "100", "--width", "3"],
    "despike": ["despike", "spiky.pfm", "o.pfm", "--level", "50"],
    "whitebalance": ["whitebalance", "a.pfm", "o.pfm", "--temperature", "3000"],
}


def run_imgtool(main, argv, d, inputs, capsys):
    """main(argv) with the input files in `inputs` and outputs in d ->
    (stdout, {output name: bytes})."""
    def path(a):
        base = a.split(":")[0]
        if os.path.exists(inputs / base):
            return str(inputs / base) + a[len(base):]
        return str(d / a) if a.startswith("o") else a

    capsys.readouterr()
    main([argv[0]] + [path(a) for a in argv[1:]])
    out = capsys.readouterr().out.replace(str(inputs), "IN").replace(str(d), "OUT")
    return out, {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", list(IMGTOOL))
def test_imgtool_matches_jax(case, inputs, tmp_path, capsys):
    argv = IMGTOOL[case]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    out_j, files_j = run_imgtool(j_imgtool.main, argv, tmp_path / "j", inputs, capsys)
    out_t, files_t = run_imgtool(imgtool.main, argv, tmp_path / "t", inputs, capsys)
    assert out_t == out_j
    assert sorted(files_t) == sorted(files_j)
    assert files_t or out_t
    if argv[0] in ("makeequiarea", "makesky"):
        a, b = (image.read_pfm(str(tmp_path / s / "o.pfm")) for s in "tj")
        # 1e-6 of the map's peak: makesky's sun disk (peak ~50) amplifies a
        # last-bit difference of the two packages' directions
        np.testing.assert_allclose(a, b, atol=1e-6 * float(np.abs(b).max()), rtol=0)
        assert a.shape == (24, 24, 3) and a.max() > 0.5
        return
    for name in files_j:
        assert files_t[name] == files_j[name], name


def test_denoise_reduces_noise(inputs, tmp_path):
    """The AOV-guided denoise on render_gbuffer's normal and albedo brings
    the noisy image closer to its clean half-albedo."""
    imgtool.main(["denoise", str(inputs / "noisy.pfm"), str(tmp_path / "dn.pfm"),
                  "--normal", str(inputs / "nrm.pfm"), "--albedo", str(inputs / "alb.pfm"),
                  "--radius", "3"])
    clean = image.read_pfm(str(inputs / "alb.pfm")) * 0.5
    noisy = image.read_pfm(str(inputs / "noisy.pfm"))
    dn = image.read_pfm(str(tmp_path / "dn.pfm"))
    assert np.abs(dn - clean).mean() < 0.7 * np.abs(noisy - clean).mean()


# ---------------------------------------------------------------------------
# pspec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["independent", "stratified", "sobol", "zsobol", "pmj02",
                                  "halton"])
def test_pspec_sample_points_bit_equal(kind):
    for s in range(2):
        a = pspec.sample_points(kind, 64, s, 3)
        b = np.asarray(j_pspec.sample_points(kind, 64, s, 3))
        assert a.dtype == np.float32 and a.shape == (64, 2)
        np.testing.assert_array_equal(a, b)


def test_pspec_power_spectrum_matches_jax(capsys):
    sets = np.stack([pspec.sample_points("sobol", 128, s, 1) for s in range(4)])
    P_t = pspec.power_spectrum(sets, 33, device="cpu")
    P_j = j_pspec.power_spectrum(sets, 33)
    assert P_t.shape == (33, 33) and P_t.dtype == np.float32
    np.testing.assert_allclose(P_t, P_j, rtol=1e-4, atol=1e-4 * float(np.mean(P_j)))
    assert pspec.main(["--sampler", "sobol", "--npoints", "64", "--nsets", "2", "--res", "17",
                       "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j_pspec.main(["--sampler", "sobol", "--npoints", "64", "--nsets", "2", "--res", "17"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["sampler"] == want["sampler"]
    for k in ("low_freq_power", "high_freq_power"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

V3 = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
WorldBegin
Material "matte" "color Kd" [0.5 0.4 0.3]
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
Material "glass" "float index" [1.8] "color Kr" [1 1 1]
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
MakeNamedMaterial "m" "string type" ["matte"] "color Kd" [0.2 0.2 0.2]
MakeNamedMaterial "n" "string type" "plastic"
AttributeBegin
  Texture "t" "spectrum" "imagemap" "string mapname" "a.png"
AttributeEnd
"""


def fan(nv=130):
    """tests/test_format.py:70's 128-triangle fan, with normals and uv."""
    import math

    P, N, UV = [0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.5, 0.5]
    for i in range(nv - 1):
        a = i / (nv - 2) * math.pi
        P += [math.cos(a) / 3.0, math.sin(a) / 7.0, 0.123456789]
        N += [0.0, 0.0, 1.0]
        UV += [math.cos(a) / 9.0, math.sin(a) / 11.0]
    idx = []
    for i in range(nv - 2):
        idx += [0, i + 1, i + 2]
    return ('WorldBegin\nShape "trianglemesh" "point3 P" [ ' + " ".join(f"{x!r}" for x in P)
            + ' ] "normal N" [ ' + " ".join(map(repr, N)) + ' ] "point2 uv" [ '
            + " ".join(map(repr, UV)) + ' ] "integer indices" [ ' + " ".join(map(str, idx))
            + " ]\n")


@pytest.mark.parametrize("flags", [[], ["--upgrade"], ["--toply", "geo"],
                                   ["--upgrade", "--toply", "geo"]],
                         ids=["format", "upgrade", "toply", "upgrade_toply"])
def test_format_matches_jax(flags, tmp_path):
    outs = {}
    for name, main in (("j", j_format.main), ("t", fmt.main)):
        d = tmp_path / name
        d.mkdir()
        for src_name, src in (("v3.pbrt", V3), ("fan.pbrt", fan())):
            (d / src_name).write_text(src)
            argv = [str(d / src_name), "-o", str(d / ("out_" + src_name))]
            argv += [str(d / f) if f == "geo" else f for f in flags]
            assert main(argv) == 0
        outs[name] = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                      if p.is_file()}
    assert outs["t"] == outs["j"]
    text = outs["t"]["out_v3.pbrt"].decode()
    if "--upgrade" in flags:
        assert '"diffuse"' in text and '"dielectric"' in text and "Kr" not in text
        assert '"matte"' in text  # the bracketed type is not renamed (the quirk)
    if "--toply" in flags:
        ply = outs["t"]["geo/mesh_00000.ply"].decode()
        assert "0.123457" in ply and "0.123456789" not in ply  # %g (the quirk)


# ---------------------------------------------------------------------------
# tev display and stats
# ---------------------------------------------------------------------------

class Listener:
    """A local TCP listener that records every byte it receives."""

    def __init__(self):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.data = bytearray()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn, _ = self.srv.accept()
        with conn:
            while chunk := conn.recv(65536):
                self.data += chunk

    def close(self) -> bytes:
        self.thread.join(timeout=10)
        self.srv.close()
        assert not self.thread.is_alive(), "the client did not close its socket"
        return bytes(self.data)


def tev_session(mod, img):
    lis = Listener()
    tev = mod.TevDisplay("127.0.0.1", lis.port)
    tev.create_image("render", img.shape[1], img.shape[0])
    tev.update_image("render", img)
    tev.update_image("render", img[1:3, 2:5], x=2, y=1, channels=("R", "G", "B"))
    tev.close_image("render")
    tev.close()
    return lis.close()


def test_tev_bytes_match_jax():
    img = np.random.RandomState(6).rand(5, 7, 3).astype(np.float32)
    got, want = tev_session(display, img), tev_session(j_display, img)
    assert got == want and len(got) > 3 * 5 * 7 * 4
    # little-endian length prefix (the packet's own 4 bytes included), then
    # the CreateImage type byte
    n = int.from_bytes(got[:4], "little")
    assert got[4] == 4 and got[n + 4] == 3


def test_tev_unreachable_is_a_warning(capsys):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()
    tev = display.TevDisplay("127.0.0.1", port)
    tev.create_image("x", 2, 2)
    tev.update_image("x", np.zeros((2, 2, 3), np.float32))
    assert tev.sock is None and "tev display unavailable" in capsys.readouterr().err


def test_stats_report_matches_jax():
    """The counter store's totals (float32 sums, host numbers and device
    sums alike) print as JAX's bumped and merged counters do."""
    c_j = j_stats.make_counters(j_stats.RENDER_COUNTERS)
    assert stats.RENDER_COUNTERS == j_stats.RENDER_COUNTERS
    stats.clear()
    stats.enable(cuda=False)
    try:
        for name, amount in (("rays/camera rays", 100), ("rays/camera rays", 28.0),
                             ("rays/shadow rays", 16777217),
                             ("intersections/hits", 1234567.5),
                             ("paths/terminated by RR", 3)):
            stats.count(name, torch.tensor(amount) if isinstance(amount, float) else amount)
            c_j = j_stats.bump(c_j, name, amount)
        stats.count("paths/reached max depth", torch.ones(7, dtype=torch.bool))
        c_j = j_stats.merge(c_j, j_stats.bump(j_stats.make_counters(j_stats.RENDER_COUNTERS),
                                              "paths/reached max depth", 7))
        c_t = stats.totals(stats.collect())
    finally:
        stats.disable()
        stats.clear()
    c_t.update({k: 0.0 for k in stats.RENDER_COUNTERS if k not in c_t})
    assert stats.render_report(c_t) == j_stats.render_report(c_j)
    assert "camera rays" in stats.render_report(c_t)
    extra = {"misc": torch.tensor(2.0), "a/b": torch.tensor(1.0)}
    assert stats.render_report(extra) == j_stats.render_report(
        {k: jnp.float32(v.item()) for k, v in extra.items()})


# ---------------------------------------------------------------------------
# determinism and measured-sensor renders
# ---------------------------------------------------------------------------

def test_determinism_tool_on_cpu(capsys):
    assert determinism.main(["--res", "32", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bit_identical"] is True and out["max_abs_diff"] == 0.0
    assert out["mean"] > 0 and out["backend"] == "plain" and out["res"] == 32


SENSOR_SCENE = """
LookAt 0 2.5 -6  0 0.6 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [32] "integer yresolution" [32] "string filename" "out.exr"
  "string sensor" "canon_eos_5d_mkiv" "float whitebalance" [4500] "float iso" [200]
Sampler "sobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.22 0.25]
AttributeBegin
  Translate 0 5 0
  AreaLightSource "diffuse" "rgb L" [12 11 10] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 0 -1 1 0 -1 1 0 1 -1 0 1] "integer indices" [0 1 2 0 2 3]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh" "point3 P" [-6 0 -6 6 0 -6 6 0 6 -6 0 6] "integer indices" [0 2 1 0 3 2]
Material "diffuse" "rgb reflectance" [0.8 0.25 0.1]
Shape "sphere" "float radius" [0.8]
AttributeBegin
  Translate 1.6 0.5 0.4
  Material "conductor" "rgb reflectance" [0.3 0.6 0.9] "float roughness" [0.3]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
"""


def test_cli_measured_sensor_matches_jax(tmp_path):
    """A .pbrt file naming a measured sensor with a white balance and an
    iso renders through cli.render within the thresholds of the JAX
    package's load_scene + render with the JAX CLI's settings."""
    p = tmp_path / "s.pbrt"
    p.write_text(SENSOR_SCENE)
    img_t = render.main([str(p), "--device", "cpu", "--res", "16x16", "--outfile",
                         str(tmp_path / "o.exr")])
    sc, dbvh, cam, res = j_parser.load_scene(str(p))
    sensor = res.make_sensor()
    assert isinstance(sensor, j_film.MeasuredSensor) and sensor.imaging_ratio == 2.0
    cfg = j_integrator.IntegratorConfig(max_depth=3, mis=True, kind="path", rr_depth=2,
                                        sample_lights=True)
    img_j = np.asarray(j_integrator.render(sc, dbvh, cam._replace(width=16, height=16),
                                           spp=2, sampler="sobol", seed=0, cfg=cfg,
                                           sensor=sensor))
    assert_images_match(img_j, img_t)
    # the sensor moved the image: the same scene developed as XYZ differs
    p.write_text(SENSOR_SCENE.replace('"string sensor" "canon_eos_5d_mkiv"', ""))
    plain = render.main([str(p), "--device", "cpu", "--res", "16x16", "--outfile",
                         str(tmp_path / "p.exr")])
    assert not np.allclose(plain, img_t, rtol=1e-2)


def test_phased_volpath_measured_sensor_matches_jax():
    """VolPath's phased wave with a measured sensor (the film's scatter add
    through the curves) on tests/test_torch_volpath.py's media-free scene
    and settings (16x16, Sobol 4 spp, depth 5), held as that file holds
    VolPath against JAX: each lane's sensor RGB (spectrum_to_sensor_rgb of
    trace_wave_vol's samples in both packages) within atol 1e-3 + rtol 1e-2
    on >= 99% of lanes, the developed image's mean within 0.5% of JAX's
    film developed with the sensor; and the phased wave's film equal to the
    port's lanes added in order (1e-5)."""
    import jax
    from nn_bvh_tpu.core import samplers as j_samplers
    from nn_bvh_tpu.wavefront import volpath as j_volpath

    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    cam_m, RES, SPP = j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), 16, 4
    R = RES * RES
    vcfg = dict(kind="volpath", max_depth=5, rr_depth=2)
    js = j_film.make_measured_sensor("sony_ilce_7m3", 3200.0)
    ts = film.make_measured_sensor("sony_ilce_7m3", 3200.0)
    jcam = j_camera.make_perspective(cam_m, 45.0, RES, RES)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    jpix = jnp.arange(R, dtype=jnp.int32)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, **vcfg)
    jwave = jax.jit(lambda s: j_volpath.trace_wave_vol(sc, dbvh, jcam, jscfg, jcfg, jpix, s))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(cam_m, 45.0, RES, RES)
    tcfg = integrator.IntegratorConfig(**vcfg)
    tscfg = samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    tpix = torch.arange(R, dtype=torch.int32)
    curves_j, curves_t = jnp.asarray(js.curves), film.sensor_curves(ts, "cpu")
    wave = volpath.make_phased_wave(tsc, tbvh, tcam, tscfg, tcfg, phase_len=2, device="cpu",
                                    sensor=ts)
    jf, tf = j_film.make_film(RES, RES), film.make_film(RES, RES, "cpu")
    f_ph = film.make_film(RES, RES, "cpu")
    lane_j, lane_t = [], []
    for s in range(SPP):
        jout = jwave(jnp.int32(s))
        tout = volpath.trace_wave_vol(tsc, tbvh, tcam, tscfg, tcfg, tpix, s)
        jf = j_film.add_samples(jf, jpix, *jout[:3], filter_weight=jout[3], sequential=True,
                                sensor_curves=curves_j)
        tf = film.add_samples(tf, tpix, *tout[:3], filter_weight=tout[3], sequential=True,
                              sensor_curves=curves_t)
        lane_j.append(np.asarray(j_film.spectrum_to_sensor_rgb(*jout[:3], curves_j)))
        lane_t.append(film.spectrum_to_sensor_rgb(*tout[:3], curves_t).numpy())
        f_ph = wave(f_ph, s)
    lane_ok = np.isclose(np.concatenate(lane_t), np.concatenate(lane_j),
                         atol=1e-3, rtol=1e-2).all(-1)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    img_j = np.asarray(j_film.develop(jf, sensor=js))
    img_ph = film.develop(f_ph, sensor=ts).numpy()
    assert np.isfinite(img_ph).all() and img_ph.mean() > 0
    assert abs(img_ph.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    np.testing.assert_allclose(f_ph.xyz.numpy(), tf.xyz.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(img_ph, film.develop(tf, sensor=ts).numpy(), atol=1e-5, rtol=1e-5)
