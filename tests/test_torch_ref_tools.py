"""The port's reference-bound tools (nn_bvh_tpu_torch/tools/: crown_gate,
crown_grad, probe_material, probe_motion, extract_named_spectra, and
wave_kernels --stages) on the CPU. The crown scene and the pbrt-v4 binary
are not in the repository, so the tools are held on what is:

- crown_gate's printed gate numbers on the committed EXRs equal the JAX
  tool's (tools/crown_gate.py) line for line; a pass copies to the port's
  own artifact and never to data/golden/crown-ours-volpath-250x350-64spp.exr;
- crown_grad's check on the bench configuration written as .pbrt
  (bench_scene.write_pbrt_bench at 32x32 with a 64^2 texture), film 16x16,
  the paint material (the mix's diffuse side): AD within 2% of central
  differences, the gradient not zero; and (`slow`, its JAX anchor takes
  ~290 s) at 64x64 on the full bench .pbrt with Russian roulette, where
  both packages read ~6%, the port's AD and central differences against
  the JAX tool's arithmetic;
- the probes: the JAX tools' arguments, presets and scene text, a clear
  error without the reference binary, and a whole run against a stand-in
  reference binary that writes a constant EXR;
- extract_named_spectra on a synthetic spectrum.cpp: the JAX tool's dict;
- wave_kernels' stages: tools/perf/wave_ablate.py's seven runs, each a
  valid wave on the CPU.
"""

import ast
import contextlib
import importlib.util
import io
import os
import re
import stat
import sys

import numpy as np
import pytest
import torch

from nn_bvh_tpu_torch.tools import (bench_scene, crown_gate, crown_grad, extract_named_spectra,
                                    probe_material, probe_motion, wave_kernels)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_OURS = os.path.join(REPO, "data", "golden", "crown-ours-volpath-250x350-64spp.exr")


def jax_tool(rel: str):
    """A module of the JAX package's tools/, loaded by path."""
    path = os.path.join(REPO, rel)
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(main, argv, monkeypatch=None, prog="tool"):
    """main() (sys.argv-reading when monkeypatch is given, else main(argv))
    -> (return value or SystemExit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            if monkeypatch is not None:
                monkeypatch.setattr(sys, "argv", [prog, *argv])
                rc = main()
            else:
                rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def options(main, monkeypatch=None) -> set:
    rc, text = run_main(main, ["--help"], monkeypatch)
    assert rc == 0
    return set(re.findall(r"(--[a-z][a-z-]*)", text))


def test_crown_gate_numbers_equal_jax(tmp_path, monkeypatch):
    before = open(JAX_OURS, "rb").read()
    j = jax_tool("tools/crown_gate.py")
    monkeypatch.setattr(j, "OURS_TMP", JAX_OURS)
    j_rc, j_out = run_main(j.main, ["--use-existing", "--no-copy"], monkeypatch)
    rc, out = run_main(crown_gate.main, ["--use-existing", "--no-copy", "--ours", JAX_OURS])
    assert (rc, out) == (j_rc, j_out) and "GATE: PASS" in out
    # a pass copies to the port's artifact only
    port_copy = tmp_path / "golden_torch" / "ours.exr"
    monkeypatch.setattr(crown_gate, "OURS_PORT", str(port_copy))
    rc, out = run_main(crown_gate.main, ["--use-existing", "--ours", JAX_OURS])
    assert rc == 0 and open(port_copy, "rb").read() == before
    assert open(JAX_OURS, "rb").read() == before
    # a changed render fails the gate
    dark = tmp_path / "dark.exr"
    from nn_bvh_tpu_torch.utils import exr, image
    image.write_exr(str(dark), exr.read_rgb(JAX_OURS) * 0.5)
    assert run_main(crown_gate.main, ["--use-existing", "--no-copy", "--ours", str(dark)])[0] == 1
    # options: the JAX tool's and the paths it fixed
    assert options(crown_gate.main) - options(j.main, monkeypatch) == {"--ours", "--scene"}
    with pytest.raises(SystemExit, match="stage the crown"):
        crown_gate.main(["--scene", str(tmp_path / "none.pbrt"), "--ours", str(tmp_path / "x.exr")])


def test_crown_gate_port_artifact_path():
    assert crown_gate.OURS_PORT.endswith(os.path.join(
        "data", "golden_torch", "crown-ours-torch-volpath-250x350-64spp.exr"))
    assert os.path.abspath(crown_gate.OURS_PORT) != os.path.abspath(JAX_OURS)


def test_crown_grad_on_the_bench_scene(tmp_path):
    paths = bench_scene.write_pbrt_bench(str(tmp_path), size=32, tex=64)
    out = crown_grad.grad_check(paths["bench"], res=16, device="cpu", mat_id=0)
    assert out["metric"] == "crown_grad_vs_fd_rel_err" and out["mat_id"] == 0
    assert max(abs(x) for x in out["grad_fd"]) > 1e-4, out
    assert out["value"] < crown_grad.GATE, out
    if not os.path.exists(crown_grad.STAGED):
        with pytest.raises(SystemExit, match="stage the crown"):
            crown_grad.main()


def jax_grad_check(scene_file: str, res: int, mat_id: int) -> dict:
    """tools/crown_grad.py's arithmetic in the JAX package (Path, MIS, no
    early exit, the independent sampler at seed 7 and 2 spp, the
    integrator's Russian roulette, eps 3e-2, the ray sort on) on any .pbrt
    file and material."""
    import jax
    import jax.numpy as jnp
    from nn_bvh_tpu.accel import dispatch
    from nn_bvh_tpu.core import samplers
    from nn_bvh_tpu.geometry import pbrt_parser
    from nn_bvh_tpu.scatter import lightsamplers
    from nn_bvh_tpu.wavefront import integrator

    sc, dbvh, cam, _ = pbrt_parser.load_scene(scene_file)
    cam = cam._replace(width=res, height=res)
    cfg = integrator.IntegratorConfig(max_depth=4, mis=True, kind="path", early_exit=False,
                                      sample_lights=True)
    sampler_cfg = samplers.make_sampler("independent", seed=7, spp=2)
    ls = lightsamplers.build(sc, cfg.light_sampler)
    isect = dispatch.make_intersectors(sc, dbvh, sort=True)
    scd, dbvhd, lsd = jax.tree.map(jnp.asarray, (sc, dbvh, ls))
    pixel_idx = jnp.arange(res * res, dtype=jnp.int32)

    def crop_mean(coeffs, tables, scd, dbvhd, lsd):
        s2 = scd.replace(mat_coeffs=coeffs)
        bi = isect.bind(tables)
        total = jnp.float32(0.0)
        for s in range(2):
            L = integrator.trace_wave(s2, dbvhd, cam, sampler_cfg, cfg, pixel_idx,
                                      jnp.int32(s), lsd, bi)[0]
            total = total + jnp.mean(L)
        return total / 2.0

    f, g = jax.jit(crop_mean), jax.jit(jax.grad(crop_mean))
    coeffs0 = jnp.asarray(sc.mat_coeffs)
    grad = np.asarray(g(coeffs0, isect.tables, scd, dbvhd, lsd))[mat_id]
    eps = 3e-2
    fd = np.zeros(3, np.float64)
    for c in range(3):
        dv = np.zeros_like(np.asarray(coeffs0))
        dv[mat_id, c] = eps
        fd[c] = (float(f(coeffs0 + dv, isect.tables, scd, dbvhd, lsd))
                 - float(f(coeffs0 - dv, isect.tables, scd, dbvhd, lsd))) / (2 * eps)
    rel = float(np.abs(grad - fd).max() / max(np.abs(fd).max(), 1e-12))
    return {"grad_ad": grad.tolist(), "grad_fd": fd.tolist(), "value": rel}


@pytest.mark.slow   # the JAX anchor: ~290 s of compile and render on the CPU
def test_crown_grad_with_roulette_reads_as_jax(tmp_path):
    """With the integrator's Russian roulette, central differences see the
    jumps of a lane's survival and the check reads ~6% at 64x64 on the
    bench .pbrt (chip_smoke 22.7). The JAX package's arithmetic reads the
    same on the same scene, film, seed and material, so the gap is the
    estimator's, not a fault of the port's gradient through the roulette
    branch: both AD gradients and both central differences agree within
    rtol 1e-3, the relative errors within 1e-4 (measured: 5.5e-4 and
    1.0e-5)."""
    paths = bench_scene.write_pbrt_bench(str(tmp_path))
    port = crown_grad.grad_check(paths["bench"], res=64, device="cpu", mat_id=0)
    want = jax_grad_check(paths["bench"], res=64, mat_id=0)
    print("port", port, "jax", want)
    np.testing.assert_allclose(port["grad_ad"], want["grad_ad"], rtol=1e-3)
    np.testing.assert_allclose(port["grad_fd"], want["grad_fd"], rtol=1e-3)
    assert abs(port["value"] - want["value"]) < 1e-4
    assert port["value"] > crown_grad.GATE and want["value"] > crown_grad.GATE


def test_probe_tools_keep_the_jax_tools_arguments_and_scenes(monkeypatch):
    jm = jax_tool("tools/probe_material.py")
    assert probe_material.PRESETS == jm.PRESETS
    assert (probe_material.SCENE, probe_material.SCENE_TEX) == (jm.SCENE, jm.SCENE_TEX)
    assert options(probe_material.main) - options(jm.main, monkeypatch) == {"--device"}
    jn = jax_tool("tools/probe_motion.py")
    assert probe_motion.SCENE == jn.SCENE
    assert options(probe_motion.main) - options(jn.main, monkeypatch) == {"--pbrt", "--device"}


@pytest.mark.parametrize("tool", [probe_material, probe_motion])
def test_probes_fail_clearly_without_the_reference_binary(tool, tmp_path):
    with pytest.raises(SystemExit, match="does not exist"):
        tool.main(["--pbrt", str(tmp_path / "pbrt"), "--device", "cpu"])


STAND_IN = """#!{python}
# a stand-in for the pbrt binary: a constant 0.5 image at the Film's size and name
import os, re, sys
sys.path.insert(0, {repo!r})
import numpy as np
from nn_bvh_tpu_torch.utils import image
text = open(sys.argv[-1]).read()
res = [int(x) for x in re.findall(r'"integer [xy]resolution" \\[ *(\\d+) *\\]', text)]
name = re.search(r'"string filename" \\[? *"([^"]+)"', text).group(1)
image.write_exr(name, np.full((res[1], res[0], 3), 0.5, np.float32))
"""


@pytest.fixture
def stand_in(tmp_path):
    p = tmp_path / "pbrt"
    p.write_text(STAND_IN.format(python=sys.executable, repo=REPO))
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


def test_probe_material_runs_against_a_stand_in(stand_in):
    rc, out = run_main(probe_material.main, ["--pbrt", stand_in, "--preset", "diffuse",
                                             "--res", "16", "--spp", "1", "--maxdepth", "1",
                                             "--device", "cpu"])
    assert rc == 0
    rows = dict(re.findall(r"^([a-z-]+): ref=0\.50000 ours=([0-9.]+) rel=", out, re.M))
    assert sorted(rows) == ["corner-bg", "scene-mean", "sphere-crop"]
    assert 0 < float(rows["sphere-crop"]) < 1
    # the stats: ref means, ours means and (ours - ref) / ref
    ref = np.full((16, 16, 3), 0.5, np.float32)
    ours = ref * np.linspace(0.5, 1.5, 16, dtype=np.float32)[:, None, None]
    st = probe_material.rel_stats(ref, ours)
    np.testing.assert_allclose(st["scene-mean"], (0.5, ours.mean(), ours.mean() / 0.5 - 1),
                               rtol=1e-6)
    np.testing.assert_allclose(st["sphere-crop"][1], ours[4:-4, 4:-4].mean(), rtol=1e-6)


def test_probe_motion_runs_against_a_stand_in(stand_in):
    rc, out = run_main(probe_motion.main, ["--pbrt", stand_in, "--res", "16", "--spp", "2",
                                           "--device", "cpu"])
    assert rc == 1 and out.rstrip().endswith("FAIL")  # a constant image is no reference
    assert re.search(r"scene mean: ref 0\.50000 ours [0-9.]+ rel", out)
    ref = np.full((16, 16, 3), 0.5, np.float32)
    assert probe_motion.motion_stats(ref, ref * 1.02)["ok"]
    s = probe_motion.motion_stats(ref, ref * 1.2)
    assert not s["ok"]
    np.testing.assert_allclose((s["scene_rel"], s["block_median"], s["block_p90"]), 0.2,
                               rtol=1e-5)


SPECTRUM_CPP = """
namespace {
const Float Au_eta[] = {
    400.0, 1.658,  // comment
    500.0, 0.97,
    600.0, .2499f};
const Float Au_k[] = {400.0, 1.956, 500.0, 1.87, 600.0, 2.99};
const Float CIE_Illum_D65[] = {300, 0.0341, 400, 82.75, 500, 109.35};
const Float glass_BK7[] = {300, 1.5, 700, 1.49e0};
}
Spectrum illumd65 = PiecewiseLinearSpectrum::FromInterleaved(CIE_Illum_D65, true, alloc);
Spectrum auEta =
    PiecewiseLinearSpectrum::FromInterleaved(Au_eta, false, alloc);
namedSpectra = {
    {"metal-Au-eta", auEta},
    {"metal-Au-k", PiecewiseLinearSpectrum::FromInterleaved(Au_k, false, alloc)},
    {"stdillum-D65", illumd65},
    {"glass-BK7", PiecewiseLinearSpectrum::FromInterleaved(glass_BK7, false, alloc)},
    {"missing-var", notDefined},
};
"""


def test_extract_named_spectra_matches_jax(tmp_path):
    src = tmp_path / "spectrum.cpp"
    src.write_text(SPECTRUM_CPP)
    j = jax_tool("tools/extract_named_spectra.py")
    with contextlib.redirect_stdout(io.StringIO()):
        got, want = extract_named_spectra.extract(str(src)), j.extract(str(src))
    assert sorted(got) == sorted(want) == ["__normalize__", "glass-BK7", "metal-Au-eta",
                                           "metal-Au-k", "stdillum-D65"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["__normalize__"]) == ["stdillum-D65"]
    np.testing.assert_array_equal(got["metal-Au-eta"][:, 1], np.float32([1.658, 0.97, 0.2499]))
    with pytest.raises(SystemExit, match="REFERENCE_ROOT"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["extract_named_spectra"])
            extract_named_spectra.main()


def test_wave_kernels_stages_are_wave_ablates_runs():
    tree = ast.parse(open(os.path.join(REPO, "tools", "perf", "wave_ablate.py")).read())
    runs = [(c.args[0].value, {k.arg: ast.literal_eval(k.value) for k in c.keywords})
            for c in ast.walk(tree) if isinstance(c, ast.Call)
            and getattr(c.func, "id", None) == "run"]
    assert runs == wave_kernels.STAGES and len(runs) == 7

    from nn_bvh_tpu_torch.core import samplers
    from nn_bvh_tpu_torch.wavefront import film, integrator

    sc, dbvh, _ = bench_scene.build_bench_scene()
    cam = bench_scene.bench_camera(8)
    scfg = samplers.make_sampler("sobol", seed=0, spp=16)
    for label, kw in wave_kernels.STAGES:
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, integrator.IntegratorConfig(**kw),
                                       device="cpu")
        xyz = wave(film.make_film(8, 8, "cpu"), 0).xyz
        assert bool(torch.isfinite(xyz).all()), label
    assert wave_kernels.main(["--stages"]) == 1  # no card here
