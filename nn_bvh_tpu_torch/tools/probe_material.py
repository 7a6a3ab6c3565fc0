"""Single-material probe renders: the port against the pbrt-v4 CPU binary
(port of tools/probe_material.py).

Renders a one-sphere scene with a given Material line under a uniform
infinite light (or, with --textured IMG, a receding textured plane: the
minification filter against the reference MIPMap) with both renderers
and prints the scene mean, a center crop and a background corner of each,
with the relative error. The presets are the crown materials that were
parity suspects.

Usage:
    python -m nn_bvh_tpu_torch.tools.probe_material --preset crown-red
    python -m nn_bvh_tpu_torch.tools.probe_material --mat 'Material "coateddiffuse" ...'
        [--textured IMG] [--res 96] [--spp 64] [--maxdepth 5] [--shape LINE]
        [--pbrt /tmp/refbuild/pbrt] [--keep] [--device cuda|cpu]

The reference binary (--pbrt, built by tools/refbuild) must exist; the
port's side renders on the card unless --device cpu. The refbuild binary
reads no PNG, so a PNG texture is decoded (the port's reader), sRGB-decoded
and written as PFM for both renderers; JPEG is not read.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

PRESETS = {
    # the crown materials named in the r3 close-out as parity suspects
    "crown-red": 'Material "coateddiffuse" "rgb reflectance" [ 0.6 0.025 0.025 ] "float roughness" [ 0.010408 ]',
    "crown-enamel": 'Material "coateddiffuse" "rgb reflectance" [ 0.8 0.8 0.8 ] "float roughness" [ 0.10408 ]',
    "crown-velvet": 'Material "coateddiffuse" "rgb reflectance" [ 0.15 0.0015 0.0015 ] "float roughness" [ 0.2 ]',
    "crown-pearl": 'Material "coateddiffuse" "rgb reflectance" [ 0.65 0.6 0.6 ] "float vroughness" [ 0.001 ] "float uroughness" [ 0.001 ]',
    "white-coated": 'Material "coateddiffuse" "rgb reflectance" [ 1 1 1 ] "float roughness" [ 0.1 ]',
    "diffuse": 'Material "diffuse" "rgb reflectance" [ 0.6 0.025 0.025 ]',
    "gem": 'Material "dielectric" "float eta" [ 3.0 ]',
    "gold": 'Material "conductor" "spectrum eta" [ "metal-Au-eta" ] "spectrum k" [ "metal-Au-k" ] "float roughness" [ 0.1 ]',
}

SCENE = """Integrator "path" "integer maxdepth" [ {maxdepth} ]
Sampler "halton" "integer pixelsamples" [ {spp} ]
Film "rgb" "integer xresolution" [ {res} ] "integer yresolution" [ {res} ]
    "string filename" [ "{out}" ]
LookAt 0 0 4   0 0 0   0 1 0
Camera "perspective" "float fov" [ 30 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
{mat}
{shape}
"""


SCENE_TEX = """Integrator "path" "integer maxdepth" [ {maxdepth} ]
Sampler "halton" "integer pixelsamples" [ {spp} ]
Film "rgb" "integer xresolution" [ {res} ] "integer yresolution" [ {res} ]
    "string filename" [ "{out}" ]
LookAt 0 1.0 0   0 0.85 4   0 1 0
Camera "perspective" "float fov" [ 40 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
Texture "probe-tex" "spectrum" "imagemap" "string filename" [ "{texfile}" ]
Material "diffuse" "texture reflectance" [ "probe-tex" ]
Shape "trianglemesh"
    "integer indices" [ 0 1 2  0 2 3 ]
    "point3 P" [ -20 0 0   20 0 0   20 0 120   -20 0 120 ]
    "point2 uv" [ 0 0  40 0  40 120  0 120 ]
"""


def rel_stats(ref: np.ndarray, ours: np.ndarray) -> dict:
    """(ref mean, ours mean, (ours - ref) / ref) of the scene, the center
    crop (a quarter margin) and the 8x8 background corner."""
    c = ref.shape[0] // 4
    out = {}
    for name, a, b in (("scene-mean", ref, ours), ("sphere-crop", ref[c:-c, c:-c], ours[c:-c, c:-c]),
                       ("corner-bg", ref[:8, :8], ours[:8, :8])):
        m = float(np.mean(a)), float(np.mean(b))
        out[name] = (m[0], m[1], (m[1] - m[0]) / max(m[0], 1e-9))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mat", help="pbrt Material line")
    ap.add_argument("--textured", metavar="IMG",
                    help="textured receding-plane probe (minification filter parity vs the "
                         "reference MIPMap) with this image")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--maxdepth", type=int, default=5)
    ap.add_argument("--shape", default='Shape "sphere" "float radius" [ 1 ]',
                    help="pbrt Shape line (quadric parity probes)")
    ap.add_argument("--pbrt", default="/tmp/refbuild/pbrt")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not os.path.exists(args.pbrt):
        raise SystemExit(f"probe_material: the reference binary {args.pbrt} does not exist; "
                         "build it with tools/refbuild or pass --pbrt")
    mat = args.mat or PRESETS[args.preset or "crown-red"]

    from ..utils import exr as exr_mod, image as image_mod

    tmp = tempfile.mkdtemp(prefix="probe_")
    ref_out = os.path.join(tmp, "ref.exr")
    scene_path = os.path.join(tmp, "probe.pbrt")
    with open(scene_path, "w") as f:
        if args.textured:
            texfile = os.path.abspath(args.textured)
            if texfile.endswith(".png"):
                # the refbuild pbrt reads no PNG: linear (sRGB-decoded) PFM for both
                raw = image_mod.read_png(texfile)
                lin = np.where(raw <= 0.04045, raw / 12.92, ((raw + 0.055) / 1.055) ** 2.4)
                texfile = os.path.join(tmp, "tex.pfm")
                image_mod.write_pfm(texfile, lin.astype(np.float32))
            elif texfile.endswith((".jpg", ".jpeg")):
                raise SystemExit(f"probe_material: {texfile}: JPEG is not read; convert it "
                                 "to PNG or PFM")
            f.write(SCENE_TEX.format(texfile=texfile, res=args.res, spp=args.spp,
                                     maxdepth=args.maxdepth, out=ref_out))
        else:
            f.write(SCENE.format(mat=mat, shape=args.shape, res=args.res, spp=args.spp,
                                 maxdepth=args.maxdepth, out=ref_out))

    print(f"[probe] {'textured ' + args.textured if args.textured else mat}", file=sys.stderr)
    subprocess.run([args.pbrt, "--nthreads", "2", scene_path], check=True, capture_output=True)

    # ours: the same scene through the port's parser and Path integrator
    from ..geometry import pbrt_parser
    from ..wavefront import integrator as integ

    scene, dbvh, cam, _ = pbrt_parser.load_scene(scene_path)
    cfg = integ.IntegratorConfig(max_depth=args.maxdepth)
    ours = integ.render(scene, dbvh, cam, spp=args.spp, sampler="halton", cfg=cfg,
                        device=args.device).cpu().numpy()
    ref = exr_mod.read_rgb(ref_out)
    if ref.shape != ours.shape:
        raise SystemExit(f"probe_material: reference {ref.shape} and ours {ours.shape} differ")
    for name, (r, o, rel) in rel_stats(ref, ours).items():
        print(f"{name}: ref={r:.5f} ours={o:.5f} rel={rel:+.2%}")
    if args.keep:
        print("kept:", tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
