"""Motion-blur parity probe against the pbrt-v4 CPU binary (port of
tools/probe_motion.py).

Renders the same ActiveTransform scene (a quad sweeping left to right
under an area light) with the reference binary (per-sample shutter times,
AnimatedPrimitive) and with the port (per-wave stratified shutter times,
keyframe-lerped tables), then compares the scene mean and 8x8 block means.
The estimators differ only in how time is stratified, so converged images
agree: the probe passes when the scene mean is within 2.5% and the block
median within 5%.

Usage:
    python -m nn_bvh_tpu_torch.tools.probe_motion [--spp 64] [--res 96]
        [--pbrt /tmp/refbuild/pbrt] [--device cuda|cpu]

The reference binary (--pbrt, built by tools/refbuild/assemble.py + make)
must exist. The port renders through cli.render, on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

SCENE = """
LookAt 0 1.2 -3.2  0 1.2 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res}] "integer yresolution" [{res}]
    "string filename" "motion.exr"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [14 14 14] "bool twosided" true
  Shape "trianglemesh"
    "point3 P" [-0.8 3.0 -0.8  0.8 3.0 -0.8  0.8 3.0 0.8  -0.8 3.0 0.8]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.8 0.25 0.2]
  ActiveTransform StartTime
  Translate -0.7 0 0
  ActiveTransform EndTime
  Translate 0.7 0 0
  ActiveTransform All
  Shape "trianglemesh"
    "point3 P" [-0.35 0.8 0  0.35 0.8 0  0.35 1.6 0  -0.35 1.6 0]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.45 0.45 0.45]
  Shape "trianglemesh"
    "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def motion_stats(ref: np.ndarray, ours: np.ndarray, block: int = 8) -> dict:
    """Scene means, their relative error, the 8x8 block relative errors'
    median and p90 (blocks' denominators floored at 0.02), and the verdict."""
    mref, mours = float(ref.mean()), float(ours.mean())
    H = (ref.shape[0] // block) * block
    W = (ref.shape[1] // block) * block
    br = ref[:H, :W].reshape(H // block, block, W // block, block, 3).mean((1, 3, 4))
    bo = ours[:H, :W].reshape(H // block, block, W // block, block, 3).mean((1, 3, 4))
    rel = np.abs(bo - br) / np.maximum(br, 0.02)
    scene_rel = abs(mours - mref) / mref
    return {"ref_mean": mref, "ours_mean": mours, "scene_rel": scene_rel,
            "block_median": float(np.median(rel)), "block_p90": float(np.percentile(rel, 90)),
            "ok": bool(scene_rel < 0.025 and np.median(rel) < 0.05)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--pbrt", default="/tmp/refbuild/pbrt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not os.path.exists(args.pbrt):
        raise SystemExit(f"probe_motion: the reference binary {args.pbrt} does not exist; "
                         "build it with tools/refbuild/assemble.py + make or pass --pbrt")

    from ..cli import render
    from ..utils import exr

    work = tempfile.mkdtemp(prefix="motion_probe_")
    scene_file = os.path.join(work, "motion.pbrt")
    with open(scene_file, "w") as f:
        f.write(SCENE.format(res=args.res, spp=args.spp))
    subprocess.check_call([os.path.abspath(args.pbrt), "--nthreads", "2", "motion.pbrt"],
                          cwd=work)
    ours_file = os.path.join(work, "motion_ours.exr")
    render.main([scene_file, "--spp", str(args.spp), "--outfile", ours_file]
                + (["--device", args.device] if args.device else []))

    s = motion_stats(exr.read_rgb(os.path.join(work, "motion.exr")), exr.read_rgb(ours_file))
    print(f"scene mean: ref {s['ref_mean']:.5f} ours {s['ours_mean']:.5f} "
          f"rel {s['scene_rel'] * 100:.2f}%")
    print(f"8x8 block rel err: median {s['block_median'] * 100:.2f}% "
          f"p90 {s['block_p90'] * 100:.2f}%")
    print("PASS" if s["ok"] else "FAIL")
    return 0 if s["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
