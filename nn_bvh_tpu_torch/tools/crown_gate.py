"""Render the crown through the port and gate it against the pbrt-v4 CPU
golden (port of tools/crown_gate.py).

1. Needs the staged crown scene (default /tmp/crown_golden/crown_golden.pbrt,
   which `python tools/refbuild/crown_golden.py` stages from the reference's
   scenes/crown with PFM textures);
2. renders it at the golden's settings (250x350, VolPath, 64 spp by default)
   through `python -m nn_bvh_tpu_torch.cli.render ... --stats`, on the card;
3. prints the gate numbers against data/golden/crown-volpath-250x350-64spp.exr:
   the 10x7-block downsampled scene mean's relative error, and the blocks'
   relative errors (median, p90, max); the gate passes when the scene mean
   is within 5%, the block median under 10% and more than 85% of the blocks
   under 35%;
4. on a pass, copies the render to the port's own artifact,
   data/golden_torch/crown-ours-torch-volpath-250x350-64spp.exr. It never
   writes data/golden/crown-ours-volpath-250x350-64spp.exr, the JAX
   package's render.

Usage:
    python -m nn_bvh_tpu_torch.tools.crown_gate [--spp 64] [--no-copy]
        [--use-existing] [--ours PATH] [--scene PATH]

--use-existing gates the render already at --ours (default
crown_ours_torch.exr in the temporary directory) instead of rendering.
Exit code 0 on a pass, 1 on a fail.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
GOLDEN = os.path.join(REPO, "data", "golden", "crown-volpath-250x350-64spp.exr")
STAGED = "/tmp/crown_golden/crown_golden.pbrt"
OURS_PORT = os.path.join(REPO, "data", "golden_torch",
                         "crown-ours-torch-volpath-250x350-64spp.exr")


def downsample(im: np.ndarray, nbh: int, nbw: int) -> np.ndarray:
    """Block means of an (H, W, 3) image over an nbh x nbw grid (the JAX
    package's tests/test_crown_golden.py _downsample)."""
    h, w, _ = im.shape
    bh, bw = h // nbh, w // nbw
    return im[:nbh * bh, :nbw * bw].reshape(nbh, bh, nbw, bw, 3).mean((1, 3))


def gate(ours: np.ndarray, gold: np.ndarray) -> dict:
    """The gate's numbers for a render against the golden -> dict with
    ours_mean, pbrt_mean, rel, block_median, block_p90, block_max,
    block_frac_35 and ok."""
    if ours.shape != gold.shape:
        raise ValueError(f"render {ours.shape} and golden {gold.shape} differ in shape")
    g = downsample(gold, 10, 7)
    o = downsample(ours, 10, 7)
    rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
    denom = np.maximum(g.mean(-1), 0.05 * g.mean())
    blockrel = np.abs(o.mean(-1) - g.mean(-1)) / denom
    frac = (blockrel < 0.35).mean()
    return {"ours_mean": o.mean(), "pbrt_mean": g.mean(), "rel": rel,
            "block_median": np.median(blockrel), "block_p90": np.percentile(blockrel, 90),
            "block_max": blockrel.max(), "block_frac_35": frac,
            "ok": bool(rel < 0.05 and np.median(blockrel) < 0.10 and frac > 0.85)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--no-copy", action="store_true")
    ap.add_argument("--use-existing", action="store_true",
                    help="gate the render already at --ours")
    ap.add_argument("--ours", default=os.path.join(tempfile.gettempdir(), "crown_ours_torch.exr"),
                    help="the render to write and gate")
    ap.add_argument("--scene", default=STAGED, help="the staged crown .pbrt")
    args = ap.parse_args(argv)

    if not args.use_existing or not os.path.exists(args.ours):
        if not os.path.exists(args.scene):
            raise SystemExit(f"crown_gate: {args.scene} does not exist; stage the crown "
                             "first: python tools/refbuild/crown_golden.py")
        subprocess.check_call([sys.executable, "-m", "nn_bvh_tpu_torch.cli.render", args.scene,
                               "--spp", str(args.spp), "--outfile", args.ours, "--stats"],
                              cwd=REPO)

    from ..utils import exr

    g = gate(exr.read_rgb(args.ours), exr.read_rgb(GOLDEN))
    print(f"scene mean: ours {g['ours_mean']:.5f} pbrt {g['pbrt_mean']:.5f} rel {g['rel']:.3%}")
    print(f"block rel err: median {g['block_median']:.3%} "
          f"p90 {g['block_p90']:.3%} max {g['block_max']:.3%}")
    print("GATE:", "PASS" if g["ok"] else "FAIL")
    if g["ok"] and not args.no_copy:
        os.makedirs(os.path.dirname(OURS_PORT), exist_ok=True)
        shutil.copy(args.ours, OURS_PORT)
        print("copied ->", OURS_PORT)
    return 0 if g["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
