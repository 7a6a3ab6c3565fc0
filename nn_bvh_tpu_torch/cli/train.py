"""treeNet training CLI (port of nn_bvh_tpu/cli/train.py).

Usage:
    python -m nn_bvh_tpu_torch.cli.train [--scenes DIR] [--steps N] [--batch B]
        [--levels L] [--capacity C] [--pc-size N] [--variant epo|sah]
        [--checkpoint DIR] [--lr F] [--seed N] [--device cuda|cpu]

--scenes takes a directory of .obj files; without it a procedural scene is
used. --device defaults to the CUDA card. --dp (data parallelism over the
visible devices) waits for the port of dist/ (ROADMAP queue 1, item 7) and
raises. On the card, float32 products run in full float32 (TF32 off,
devices.full_float32). Prints one JSON history line per logging window.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="neural spatial-split training")
    ap.add_argument("--scenes", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--pc-size", type=int, default=2048)
    ap.add_argument("--variant", choices=["epo", "sah"], default="epo")
    ap.add_argument("--alpha", type=float, default=0.71)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dp", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from .. import devices
    from ..learn import data, trainer, treenet

    if args.dp:
        raise NotImplementedError("--dp is not ported yet (ROADMAP queue 1, item 7: dist/)")
    devices.full_float32()
    cfg = treenet.TreeNetConfig(
        levels=args.levels, capacity=args.capacity, pc_size=args.pc_size,
        epo=args.variant == "epo", alpha=args.alpha, learning_rate=args.lr,
    )

    if args.scenes:
        objs = sorted(glob.glob(os.path.join(args.scenes, "*.obj")))
        if not objs:
            sys.exit(f"no .obj files in {args.scenes}")
        meshes = data.parse_obj(objs[0])
        scene = data.Scene(meshes, pc_size=cfg.pc_size, seed=args.seed)
        print(f"scene {objs[0]}: {len(meshes)} meshes", file=sys.stderr)
    else:
        scene = data.random_scene(seed=args.seed)
        scene.pc_size = cfg.pc_size
        scene.__post_init__()
        print("using procedural scene", file=sys.stderr)

    state, history = trainer.train(
        cfg, scene, n_steps=args.steps, batch_size=args.batch, seed=args.seed,
        checkpoint_dir=args.checkpoint, log_every=args.log_every, device=args.device,
    )
    for h in history:
        print(json.dumps(h))


if __name__ == "__main__":
    main()
