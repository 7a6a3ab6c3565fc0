"""treeNet training CLI (port of nn_bvh_tpu/cli/train.py).

Usage:
    python -m nn_bvh_tpu_torch.cli.train [--scenes DIR] [--steps N] [--batch B]
        [--levels L] [--capacity C] [--pc-size N] [--variant epo|sah]
        [--checkpoint DIR] [--lr F] [--seed N] [--device cuda|cpu] [--dp]

--scenes takes a directory of .obj files; without it a procedural scene is
used. --device defaults to the CUDA card. --dp joins torchrun's process
group (dist.multihost.initialize, gloo) and, when it has more than one
rank, trains data-parallel over the ranks (trainer.train with the group's
mesh: each rank a share of every batch, the gradients summed over the
ranks as the JAX package's step sums them), each rank on
its card (LOCAL_RANK modulo the visible cards) or on the CPU with --device
cpu; at world size 1 it trains as without the flag. Only rank 0 writes
the checkpoint and prints the history:
    torchrun --nproc_per_node=2 -m nn_bvh_tpu_torch.cli.train --dp
On the card, float32 products run in full float32 (TF32 off,
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

    if not args.dp:
        return _train(args, None)
    import torch

    from ..dist import multihost, sharding

    joined = multihost.initialize()
    try:
        mesh = sharding.make_mesh(device=args.device)
        return _train(args, mesh if mesh.world_size > 1 else None)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, mesh):
    """main's training, data-parallel over `mesh` when it is given."""
    from .. import devices
    from ..learn import data, trainer, treenet

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

    if mesh is not None:
        print(f"data-parallel over {mesh.world_size} ranks", file=sys.stderr)
    state, history = trainer.train(
        cfg, scene, n_steps=args.steps, batch_size=args.batch, seed=args.seed,
        checkpoint_dir=args.checkpoint, log_every=args.log_every, mesh=mesh,
        device=args.device,
    )
    if mesh is None or mesh.rank == 0:
        for h in history:
            print(json.dumps(h))


if __name__ == "__main__":
    main()
