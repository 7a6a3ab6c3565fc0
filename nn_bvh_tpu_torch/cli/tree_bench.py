"""Tree-quality benchmark CLI (port of nn_bvh_tpu/cli/tree_bench.py).

Loads a trained treeNet checkpoint of the port (`latest.pt` in a
directory, trainer.save_checkpoint) or trains briefly, predicts split trees
for a scene, rebuilds plane trees, and prints SAH/EPO cost against the
greedy builder (C_inn = 1.2, C_tri = 1.0). --device defaults to the CUDA
card, where float32 products run in full float32 (TF32 off,
devices.full_float32).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="predicted-tree vs greedy SAH/EPO")
    ap.add_argument("--scenes", default=None, help="dir of .obj scenes")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--pc-size", type=int, default=512)
    ap.add_argument("--train-steps", type=int, default=50,
                    help="quick-train steps when no checkpoint given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import glob
    import os

    import torch

    from .. import devices
    from ..learn import data, trainer, tree_eval, treenet

    devices.full_float32()
    cfg = treenet.TreeNetConfig(
        levels=args.levels, capacity=args.capacity, pc_size=args.pc_size,
        epo=True, learning_rate=3e-4,
    )

    scenes = []
    if args.scenes:
        for p in sorted(glob.glob(os.path.join(args.scenes, "*.obj"))):
            scenes.append((os.path.basename(p), data.Scene(data.parse_obj(p),
                                                           pc_size=cfg.pc_size)))
    else:
        scenes.append(("procedural", data.random_scene(seed=args.seed)))
        scenes[0][1].pc_size = cfg.pc_size
        scenes[0][1].__post_init__()

    if args.checkpoint:
        state = trainer.load_checkpoint(args.checkpoint,
                                        trainer.make_train_state(cfg, args.seed, args.device))
        print(f"loaded checkpoint at step {int(state.step)}", file=sys.stderr)
    else:
        state, _ = trainer.train(cfg, scenes[0][1], n_steps=args.train_steps,
                                 batch_size=4, seed=args.seed, device=args.device)
        print(f"quick-trained {args.train_steps} steps", file=sys.stderr)

    dev = next(state.model.parameters()).device
    for name, scene in scenes:
        cloud = scene.base_cloud()[None]
        _, planes = treenet.predict_tree(state.model, cfg, torch.as_tensor(cloud, device=dev))
        pred = tree_eval.build_tree_from_planes(cloud[0], planes[0].cpu().numpy())
        greedy = tree_eval.build_tree_from_planes(
            cloud[0], tree_eval.greedy_tree(cloud[0], cfg.levels)
        )
        print(json.dumps({
            "scene": name,
            "pred_sah": round(tree_eval.sah_cost(pred), 4),
            "greedy_sah": round(tree_eval.sah_cost(greedy), 4),
            "pred_epo": round(tree_eval.epo_cost(pred, cloud[0]), 4),
            "greedy_epo": round(tree_eval.epo_cost(greedy, cloud[0]), 4),
            "pred_stats": tree_eval.tree_stats(pred),
        }))


if __name__ == "__main__":
    main()
