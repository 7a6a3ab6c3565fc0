"""The controls of `correct`: the plain reference put in the program's
place, in the next precision below the configuration's, judged by the
cell's own comparison. bfloat16 for the renderer's float32; TF32 products
for the learner's float32 with TF32 off.

    python3 benchmark/tests/controls.py path_1080p 101 102 103
    python3 benchmark/tests/controls.py path_4k_x4 101 102 103
    python3 benchmark/tests/controls.py treenet_train 101 102 103
    python3 benchmark/tests/controls.py treenet_train half_batch 101 102 103
    python3 benchmark/tests/controls.py joint_720p 101 102 103

prints each seed's reading beside the cell's limit (on the card, at the
cell's own size).
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import geometry, learner, spec  # noqa: E402
from reference import joint as ref_joint, path as ref_path, treenet as ref_tree  # noqa: E402


def path_control(cell: str, seed: int, device, overrides=None) -> float:
    """The share of mismatched pixels, in the worst of the cell's row bands
    (one a chip), of the bfloat16 reference against the float32 one, on
    the pixels and the first image a run of `cell` with `seed` checks."""
    sp = spec.load_cell(cell)
    tf = dict(sp.traffic, **(overrides or {}).get("traffic", {}))
    cfg = dict(sp.config, **(overrides or {}).get("config", {}))
    drv = sp.driver
    W, H = int(tf["width"]), int(tf["height"])
    rs = np.random.default_rng(seed)
    pix = np.sort(rs.choice(W * H, size=min(int(tf["check_pixels"]), W * H), replace=False))
    c2w = geometry.look_at(cfg["camera"]["eye"], cfg["camera"]["target"], cfg["camera"]["up"])
    cam = dict(cam_to_world=c2w, fov=cfg["camera"]["fov"], width=W, height=H)
    integ = cfg["integrator"]
    out = []
    for dt in (torch.float32, torch.bfloat16):
        sc = ref_path.Scene(geometry.triangles(), geometry.MATERIALS,
                            (geometry.CONDUCTOR_ETA, geometry.CONDUCTOR_K), device, dtype=dt)
        out.append(ref_path.render_pixels(sc, cam, pix, seed, int(cfg["spp"]),
                                          max_depth=integ["max_depth"],
                                          rr_depth=integ["rr_depth"],
                                          chunk=int(tf.get("ref_chunk", 1024))))
    band = torch.as_tensor(drv.band_of(pix, W * H, sp.chips), device=out[0].device)
    return drv.mismatch_share(out[1], out[0], sp.cell["check"], band)


def train_control(cell: str, seed: int, device, overrides=None, fault: str = "") -> dict:
    """The cell's numbers for the reference with TF32 products in the
    program's place, against the reference in float32, on the weights and
    first batches a run of `cell` with `seed` draws. fault "half_batch"
    reads instead the reference in float32 that takes half of each batch
    (the mean over the rest)."""
    sp = spec.load_cell(cell)
    cfg = dict(sp.config, **(overrides or {}).get("config", {}))
    drv = sp.driver
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = learner.make_weights(torch, cfg, gen, dev)
    B = int(cfg["batch"])
    pool = learner.make_clouds(torch, geometry.cloud_rule(cfg["pc_size"]), drv.N_CHECKED * B, gen,
                           dev).reshape(drv.N_CHECKED, B, cfg["pc_size"], 9)
    batches = [pool[i] for i in range(drv.N_CHECKED)]
    want = ref_tree.train(weights, cfg, batches)
    if fault == "half_batch":
        got = ref_tree.train(weights, cfg, [b[:B // 2] for b in batches])
    else:
        got = ref_tree.train(weights, cfg, batches, tf32=True)
    names = list(want["grad"])
    checks = drv.compare(got["loss"], got["grad"], {k: got["delta"][k] for k in names}, want,
                         sp.cell["check"])
    return {n: v for n, v, _ in checks}


def joint_control(cell: str, seed: int, device, overrides=None, fault: str = "") -> dict:
    """The cell's numbers for the joint reference with TF32 products in the
    program's place, against it in float32, on the weights, clouds and
    sample indices a run of `cell` with `seed` draws; fault "half_batch"
    reads instead the float32 reference that takes half of each batch."""
    sp = spec.load_cell(cell)
    cfg = dict(sp.config, **(overrides or {}).get("config", {}))
    tf = dict(sp.traffic, **(overrides or {}).get("traffic", {}))
    rc = spec.read_json(os.path.join(BENCH, "configs", f"{tf['render_config']}.json"))
    drv = sp.driver
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = learner.make_weights(torch, cfg, gen, dev)
    B = int(cfg["batch"])
    pool = learner.make_clouds(torch, geometry.cloud_rule(cfg["pc_size"]), drv.N_CHECKED * B,
                               gen, dev).reshape(drv.N_CHECKED, B, cfg["pc_size"], 9)
    c2w = geometry.look_at(rc["camera"]["eye"], rc["camera"]["target"], rc["camera"]["up"])
    cam = dict(cam_to_world=c2w, fov=rc["camera"]["fov"], width=int(tf["width"]),
               height=int(tf["height"]))
    sc = ref_path.Scene(geometry.triangles(), geometry.MATERIALS,
                        (geometry.CONDUCTOR_ETA, geometry.CONDUCTOR_K), dev, bvh=True)
    integ, spp = rc["integrator"], int(rc["spp"])
    args = lambda batches, tf32: ref_joint.train(
        weights, cfg, sc, cam, seed, spp, [i % spp for i in range(drv.N_CHECKED)], batches,
        float(tf["lr"]), float(tf["tree_weight"]), integ["max_depth"], integ["rr_depth"], tf32)
    batches = [pool[i] for i in range(drv.N_CHECKED)]
    want = args(batches, False)
    got = args([b[:B // 2] for b in batches], False) if fault == "half_batch" else \
        args(batches, True)
    checks = drv.compare(got, got["delta"], want, sp.cell["check"])
    return {n: v for n, v, _ in checks}


if __name__ == "__main__":
    cell, seeds = sys.argv[1], [int(s) for s in sys.argv[2:] if s.isdigit()]
    fault = next((s for s in sys.argv[2:] if not s.isdigit()), "")
    for s in seeds:
        if cell.startswith("path"):
            got = path_control(cell, s, "cuda")
        elif cell.startswith("joint"):
            got = joint_control(cell, s, "cuda", fault=fault)
        else:
            got = train_control(cell, s, "cuda", fault=fault)
        print(json.dumps({"cell": cell, "seed": s, "fault": fault, "control": got}), flush=True)
