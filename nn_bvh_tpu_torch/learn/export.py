"""Binary artifact export/import for trained trees and weights (port of
nn_bvh_tpu/learn/export.py).

- Tree export: level-order plane list [nx, ny, nz, offset] float32, raw
  (`ndarray.tofile`).
- Per-layer raw weight export: each encoder weight as raw float32, one file
  per weight, named as the JAX package names them (`<level>_<field>.bin`,
  e.g. `0_w1.bin`), so a model exported by either package is the same
  folder of the same bytes.
- planes_to_bvh: a predicted plane tree -> a traversal-ready flat BVH, the
  renderer consuming the tree in process.
"""

from __future__ import annotations

import os

import numpy as np

from . import encoder as enc_mod


def export_tree(path: str, planes: np.ndarray) -> None:
    """planes (T, 4) float32 level-order -> raw binary (tofile format)."""
    np.asarray(planes, np.float32).tofile(path)


def import_tree(path: str) -> np.ndarray:
    arr = np.fromfile(path, np.float32)
    if arr.size % 4:
        raise ValueError(f"{path}: not a plane list")
    return arr.reshape(-1, 4)


def export_variables(dirpath: str, model) -> None:
    """Per-layer raw float32 dumps of a TreeNet's weights; a missing weight
    (vert of the SAH variant) writes no file."""
    os.makedirs(dirpath, exist_ok=True)
    for level, enc in enumerate(model.encoders):
        for name in enc_mod.FIELDS:
            w = getattr(enc, name)
            if w is not None:
                w.detach().cpu().numpy().astype(np.float32).tofile(
                    os.path.join(dirpath, f"{level}_{name}.bin"))


def planes_to_bvh(prims: np.ndarray, planes: np.ndarray, max_leaf: int = 4):
    """Rebuild a traversal-ready flat BVH from a predicted plane tree.

    The learned planes give the top-of-tree spatial splits; each prim subset
    below the plane tree's leaves stays contiguous, and one binned-SAH build
    over that order finishes the tree. prims: (F, 9) primitive cloud or
    (F, 3, 3) triangles.

    Returns an accel.build.BVH whose prim_order maps each slot to the
    original prim, ready for accel.apply_bvh_to_scene.
    """
    from ..accel import build as accel_build
    from . import tree_eval

    if prims.ndim == 3:
        tri = np.asarray(prims, np.float32)
    else:
        tri = tree_eval._tris(np.asarray(prims, np.float32))
    lo = tri.min(1)
    hi = tri.max(1)
    mids = 0.5 * (lo + hi)

    # classify prims down the plane tree (level-order binary)
    n_planes = len(planes)
    assignments = [np.arange(len(tri))]
    pi = 0
    while pi < n_planes:
        nxt = []
        for idx in assignments:
            if pi >= n_planes:
                nxt.append(idx)
                continue
            nx, ny, nz, off = planes[pi]
            pi += 1
            axis = int(np.argmax([nx, ny, nz]))
            m = mids[idx, axis] <= off
            nxt.append(idx[m])
            nxt.append(idx[~m])
        assignments = nxt

    order = np.concatenate([a for a in assignments if len(a)])
    tri_ord = tri[order]
    bvh = accel_build.build_sah(tri_ord.min(1), tri_ord.max(1), max_leaf)
    # compose permutations: final slot -> original prim
    return bvh._replace(prim_order=order[bvh.prim_order])
