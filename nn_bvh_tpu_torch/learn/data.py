"""Training data: primitive/point clouds from scenes with augmentation.

A numpy copy of nn_bvh_tpu/learn/data.py, so that the port imports nothing of
the JAX package; its outputs are bit-identical to the JAX package's.

Rebuild of `nss_data_stream.py` (fork) + `nn_parser.py` + the augmentation in
`nn_data_augmentation.py`:

- Scenes are .obj files grouped into meshes (nn_parser.py:130 parse_obj
  grouping by 'g'); normalized to the unit-ish cube (scale_scene :175 — we
  normalize to [1, 2]^3 like the reference's beta=1 domain).
- A Scene samples a fixed-size primitive cloud: the 48 largest-area prims of
  static mesh 0 + a uniform stride over the movable meshes
  (nss_data_stream.py:117-150).
- get_next_transformed_batch (:190): per batch element, randomly translate
  1/4..3/4 of the movable meshes along one random axis within scene bounds.
- Deterministic rng so checkpoint-resume can fast-forward by replaying
  (nss_treeNet_model.py:41-46).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

N_STATIC_PRIMS = 48  # largest-area prims kept from the static mesh (nss_data_stream.py:117)


def parse_obj(path: str) -> list[np.ndarray]:
    """Parse an .obj into a list of (F, 9) primitive arrays, one per 'g' group
    (nn_parser.py:130 semantics; vertices are global, faces per group)."""
    verts: list[list[float]] = []
    groups: list[list[list[int]]] = []
    current: list[list[int]] = []
    seen_group = False
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "g":
                if seen_group and current:
                    groups.append(current)
                current = []
                seen_group = True
            elif t[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in t[1:]]
                # fan-triangulate
                for i in range(1, len(idx) - 1):
                    current.append([idx[0], idx[i], idx[i + 1]])
    if current:
        groups.append(current)
    v = np.asarray(verts, np.float32)
    out = []
    for faces in groups:
        fa = np.asarray(faces, np.int64)
        tri = v[fa]  # (F, 3, 3) [vert, xyz]
        # primitive layout (x1 x2 x3 | y1 y2 y3 | z1 z2 z3), nn_types.Primitive3
        out.append(tri.transpose(0, 2, 1).reshape(-1, 9).astype(np.float32))
    return out


def tris_to_prims(tri_p: np.ndarray) -> np.ndarray:
    """(F, 3 verts, 3 xyz) -> (F, 9) primitive-cloud layout."""
    return np.asarray(tri_p, np.float32).transpose(0, 2, 1).reshape(-1, 9)


def prims_to_tris(prims: np.ndarray) -> np.ndarray:
    return np.asarray(prims, np.float32).reshape(-1, 3, 3).transpose(0, 2, 1)


def scale_scene(meshes: list[np.ndarray], lo: float = 1.0, hi: float = 2.0):
    """Normalize all meshes jointly into [lo, hi]^3 (nn_parser.scale_scene)."""
    all_v = np.concatenate([prims_to_tris(m).reshape(-1, 3) for m in meshes])
    bmin = all_v.min(0)
    bmax = all_v.max(0)
    scale = (hi - lo) / max(float((bmax - bmin).max()), 1e-9)
    out = []
    for m in meshes:
        t = prims_to_tris(m)
        t = (t - bmin) * scale + lo
        out.append(tris_to_prims(t))
    return out


def prim_area(prims: np.ndarray) -> np.ndarray:
    t = prims_to_tris(prims)
    u = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    return 0.5 * np.linalg.norm(u, axis=-1)


@dataclass
class Scene:
    """Primitive-cloud sampler over one scene (nss_data_stream.Scene:79)."""

    meshes: list[np.ndarray]
    pc_size: int = 2048
    seed: int = 0
    _rng: np.random.RandomState = field(init=False)

    def __post_init__(self):
        self.meshes = scale_scene(self.meshes)
        self._rng = np.random.RandomState(self.seed)
        static = self.meshes[0]
        order = np.argsort(prim_area(static))[::-1]
        self.static_prims = static[order[:N_STATIC_PRIMS]]
        movable = self.meshes[1:] if len(self.meshes) > 1 else [self.meshes[0]]
        self.movable = movable
        # uniform stride over movable prims to fill the cloud (:129-150)
        budget = self.pc_size - len(self.static_prims)
        all_mov = np.concatenate(movable)
        if len(all_mov) <= budget:
            reps = int(np.ceil(budget / len(all_mov)))
            pick = np.tile(np.arange(len(all_mov)), reps)[:budget]
        else:
            pick = (np.arange(budget) * (len(all_mov) / budget)).astype(np.int64)
        self.mov_pick = pick
        self.all_mov = all_mov
        mov_sizes = np.array([len(m) for m in movable])
        self.mov_offsets = np.concatenate([[0], np.cumsum(mov_sizes)])

    def base_cloud(self) -> np.ndarray:
        return np.concatenate([self.static_prims, self.all_mov[self.mov_pick]])

    @property
    def bounds(self):
        t = prims_to_tris(np.concatenate(self.meshes)).reshape(-1, 3)
        return t.min(0), t.max(0)

    def next_batch(self, batch_size: int) -> np.ndarray:
        """(B, pc_size, 9) with random per-element mesh translations
        (get_next_tranformed_batch :190)."""
        lo, hi = self.bounds
        out = np.empty((batch_size, self.pc_size, 9), np.float32)
        n_mov = len(self.movable)
        for b in range(batch_size):
            moved = self.all_mov.copy()
            k = self._rng.randint(max(n_mov // 4, 1), max(3 * n_mov // 4, 1) + 1)
            which = self._rng.choice(n_mov, size=min(k, n_mov), replace=False)
            for mi in which:
                axis = self._rng.randint(3)
                m0, m1 = self.mov_offsets[mi], self.mov_offsets[mi + 1]
                seg = moved[m0:m1]
                t = prims_to_tris(seg)
                mmin = t[..., axis].min()
                mmax = t[..., axis].max()
                shift = self._rng.uniform(lo[axis] - mmin, hi[axis] - mmax)
                t[..., axis] += shift
                moved[m0:m1] = tris_to_prims(t)
            out[b] = np.concatenate([self.static_prims, moved[self.mov_pick]])
        return out

    def to_points(self, cloud: np.ndarray) -> np.ndarray:
        """(B, N, 9) prims -> (B, N, 3) centroids (SAH/point variant input)."""
        t = cloud.reshape(*cloud.shape[:-1], 3, 3)  # (..., xyz, verts)
        return t.mean(-1)


def random_scene(n_meshes: int = 4, prims_per_mesh: int = 128, seed: int = 0) -> Scene:
    """Procedural scene for tests/benchmarks (in place of train_scenes/*.obj)."""
    rs = np.random.RandomState(seed)
    meshes = []
    for i in range(n_meshes):
        c = rs.rand(prims_per_mesh, 1, 3) * 2.0
        tri = c + (rs.rand(prims_per_mesh, 3, 3) - 0.5) * 0.3
        meshes.append(tris_to_prims(tri.astype(np.float32)))
    return Scene(meshes)


class PointCloudStream:
    """Point-cloud training stream indexed by a CSV (the nss original's
    `pointcloud_stream`, nss_data_stream.py:18): a CSV with a `samples`
    column names .npz fragments (array under key 'a') relative to a root
    folder; clouds are volume-filtered, normalized to the [lo, hi] cube and
    served as shuffled batches. tf.data becomes a plain numpy generator:
    the input pipeline is host-side numpy feeding one device upload."""

    def __init__(self, root: str, csv_path: str, batch_size: int,
                 lo: float = 1.0, hi: float = 2.0, min_volume: float = 1e-4,
                 seed: int = 0):
        import csv as _csv
        import os as _os

        with open(csv_path) as f:
            rows = list(_csv.DictReader(f))
        clouds, names = [], []
        for row in rows:
            name = row["samples"].replace("\\", _os.sep)
            with np.load(_os.path.join(root, name) + ".npz",
                         allow_pickle=True) as z:
                pc = np.asarray(z["a"], np.float32)
            ext = pc.max(0) - pc.min(0)
            if float(np.prod(np.maximum(ext, 1e-12))) < min_volume:
                continue
            span = max(float(ext.max()), 1e-9)
            pc = (pc - pc.min(0)) / span * (hi - lo) + lo
            clouds.append(pc)
            names.append(name)
        if not clouds:
            raise ValueError(f"{csv_path}: no usable point clouds")
        self.names = np.asarray(names)
        self.clouds = np.stack(clouds).astype(np.float32)
        self.batch_size = min(batch_size, len(clouds))
        self._rs = np.random.RandomState(seed)

    def __iter__(self):
        while True:
            order = self._rs.permutation(len(self.clouds))
            for i in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
                sel = order[i:i + self.batch_size]
                yield self.names[sel], self.clouds[sel]

    def batches_per_epoch(self) -> int:
        return len(self.clouds) // self.batch_size
