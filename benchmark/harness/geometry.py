"""The bench geometry as plain numpy arrays, frozen here so that a change to
the program cannot move the yardstick.

A copy of the procedural killeroo-simple stand-in that the repository's
`bench.py` renders: 24 tessellated spheres (RandomState(42) centres and
radii, every third a rough conductor), a floor quad and a two-sided
emissive quad, 52,996 triangles. `bench_meshes` gives each shape as
(vertices, faces, normals) with its material and emission; the benchmark
hands the very same arrays to the program's scene builder (`to_builder`)
and to the plain reference (`triangles`), so both start from one input.

`cloud_rule` is the learner's training data from the same geometry (the
floor as the static mesh, the spheres as movable meshes, the emissive quad
left out), normalised into [1, 2]^3 as the treeNet data stream does.
"""

from __future__ import annotations

import numpy as np

MATERIALS = (
    dict(kind="diffuse", reflectance=(0.6, 0.5, 0.4), roughness=0.0),
    dict(kind="conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15),
    dict(kind="diffuse", reflectance=(0.5, 0.5, 0.5), roughness=0.0),
)
CONDUCTOR_ETA, CONDUCTOR_K = 1.5, 3.9   # SceneBuilder.add_material's defaults
EMISSION_RGB = (1.0, 0.9, 0.8)
EMISSION_SCALE = 20.0
N_THETA, N_PHI = 24, 48


def _sphere(center, radius):
    th = np.linspace(0, np.pi, N_THETA + 1)
    ph = np.linspace(0, 2 * np.pi, N_PHI + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                      np.cos(tt)], -1).reshape(-1, 3)
    normals = verts.copy().astype(np.float32)
    verts = (verts * radius + np.asarray(center, np.float32)).astype(np.float32)
    idx = lambda i, j: i * (N_PHI + 1) + j
    faces = []
    for i in range(N_THETA):
        for j in range(N_PHI):
            a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
            if i > 0:
                faces.append([a, b, d])
            if i < N_THETA - 1:
                faces.append([b, c, d])
    return verts, np.asarray(faces, np.int64), normals


def _quad(p00, p10, p11, p01):
    verts = np.asarray([p00, p10, p11, p01], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    p = verts[faces]
    ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    return verts, faces, np.repeat(ng[:, None, :], 3, axis=1).astype(np.float32)


def bench_meshes() -> list:
    """[dict(verts, faces, normals, material, emission)]: the 24 spheres,
    the floor, the emissive quad, in that order. A sphere's normals are per
    vertex (V, 3); a quad's per face corner (F, 3, 3)."""
    rs = np.random.RandomState(42)
    out = []
    for i in range(24):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        v, f, n = _sphere(c, r)
        out.append(dict(verts=v, faces=f, normals=n, material=1 if i % 3 == 0 else 0,
                        emission=None))
    v, f, n = _quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8))
    out.append(dict(verts=v, faces=f, normals=n, material=2, emission=None))
    v, f, n = _quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2))
    out.append(dict(verts=v, faces=f, normals=n, material=2,
                    emission=(EMISSION_RGB, EMISSION_SCALE, True)))
    return out


def corner_normals(m: dict) -> np.ndarray:
    """(F, 3, 3) shading normals of a mesh's faces."""
    n = m["normals"]
    return n[m["faces"]] if n.ndim == 2 else n


def to_builder(builder):
    """The bench geometry into a scene builder of the program (its
    add_material / add_mesh) -> the builder."""
    for mat in MATERIALS:
        builder.add_material(mat["kind"], reflectance=mat["reflectance"],
                             roughness=mat["roughness"])
    for m in bench_meshes():
        kw = {}
        if m["emission"] is not None:
            rgb, scale, two = m["emission"]
            kw = dict(emission_rgb=rgb, emission_scale=scale, two_sided=two)
        builder.add_mesh(m["verts"], m["faces"], m["material"],
                         normals=m["normals"] if m["normals"].ndim == 2 else None, **kw)
    return builder


def triangles() -> dict:
    """The flat triangle tables of the geometry: p (N, 3, 3) vertices, n
    (N, 3, 3) shading normals, mat (N,), light (N,) emitter index or -1,
    and per emitter (rgb, scale, two_sided, triangle index)."""
    ps, ns, mats, lights, emitters = [], [], [], [], []
    off = 0
    for m in bench_meshes():
        p = m["verts"][m["faces"]]
        ps.append(p)
        ns.append(corner_normals(m))
        mats.append(np.full(len(p), m["material"], np.int64))
        li = np.full(len(p), -1, np.int64)
        if m["emission"] is not None:
            rgb, scale, two = m["emission"]
            for k in range(len(p)):
                li[k] = len(emitters)
                emitters.append(dict(rgb=rgb, scale=scale, two_sided=two, tri=off + k))
        lights.append(li)
        off += len(p)
    return dict(p=np.concatenate(ps).astype(np.float32), n=np.concatenate(ns).astype(np.float32),
                mat=np.concatenate(mats), light=np.concatenate(lights), emitters=emitters)


def look_at(eye, target, up) -> np.ndarray:
    """Camera-to-world 4x4 (+z into the screen, pbrt's LookAt)."""
    eye, target, up = (np.asarray(x, np.float64) for x in (eye, target, up))
    d = target - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, eye
    return m


# ---------------------------------------------------------------------------
# the learner's clouds
# ---------------------------------------------------------------------------

N_STATIC_PRIMS = 48


def _prims(tri_p: np.ndarray) -> np.ndarray:
    """(F, 3 verts, 3 xyz) -> (F, 9) as x1 x2 x3 | y1 y2 y3 | z1 z2 z3."""
    return np.asarray(tri_p, np.float32).transpose(0, 2, 1).reshape(-1, 9)


def _tris(prims: np.ndarray) -> np.ndarray:
    return np.asarray(prims, np.float32).reshape(-1, 3, 3).transpose(0, 2, 1)


def cloud_rule(pc_size: int) -> dict:
    """The pieces of the learner's clouds over the bench geometry: `static`
    (S, 9) the static mesh's largest prims, `picked` (pc_size - S, 9) the
    movable prims picked by a uniform stride, `mesh_of` (pc_size - S,) the
    movable mesh of each picked prim, `mesh_lo` / `mesh_hi` (M, 3) each
    movable mesh's bounds, `lo` / `hi` (3,) the scene's bounds. A batch
    element moves a random 1/4..3/4 of the movable meshes, each along one
    random axis, by a uniform shift that keeps it inside the scene's
    bounds."""
    meshes = bench_meshes()
    tri = [m["verts"][m["faces"]].astype(np.float32) for m in meshes[:25]]
    prims = [_prims(t) for t in [tri[24]] + tri[:24]]
    all_v = np.concatenate([_tris(m).reshape(-1, 3) for m in prims])
    bmin, bmax = all_v.min(0), all_v.max(0)
    scale = 1.0 / max(float((bmax - bmin).max()), 1e-9)
    prims = [_prims((_tris(m) - bmin) * scale + 1.0) for m in prims]
    static = prims[0]
    area = 0.5 * np.linalg.norm(np.cross(_tris(static)[:, 1] - _tris(static)[:, 0],
                                         _tris(static)[:, 2] - _tris(static)[:, 0]), axis=-1)
    static = static[np.argsort(area)[::-1][:N_STATIC_PRIMS]]
    movable = prims[1:]
    budget = pc_size - len(static)
    all_mov = np.concatenate(movable)
    pick = (np.arange(budget) * (len(all_mov) / budget)).astype(np.int64)
    sizes = np.array([len(m) for m in movable])
    mesh_id = np.repeat(np.arange(len(movable)), sizes)
    t_all = _tris(np.concatenate(prims)).reshape(-1, 3)
    return dict(static=static, picked=all_mov[pick], mesh_of=mesh_id[pick],
                mesh_lo=np.stack([_tris(m).reshape(-1, 3).min(0) for m in movable]),
                mesh_hi=np.stack([_tris(m).reshape(-1, 3).max(0) for m in movable]),
                lo=t_all.min(0), hi=t_all.max(0))


def program_scene(cfg: dict, width: int, height: int):
    """The program's bench scene, its BVH, camera and integrator settings
    from a render configuration file -> (scene, dbvh, camera,
    IntegratorConfig, camera-to-world)."""
    from nn_bvh_tpu_torch import accel
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.wavefront import camera as camera_mod, integrator

    scene, dbvh, _ = accel.build_scene_bvh(to_builder(scene_mod.SceneBuilder()).build())
    c = cfg["camera"]
    c2w = look_at(c["eye"], c["target"], c["up"])
    cam = camera_mod.make_perspective(c2w, fov=c["fov"], width=width, height=height)
    i = cfg["integrator"]
    icfg = integrator.IntegratorConfig(max_depth=i["max_depth"], mis=i["mis"],
                                       rr_depth=i["rr_depth"], light_sampler=i["light_sampler"])
    return scene, dbvh, cam, icfg, c2w
