"""Minimal PLY mesh reader (ascii + binary little/big endian).

Counterpart of the reference's rply-based TriQuadMesh::ReadPLY
(`util/mesh.cpp`): positions, normals, uvs, and vertex_indices faces (tris and
quads; quads are split into two triangles like the reference does).

A copy of nn_bvh_tpu/geometry/ply.py, unchanged: the port keeps its
own, since importing anything of that package loads JAX.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns dict with 'vertices' (V,3) f32, optional 'normals' (V,3),
    'uvs' (V,2), and 'faces' (F,3) int64."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, count_type)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line == "end_header":
                break
            t = line.split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append((t[4], _TYPES[t[3]], True, _TYPES[t[2]]))
                else:
                    elements[-1][2].append((t[2], _TYPES[t[1]], False, None))
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt, "")
        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                data[name] = (props, rows, None)
            else:
                if any(p[2] for p in props):
                    # list property: parse sequentially
                    raw_rows = []
                    for _ in range(count):
                        row = []
                        for pname, dt, is_list, ct in props:
                            if is_list:
                                n = int(np.frombuffer(f.read(np.dtype(ct).itemsize),
                                                      endian + ct)[0])
                                vals = np.frombuffer(
                                    f.read(n * np.dtype(dt).itemsize), endian + dt
                                )
                                row.append(vals)
                            else:
                                row.append(
                                    np.frombuffer(f.read(np.dtype(dt).itemsize),
                                                  endian + dt)[0]
                                )
                        raw_rows.append(row)
                    data[name] = (props, None, raw_rows)
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(count * dt.itemsize), dt, count)
                    data[name] = (props, None, arr)

    out = {}
    # vertices
    props, ascii_rows, arr = data["vertex"]
    names = [p[0] for p in props]
    if ascii_rows is not None:
        varr = np.asarray(ascii_rows, np.float64)
        cols = {n: varr[:, i] for i, n in enumerate(names)}
    else:
        cols = {n: np.asarray(arr[n], np.float64) for n in names}
    out["vertices"] = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    if all(k in cols for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([cols["nx"], cols["ny"], cols["nz"]], -1).astype(np.float32)
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in cols and vkey in cols:
            out["uvs"] = np.stack([cols[ukey], cols[vkey]], -1).astype(np.float32)
            break

    # faces
    faces = []
    if "face" in data:
        props, ascii_rows, raw = data["face"]
        li = [i for i, p in enumerate(props) if p[2]][0]
        if ascii_rows is not None:
            idx_rows = [[int(x) for x in r[1 : 1 + int(r[0])]] for r in ascii_rows]
        else:
            idx_rows = [list(map(int, r[li])) for r in raw]
        for poly in idx_rows:
            for i in range(1, len(poly) - 1):
                faces.append([poly[0], poly[i], poly[i + 1]])
    out["faces"] = np.asarray(faces, np.int64).reshape(-1, 3)
    return out
