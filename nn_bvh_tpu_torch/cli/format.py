"""pbrt scene formatter / upgrader / ply-extractor (port of
nn_bvh_tpu/cli/format.py, host only, quirks included: --upgrade renames
a MakeNamedMaterial's "string type" value only when it is not bracketed
(["matte"] stays "matte"), and --toply writes vertex values with %g, six
significant digits).

The reference implements `pbrt --format / --upgrade / --toply` via a second
ParserTarget (FormattingParserTarget, parser.h:202) that re-emits the scene
instead of building it. This is the standalone-CLI equivalent:

  python -m nn_bvh_tpu_torch.cli.format scene.pbrt [--upgrade] [--toply out_dir]
         [-o out.pbrt]

- default: canonical re-formatting (one directive per line, block
  indentation for Attribute/Object/World scopes, parameter lists aligned)
- --upgrade: pbrt-v3 -> v4 migrations (the common set of
  FormattingParserTarget's upgrades: material/sampler renames, "color" ->
  "rgb" parameter types, eta/index, mapname -> filename)
- --toply: trianglemesh shapes above a triangle-count threshold are written
  as binary-less ASCII .ply files and replaced by plymesh references
  (cmd/pbrt.cpp --toply semantics)

Tokens are processed without following Include directives (includes are
preserved verbatim), so formatting round-trips file by file.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

# directives that begin a new statement (parser.h ParserTarget vtable)
DIRECTIVES = {
    "Accelerator", "ActiveTransform", "AreaLightSource", "Attribute",
    "AttributeBegin", "AttributeEnd", "Camera", "ConcatTransform",
    "CoordinateSystem", "CoordSysTransform", "ColorSpace", "Film", "Identity",
    "Import", "Include", "Integrator", "LightSource", "LookAt",
    "MakeNamedMaterial", "MakeNamedMedium", "Material", "MediumInterface",
    "NamedMaterial", "ObjectBegin", "ObjectEnd", "ObjectInstance", "Option",
    "PixelFilter", "ReverseOrientation", "Rotate", "Sampler", "Scale",
    "Shape", "Texture", "Transform", "TransformBegin", "TransformEnd",
    "TransformTimes", "Translate", "WorldBegin", "WorldEnd",
}
INDENT_OPEN = {"AttributeBegin", "ObjectBegin", "TransformBegin"}
INDENT_CLOSE = {"AttributeEnd", "ObjectEnd", "TransformEnd"}

# --upgrade maps (FormattingParserTarget's v3->v4 migration set)
MATERIAL_RENAME = {
    "matte": "diffuse", "plastic": "coateddiffuse", "uber": "coateddiffuse",
    "metal": "conductor", "mirror": "conductor", "glass": "dielectric",
    "substrate": "coateddiffuse", "translucent": "diffusetransmission",
    "disney": "coateddiffuse", "kdsubsurface": "subsurface",
}
PARAM_RENAME = {  # (scope, old) -> new
    "Kd": "reflectance", "index": "eta", "mapname": "filename",
    "maxdepth": "maxdepth", "rougness": "roughness",
}
SAMPLER_RENAME = {
    "lowdiscrepancy": "paddedsobol", "02sequence": "paddedsobol",
    "random": "independent", "maxmindist": "pmj02bn",
}
DROPPED_PARAMS = {"Ks", "Kr", "Kt", "bumpmap"}  # no v4 equivalent in-place
V3_TYPE_RENAME = {"color": "rgb"}


def tokenize(text: str):
    """pbrt tokens: quoted strings (kept with quotes), brackets, comments
    dropped, bare tokens."""
    toks = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 1
            toks.append(text[i:j + 1])
            i = j + 1
        elif c in "[]":
            toks.append(c)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            toks.append(text[i:j])
            i = j
    return toks


def parse_statements(toks):
    """Group tokens into (directive, args) statements."""
    stmts = []
    cur = None
    for t in toks:
        if t in DIRECTIVES:
            if cur:
                stmts.append(cur)
            cur = [t]
        else:
            if cur is None:
                raise ValueError(f"token {t!r} before any directive")
            cur.append(t)
    if cur:
        stmts.append(cur)
    return stmts


def upgrade_statement(stmt):
    """v3 -> v4 in place; returns possibly-rewritten statement."""
    d = stmt[0]
    out = list(stmt)
    if d in ("Material", "MakeNamedMaterial"):
        # MakeNamedMaterial: name first, type rides in "string type"
        for i, t in enumerate(out):
            if t.startswith('"') and t[1:-1] in MATERIAL_RENAME and (
                    i == 1 or (i > 1 and out[i - 1] == '"string type"')):
                out[i] = f'"{MATERIAL_RENAME[t[1:-1]]}"'
    if d == "Sampler" and len(out) > 1 and out[1][1:-1] in SAMPLER_RENAME:
        out[1] = f'"{SAMPLER_RENAME[out[1][1:-1]]}"'
    if d == "Film" and len(out) > 1 and out[1] == '"image"':
        out[1] = '"rgb"'
    # parameter declarations: "type name"
    i = 0
    res = []
    while i < len(out):
        t = out[i]
        m = re.match(r'^"(\w+)\s+(\S+)"$', t) if t.startswith('"') else None
        if m:
            ptype, pname = m.group(1), m.group(2)
            ptype = V3_TYPE_RENAME.get(ptype, ptype)
            if pname in DROPPED_PARAMS:
                # skip the declaration and its value list
                i += 1
                if i < len(out) and out[i] == "[":
                    while i < len(out) and out[i] != "]":
                        i += 1
                    i += 1
                else:
                    i += 1
                continue
            pname = PARAM_RENAME.get(pname, pname)
            res.append(f'"{ptype} {pname}"')
            i += 1
        else:
            res.append(t)
            i += 1
    return res


def toply_statement(stmt, out_dir, counter, src_base):
    """Shape "trianglemesh" with many triangles -> external .ply."""
    if stmt[0] != "Shape" or len(stmt) < 2 or stmt[1] != '"trianglemesh"':
        return stmt
    # parse P and indices
    params = {}
    i = 2
    order = []
    while i < len(stmt):
        decl = stmt[i]
        vals = []
        i += 1
        if i < len(stmt) and stmt[i] == "[":
            i += 1
            while stmt[i] != "]":
                vals.append(stmt[i])
                i += 1
            i += 1
        else:
            vals.append(stmt[i])
            i += 1
        params[decl] = vals
        order.append(decl)
    idx_key = next((k for k in params if k.endswith(' indices"')), None)
    p_key = next((k for k in params if k.endswith(' P"')), None)
    if idx_key is None or p_key is None:
        return stmt
    n_tris = len(params[idx_key]) // 3
    if n_tris < 100:  # small meshes stay inline (same spirit as the ref)
        return stmt
    name = f"mesh_{counter[0]:05d}.ply"
    counter[0] += 1
    P = [float(v) for v in params[p_key]]
    I = [int(v) for v in params[idx_key]]
    nv = len(P) // 3
    nrm = params.get('"normal N"') or params.get('"normal3 N"')
    uv = params.get('"point2 uv"') or params.get('"float uv"')
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {nv}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if nrm:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if uv:
            f.write("property float u\nproperty float v\n")
        f.write(f"element face {n_tris}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in range(nv):
            row = P[3 * v:3 * v + 3]
            if nrm:
                row += [float(x) for x in nrm[3 * v:3 * v + 3]]
            if uv:
                row += [float(x) for x in uv[2 * v:2 * v + 2]]
            f.write(" ".join(f"{x:g}" for x in row) + "\n")
        for t in range(n_tris):
            f.write("3 " + " ".join(str(x) for x in I[3 * t:3 * t + 3]) + "\n")
    rel = os.path.relpath(os.path.join(out_dir, name), src_base)
    return ["Shape", '"plymesh"', '"string filename"', "[", f'"{rel}"', "]"]


def format_statements(stmts):
    lines = []
    depth = 0
    for stmt in stmts:
        d = stmt[0]
        if d in INDENT_CLOSE or d == "WorldEnd":
            depth = max(0, depth - 1)
        pad = "    " * depth
        # emit: directive + quoted-type args on one line; each parameter
        # declaration on its own indented line
        head = [d]
        i = 1
        while i < len(stmt) and not re.match(r'^"\w+\s+\S+"$', stmt[i]):
            head.append(stmt[i])
            i += 1
        lines.append(pad + " ".join(head))
        while i < len(stmt):
            decl = stmt[i]
            vals = []
            i += 1
            if i < len(stmt) and stmt[i] == "[":
                i += 1
                while i < len(stmt) and stmt[i] != "]":
                    vals.append(stmt[i])
                    i += 1
                i += 1
            elif i < len(stmt):
                vals.append(stmt[i])
                i += 1
            vtxt = " ".join(vals)
            if len(vtxt) > 160:
                vtxt = vtxt  # long arrays stay one line (machine data)
            lines.append(f"{pad}    {decl} [ {vtxt} ]")
        if d in INDENT_OPEN or d == "WorldBegin":
            depth += 1
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("-o", "--outfile", default=None)
    ap.add_argument("--upgrade", action="store_true")
    ap.add_argument("--toply", default=None, metavar="DIR",
                    help="extract big trianglemeshes to .ply files in DIR")
    args = ap.parse_args(argv)

    text = open(args.scene).read()
    stmts = parse_statements(tokenize(text))
    if args.upgrade:
        stmts = [upgrade_statement(s) for s in stmts]
    if args.toply:
        os.makedirs(args.toply, exist_ok=True)
        counter = [0]
        base = os.path.dirname(os.path.abspath(
            args.outfile or args.scene)) or "."
        stmts = [toply_statement(s, args.toply, counter, base)
                 for s in stmts]
    out = format_statements(stmts)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
