"""pbrt scene-format parser -> SceneBuilder + render settings (port of
nn_bvh_tpu/geometry/pbrt_parser.py; host numpy, like the JAX package's).

The tokenizer with Include/Import and gzipped files; the graphics state and
attribute stack; object instancing; ActiveTransform/TransformTimes (the
shutter-end transform of each shape); materials, named and measured ones
included; textures (imagemap, scale, checkerboard, constant); area, point,
distant and infinite lights; every shape of the JAX parser (trianglemesh,
plymesh, loopsubdiv, sphere/disk/cylinder as analytic quadrics, curve,
bilinearmesh); named homogeneous, grid and cloud media; MediumInterface;
`ParseResult`, `make_sensor` and `load_scene`. Unsupported parts degrade
with the same warnings as the JAX parser, in result.warnings.

Where the port differs: PNG textures are read by the port's own decoder
(utils/image.read_png; the JAX parser uses PIL, which the card's machine
lacks); JPEG and TGA textures are not read and fall back to a constant
through the parser's warning path; a scene naming a measured sensor or a
white balance raises (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import gzip
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from . import transform as xf
from .scene import SceneBuilder
from . import ply as ply_mod
from . import loopsubdiv


# ---------------------------------------------------------------------------
# tokenizer (parser.h Tokenizer:124)
# ---------------------------------------------------------------------------

def tokenize(text: str):
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
            yield text[i : j + 1]
            i = j + 1
        elif c in "[]":
            yield c
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            yield text[i:j]
            i = j


class TokenStream:
    """Token lookahead over (possibly nested via Include) files."""

    def __init__(self, path_or_text: str, is_file=True):
        if is_file:
            self.base = os.path.dirname(os.path.abspath(path_or_text))
            opener = gzip.open if path_or_text.endswith(".gz") else open
            with opener(path_or_text, "rt") as f:
                text = f.read()
        else:
            self.base = "."
            text = path_or_text
        self.tokens = list(tokenize(text))
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise EOFError("unexpected end of scene file")
        self.pos += 1
        return t

    def insert(self, other: "TokenStream"):
        self.tokens[self.pos : self.pos] = other.tokens


def _unquote(t: str) -> str:
    return t[1:-1] if t.startswith('"') else t


def parse_params(ts: TokenStream) -> dict:
    """Parse '"type name" [values]' pairs until a non-quoted token."""
    params = {}
    while True:
        t = ts.peek()
        if t is None or not t.startswith('"'):
            return params
        decl = _unquote(ts.next()).split()
        if len(decl) == 1:
            ptype, name = "string", decl[0]
        else:
            ptype, name = decl[0], " ".join(decl[1:])
        vals = []
        if ts.peek() == "[":
            ts.next()
            while ts.peek() != "]":
                vals.append(ts.next())
            ts.next()
        else:
            vals.append(ts.next())
        if ptype in ("float", "point3", "point2", "vector3", "vector", "normal",
                     "normal3", "rgb", "color", "spectrum", "blackbody", "point"):
            try:
                vals = [float(v) for v in vals]
            except ValueError:
                vals = [_unquote(v) for v in vals]  # named spectrum
        elif ptype == "integer":
            vals = [int(float(v)) for v in vals]
        elif ptype == "bool":
            vals = [(_unquote(v) if isinstance(v, str) else v) in ("true", "True", True) for v in vals]
        else:
            vals = [_unquote(v) for v in vals]
        params[name] = {"type": ptype, "values": vals}
    return params


def pget(params, name, default=None):
    if name not in params:
        return default
    v = params[name]["values"]
    return v[0] if len(v) == 1 else v


def pvec(params, name, default=None):
    if name not in params:
        return default
    vals = params[name]["values"]
    if vals and isinstance(vals[0], str):
        # texture-typed or named-spectrum parameter — numeric callers fall
        # back to the default; string handling happens at the call sites
        return default
    return np.asarray(vals, np.float32)


# ---------------------------------------------------------------------------
# graphics state (scene.h BasicSceneBuilder GraphicsState)
# ---------------------------------------------------------------------------

@dataclass
class GraphicsState:
    ctm: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    # motion blur (parser.h ActiveTransform/TransformTimes): the CTM at
    # shutter END; transform directives mutate ctm and/or ctm_end per
    # `active`. Equal matrices mean a static object.
    ctm_end: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    active: str = "all"            # all | start | end
    # None = no Material directive seen (add_shape creates a default gray
    # diffuse); -1 = explicit interface material (Material "none")
    material: "int | None" = None
    area_light: Optional[dict] = None
    reverse_orientation: bool = False
    # current MediumInterface (scene.cpp graphics-state currentInsideMedium/
    # currentOutsideMedium): builder medium ids, -1 = vacuum
    med_inside: int = -1
    med_outside: int = -1

    def copy(self) -> "GraphicsState":
        return GraphicsState(self.ctm.copy(), self.ctm_end.copy(),
                             self.active, self.material,
                             dict(self.area_light) if self.area_light else None,
                             self.reverse_orientation,
                             self.med_inside, self.med_outside)

    def apply_xf(self, f):
        if self.active in ("all", "start"):
            self.ctm = f(self.ctm)
        if self.active in ("all", "end"):
            self.ctm_end = f(self.ctm_end)

    @property
    def is_animated(self) -> bool:
        return not np.allclose(self.ctm_end, self.ctm)


@dataclass
class ParseResult:
    builder: SceneBuilder
    camera_kind: str = "perspective"
    cam_to_world: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    fov: float = 90.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    width: int = 640
    height: int = 480
    filename: str = "out.exr"
    sampler: str = "sobol"
    spp: int = 16
    integrator: str = "path"
    max_depth: int = 5
    iso: float = 100.0
    exposure: float = 1.0
    white_balance: float | None = None
    sensor: str = "cie1931"
    transform_times: tuple = (0.0, 1.0)
    warnings: list = field(default_factory=list)

    def make_sensor(self):
        """PixelSensor for develop() (None when all defaults). A known
        measured sensor raises (ROADMAP queue 1, item 8); an unknown sensor
        name is the XYZ sensor, as in the JAX package."""
        from ..core import named_spectra
        from ..wavefront import film as film_mod

        if self.sensor != "cie1931" and named_spectra.has(self.sensor + "_r"):
            raise NotImplementedError(f"measured sensor {self.sensor!r} is not ported "
                                      "yet (ROADMAP queue 1, item 8)")
        if (self.iso == 100.0 and self.exposure == 1.0
                and self.white_balance is None):
            return None
        return film_mod.make_sensor(self.white_balance, self.iso,
                                    self.exposure)


_MATERIAL_MAP = {
    # pbrt-v4 name -> (our kind, note)
    "diffuse": ("diffuse", None),
    "coateddiffuse": ("coateddiffuse", None),
    "conductor": ("conductor", None),
    "coatedconductor": ("coatedconductor", None),
    "dielectric": ("dielectric", None),
    "thindielectric": ("thindielectric", None),
    "diffusetransmission": ("diffusetransmission", None),
    "subsurface": ("subsurface", None),
    "hair": ("hair", None),
    "measured": ("measured", None),
    # pbrt-v4: Material "" UNSETS the material -> a pure medium-interface
    # surface (scene.cpp empty material name; used by volume bounds)
    "": ("interface", None),
    "none": ("interface", None),
}

# measured scattering properties of named media (the reference's
# GetMediumScatteringProperties table, media.cpp — physical data from
# Jensen et al. 2001 / Narasimhan et al. 2006; sigma_a / sigma_prime_s
# in mm^-1 as pbrt stores them)
_NAMED_SSS = {
    # name: (sigma_a rgb, sigma_s rgb)
    "Apple": ((0.0030, 0.0034, 0.046), (2.29, 2.39, 1.97)),
    "Chicken1": ((0.015, 0.077, 0.19), (0.15, 0.21, 0.38)),
    "Cream": ((0.0002, 0.0028, 0.0163), (7.38, 5.47, 3.15)),
    "Ketchup": ((0.061, 0.97, 1.45), (0.18, 0.07, 0.03)),
    "Marble": ((0.0021, 0.0041, 0.0071), (2.19, 2.62, 3.00)),
    "Potato": ((0.0024, 0.0090, 0.12), (0.68, 0.70, 0.55)),
    "Skimmilk": ((0.0014, 0.0025, 0.0142), (0.70, 1.22, 1.90)),
    "Skin1": ((0.032, 0.17, 0.48), (0.74, 0.88, 1.01)),
    "Skin2": ((0.013, 0.070, 0.145), (1.09, 1.59, 1.79)),
    "Wholemilk": ((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77)),
}


def _blackbody_rgb(T: float) -> np.ndarray:
    """RGB of a peak-normalized blackbody (BlackbodySpectrum semantics,
    spectrum.h:497: normalized so the Planck maximum is 1)."""
    from ..core import spectrum as spec_mod, colorspace

    lam = np.arange(spec_mod.LAMBDA_MIN, spec_mod.LAMBDA_MAX + 1.0)
    v = np.asarray(spec_mod.blackbody_normalized(lam, T))
    xyz = np.array([np.sum(v * spec_mod.cie_x(lam)),
                    np.sum(v * spec_mod.cie_y(lam)),
                    np.sum(v * spec_mod.cie_z(lam))]) / spec_mod.CIE_Y_INTEGRAL
    rgb = colorspace.XYZ_TO_SRGB @ xyz.astype(np.float32)
    return np.maximum(rgb, 0.0).astype(np.float32)


def parse_file(path: str) -> ParseResult:
    ts = TokenStream(path)
    builder = SceneBuilder()
    res = ParseResult(builder)
    gs = GraphicsState()
    stack: list[GraphicsState] = []
    named_materials: dict[str, int] = {}
    named_media: dict[str, int] = {}
    textures: dict[str, dict] = {}
    objects: dict[str, list] = {}
    current_object: Optional[str] = None
    world = False

    def warn(msg):
        if msg and msg not in res.warnings:
            res.warnings.append(msg)

    def make_material(mtype: str, params: dict) -> int:
        if mtype == "mix":
            # MixMaterial: two named sub-materials + amount (materials.h)
            subs = params.get("materials", {"values": []})["values"]
            ids = [named_materials.get(s, -1) for s in subs[:2]]
            if len(ids) == 2 and min(ids) >= 0:
                amt_raw = pget(params, "amount", 0.5)
                if isinstance(amt_raw, str):
                    # texture-driven amount (crown.pbrt mask mixes): encode
                    # as -(tex_id+1); resolved per intersection in
                    # bxdf.gather_material from the texture stack
                    tex = textures.get(amt_raw) or {}
                    tid = tex.get("tex_id", -1)
                    if tid >= 0:
                        amt = -float(tid + 1)
                    else:
                        warn("mix amount texture unresolved -> 0.5")
                        amt = 0.5
                else:
                    amt = float(amt_raw)
                return builder.add_material(
                    "mix", mix_materials=(ids[0], ids[1]), mix_amount=amt)
            warn("mix material with unresolved submaterials -> diffuse")
            return builder.add_material("diffuse")
        kind, note = _MATERIAL_MAP.get(mtype, (None, None))
        if kind is None:
            warn(f"material '{mtype}' unsupported -> diffuse")
            kind = "diffuse"
        elif note:
            warn(note)
        if kind == "measured":
            # MeasuredMaterial (materials.h): RGL .bsdf ingested via
            # scatter/measured.read_bsdf + resampled (bsdf_to_table); .npz
            # is our converted-table interchange
            fn = pget(params, "filename", "")
            try:
                from ..scatter import measured as measured_mod

                full = os.path.join(ts.base, str(fn))
                if str(fn).endswith(".bsdf"):
                    table = measured_mod.bsdf_to_table(
                        measured_mod.read_bsdf(full))
                else:
                    table = measured_mod.load_table(full)
                mid = builder.add_measured_brdf(table)
                return builder.add_material("measured", measured=mid)
            except Exception as e:
                warn(f"measured '{fn}' unreadable ({type(e).__name__}) "
                     "-> diffuse")
                return builder.add_material("diffuse")
        if kind == "interface":
            return -1
        refl = pvec(params, "reflectance", np.array([0.5, 0.5, 0.5], np.float32))
        if np.isscalar(refl) or refl.ndim == 0:
            refl = np.full(3, float(refl), np.float32)
        tex_id = -1
        if isinstance(pget(params, "reflectance"), str):
            tex = textures.get(pget(params, "reflectance")) or {}
            tex_id = tex.get("tex_id", -1)
            refl = tex.get("value", np.array([0.5, 0.5, 0.5], np.float32))
            if tex_id < 0:
                warn("texture reflectance approximated by constant")
        rough = pget(params, "roughness", 0.0)
        if isinstance(rough, str):
            rough = 0.1
        eta = pget(params, "eta", 1.5)
        if isinstance(eta, (list, np.ndarray)):
            eta = float(np.mean(eta))
        if isinstance(eta, str):
            eta = 1.5
        k = pget(params, "k", 3.9)
        if isinstance(k, (list, np.ndarray)):
            k = float(np.mean(k))
        if isinstance(k, str):
            k = 3.9
        def spec_param(pname):
            """Spectrum-typed parameter -> named-spectrum name, .spd path, or
            (lam, val) pairs; None if absent/untyped (reference paramdict
            GetOneSpectrum + GetNamedSpectrum resolution)."""
            from ..core import named_spectra

            ent = params.get(pname)
            if ent is None:
                return None
            v = ent["values"]
            if v and isinstance(v[0], str):
                s = v[0]
                if s.endswith(".spd"):
                    return os.path.join(ts.base, s)
                if named_spectra.has(s):
                    return s
                warn(f"unknown named spectrum '{s}'")
                return None
            if ent["type"] == "spectrum" and len(v) >= 4:
                a = np.asarray(v, np.float64).reshape(-1, 2)
                return (a[:, 0], a[:, 1])
            return None

        if kind in ("conductor", "coatedconductor"):
            # reference default conductor is copper (materials.cpp
            # ConductorMaterial::Create: metal-Cu-eta / metal-Cu-k) unless a
            # reflectance parameterization is given
            eta_spec, k_spec = spec_param("eta"), spec_param("k")
            if ("eta" not in params and "k" not in params
                    and "reflectance" not in params):
                eta_spec, k_spec = "metal-Cu-eta", "metal-Cu-k"
            if "reflectance" not in params:
                # pbrt's ConductorBxDF has no reflectance tint when eta/k
                # parameterized — color comes from the Fresnel term alone
                refl = np.ones(3, np.float32)
            eta_c = eta if "eta" in params else 0.2
            crough = pget(params, "interface.roughness", 0.0)
            return builder.add_material(kind, reflectance=refl, roughness=float(rough),
                                        eta=float(eta_c), k=float(k), texture=tex_id,
                                        eta_spectrum=eta_spec, k_spectrum=k_spec,
                                        coat_roughness=float(crough)
                                        if not isinstance(crough, str) else 0.0)
        if kind == "hair":
            bm = float(pget(params, "beta_m", 0.3))
            bn = float(pget(params, "beta_n", 0.3))
            eta_h = float(pget(params, "eta", 1.55))
            return builder.add_material("hair", reflectance=refl,
                                        roughness=bm, beta_n=bn, eta=eta_h)
        if kind == "subsurface":
            # SubsurfaceMaterial (materials.h:696): named preset via "name"
            # (mfp or sigma_a/sigma_s RGB), scale, g, eta
            sa = np.asarray(pget(params, "sigma_a", (0.0011, 0.0024, 0.014)),
                            np.float32)
            ss = np.asarray(pget(params, "sigma_s", (2.55, 3.21, 3.77)),
                            np.float32)
            nm = params.get("name")
            if nm is not None and nm["values"]:
                preset = _NAMED_SSS.get(str(nm["values"][0]))
                if preset is None:
                    warn(f"unknown subsurface preset '{nm['values'][0]}'")
                else:
                    sa = np.asarray(preset[0], np.float32)
                    ss = np.asarray(preset[1], np.float32)
            scl = float(pget(params, "scale", 1.0))
            g_hg = float(pget(params, "g", 0.0))
            eta_sss = float(pget(params, "eta", 1.33))
            return builder.add_material(
                "subsurface", sigma_a=tuple(sa), sigma_s=tuple(ss),
                sss_scale=scl, g=g_hg, eta=eta_sss,
                roughness=float(rough) if not isinstance(rough, str) else 0.0)
        if kind == "coateddiffuse":
            return builder.add_material(kind, reflectance=refl,
                                        roughness=0.0, eta=float(eta),
                                        texture=tex_id,
                                        coat_roughness=float(rough)
                                        if not isinstance(rough, str) else 0.0)
        return builder.add_material(kind, reflectance=refl, roughness=float(rough),
                                    eta=float(eta), k=float(k), texture=tex_id)

    def add_shape(stype: str, params: dict):
        target = objects[current_object] if current_object else None
        emission = None
        escale = 1.0
        two_sided = False
        if gs.area_light is not None:
            L = gs.area_light.get("L", np.array([1.0, 1, 1], np.float32))
            emission = np.asarray(L, np.float32)
            m = float(max(emission.max(), 1e-9))
            escale = m * float(gs.area_light.get("scale", 1.0))
            emission = emission / m
            two_sided = bool(gs.area_light.get("twosided", False))
        mat = gs.material
        if mat is None:
            mat = -1 if gs.area_light is not None \
                else make_material("diffuse", {})

        def emit_mesh(verts, faces, normals=None, uvs=None, sphere_r=None):
            rec = dict(vertices=verts, faces=faces, normals=normals, uvs=uvs,
                       transform=gs.ctm.copy(),
                       transform_end=(gs.ctm_end.copy() if gs.is_animated
                                      else None),
                       material=mat,
                       emission=emission, escale=escale, two_sided=two_sided,
                       sphere_r=sphere_r,
                       med_inside=gs.med_inside, med_outside=gs.med_outside)
            if target is not None:
                target.append(rec)
            else:
                _instantiate(rec, np.eye(4, dtype=np.float32))

        if stype == "trianglemesh":
            P = pvec(params, "P").reshape(-1, 3)
            idx = np.asarray(params["indices"]["values"], np.int64).reshape(-1, 3)
            N = pvec(params, "N")
            N = N.reshape(-1, 3) if N is not None else None
            uv = pvec(params, "uv")
            uv = uv.reshape(-1, 2) if uv is not None else None
            emit_mesh(P, idx, N, uv)
        elif stype == "plymesh":
            fn = os.path.join(ts.base, pget(params, "filename"))
            mesh = ply_mod.read_ply(fn)
            emit_mesh(mesh["vertices"], mesh["faces"], mesh.get("normals"),
                      mesh.get("uvs"))
        elif stype == "loopsubdiv":
            P = pvec(params, "P").reshape(-1, 3)
            idx = np.asarray(params["indices"]["values"], np.int64).reshape(-1, 3)
            lv = int(pget(params, "levels", 3))
            v2, f2 = loopsubdiv.subdivide(P, idx, lv)
            emit_mesh(v2, f2)
        elif stype in ("sphere", "disk", "cylinder"):
            # ANALYTIC quadrics (shapes.h Sphere:107/Disk:404/Cylinder:574;
            # geometry/quadrics.py) — exact intersection, no tessellation
            r = float(pget(params, "radius", 1.0))
            rec = dict(quadric=stype, radius=r,
                       height=float(pget(params, "height", 0.0)),
                       zmin=float(pget(params, "zmin", -r)),
                       zmax=float(pget(params, "zmax", r)),
                       inner=float(pget(params, "innerradius", 0.0)),
                       transform=gs.ctm.copy(), material=mat,
                       emission=emission, escale=escale,
                       two_sided=two_sided,
                       med_inside=gs.med_inside, med_outside=gs.med_outside)
            if target is not None:
                target.append(rec)
            else:
                _instantiate(rec, np.eye(4, dtype=np.float32))
        elif stype == "curve":
            # Curve (shapes.h:1219): diced to camera-facing ribbons at scene
            # compile (geometry/curves.py; VERDICT r2 item 8 design)
            from . import curves as curves_mod

            ctrl = np.asarray(pvec(params, "P", np.zeros(12, np.float32)),
                              np.float32).reshape(-1, 3)
            w = pget(params, "width", 1.0)
            w0 = float(pget(params, "width0", w))
            w1 = float(pget(params, "width1", w))
            ckind = str(pget(params, "type", "flat"))
            cnorm = params.get("N")
            if cnorm is not None:
                cnorm = np.asarray(cnorm["values"], np.float32).reshape(-1, 3)[:2]
            basis = str(pget(params, "basis", "bezier"))
            # camera position in OBJECT space orients the frozen ribbons
            eye_w = res.cam_to_world[:3, 3]
            eye_o = xf.apply_points(np.linalg.inv(gs.ctm).astype(np.float32),
                                    eye_w[None])[0]
            v, f, uv, nrm = curves_mod.dice_curve_spans(
                ctrl, w0, w1, ckind, cnorm, eye_o, basis=basis)
            # per-vertex uv -> per-face-corner handled by emit_mesh via faces
            emit_mesh(v, f, normals=nrm, uvs=uv)
        elif stype == "bilinearmesh":
            # BilinearPatchMesh (shapes.h:1350). PLANAR patches split into
            # 2 triangles with exact corner UVs; NON-planar patches go to
            # the analytic Reshetov intersector (geometry/quadrics.py,
            # shapes.h:1279 IntersectBilinearPatch) — a 2-triangle split of
            # a twisted patch is silently wrong (VERDICT r3 missing #4).
            pts = np.asarray(pvec(params, "P", np.zeros(12, np.float32)),
                             np.float32).reshape(-1, 3)
            idx = np.asarray(pget(params, "indices", list(range(len(pts)))),
                             np.int64).reshape(-1, 4)
            uv_in = params.get("uv")
            faces = []
            patch_recs = []
            for (a, b, c, d) in idx:
                # pbrt bilinear patch corners: p00, p10, p01, p11
                pa, pb, pc, pd = pts[a], pts[b], pts[c], pts[d]
                nrm = np.cross(pb - pa, pc - pa)
                nl = np.linalg.norm(nrm)
                diag = max(np.linalg.norm(pd - pa), 1e-9)
                planar = nl < 1e-12 or \
                    abs(np.dot(pd - pa, nrm / max(nl, 1e-12))) < 1e-4 * diag
                if planar:
                    faces.append((a, b, d))
                    faces.append((a, d, c))
                else:
                    patch_recs.append((pa, pb, pc, pd))
            uvs = None
            if uv_in is not None:
                uvs = np.asarray(uv_in["values"], np.float32).reshape(-1, 2)
            else:
                base = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
                uvs = np.tile(base, (len(pts) // 4 + 1, 1))[:len(pts)]
            if faces:
                emit_mesh(pts, np.asarray(faces), uvs=uvs)
            for (pa, pb, pc, pd) in patch_recs:
                m4 = gs.ctm
                w = lambda q: xf.apply_points(m4, np.asarray(q, np.float32)[None])[0]
                builder.add_bilinear_patch(
                    w(pa), w(pb), w(pc), w(pd), mat,
                    med_inside=gs.med_inside, med_outside=gs.med_outside)
        else:
            warn(f"shape '{stype}' unsupported, skipped")

    def _instantiate(rec: dict, extra: np.ndarray):
        m = extra @ rec["transform"]
        te = rec.get("transform_end")
        m_end = extra @ te if te is not None else None
        if rec.get("quadric") is not None:
            # world-space canonical frame from the CTM; pbrt quadrics under
            # non-uniform scale are rare — approximated by the mean scale
            sc_cols = [float(np.linalg.norm(m[:3, i])) for i in range(3)]
            scl = float(np.mean(sc_cols))
            if max(sc_cols) > 1.02 * min(sc_cols):
                warn(f"quadric under anisotropic scale {sc_cols}: "
                     "using mean scale (tessellation fallback removed)")
            kind = rec["quadric"]
            h = rec.get("height", 0.0)
            c_obj = np.array([0.0, 0.0, h if kind == "disk" else 0.0],
                             np.float32)
            center = xf.apply_points(m, c_obj[None])[0]
            axis = m[:3, 2] / max(np.linalg.norm(m[:3, 2]), 1e-12)
            x_axis = m[:3, 0] / max(np.linalg.norm(m[:3, 0]), 1e-12)
            lid = -1
            if rec["emission"] is not None:
                if kind == "sphere":
                    lid = builder.add_sphere_area_light(
                        center, rec["radius"] * scl, rec["emission"],
                        rec["escale"], two_sided=rec["two_sided"],
                        n_theta=10**6)  # analytic: inscribed radius ~= r
                else:
                    warn(f"emissive analytic {kind} light unsupported, "
                         "emission dropped")
            builder.add_quadric(
                kind, center, rec["radius"] * scl, rec["material"],
                axis=axis,
                inner_radius=rec.get("inner", 0.0) * scl,
                zmin=rec.get("zmin", -1e30) * scl,
                zmax=rec.get("zmax", 1e30) * scl,
                light_id=lid,
                med_inside=rec.get("med_inside", -1),
                med_outside=rec.get("med_outside", -1))
            return
        if rec.get("sphere_r") is not None and rec["emission"] is not None:
            # emissive sphere shape: ONE analytic sphere area light per
            # instance (reference: Sphere shape + DiffuseAreaLight,
            # cone-sampled via Sphere::Sample, shapes.h:280), geometry
            # tessellated for visibility only
            center = xf.apply_points(m, np.zeros((1, 3), np.float32))[0]
            scl = float(np.linalg.norm(m[:3, 0]))
            lid = builder.add_sphere_area_light(
                center, rec["sphere_r"] * scl, rec["emission"],
                rec["escale"], two_sided=rec["two_sided"], n_theta=16)
            builder.add_mesh(
                rec["vertices"], rec["faces"], rec["material"],
                normals=rec["normals"], uvs=rec["uvs"], transform=m,
                light_id=lid,
                med_inside=rec.get("med_inside", -1),
                med_outside=rec.get("med_outside", -1),
                transform_end=m_end,
            )
            return
        builder.add_mesh(
            rec["vertices"], rec["faces"], rec["material"],
            normals=rec["normals"], uvs=rec["uvs"], transform=m,
            emission_rgb=rec["emission"], emission_scale=rec["escale"],
            two_sided=rec["two_sided"],
            med_inside=rec.get("med_inside", -1),
            med_outside=rec.get("med_outside", -1),
            transform_end=m_end,
        )

    while ts.peek() is not None:
        tok = ts.next()
        if tok == "Include" or tok == "Import":
            fn = _unquote(ts.next())
            sub = TokenStream(os.path.join(ts.base, fn))
            ts.insert(sub)
        elif tok == "LookAt":
            vals = [float(ts.next()) for _ in range(9)]
            # world->camera in pbrt; camera-to-world is its inverse
            w2c_inv = xf.look_at(vals[0:3], vals[3:6], vals[6:9])
            gs.apply_xf(lambda c: c @ np.linalg.inv(w2c_inv).astype(np.float32))
        elif tok == "Translate":
            tr = xf.translate([float(ts.next()) for _ in range(3)])
            gs.apply_xf(lambda c: c @ tr)
        elif tok == "Scale":
            sc_m = xf.scale([float(ts.next()) for _ in range(3)])
            gs.apply_xf(lambda c: c @ sc_m)
        elif tok == "Rotate":
            a = float(ts.next())
            axis = [float(ts.next()) for _ in range(3)]
            rot = xf.rotate(a, axis)
            gs.apply_xf(lambda c: c @ rot)
        elif tok in ("Transform", "ConcatTransform"):
            assert ts.next() == "["
            vals = []
            while ts.peek() != "]":
                vals.append(float(ts.next()))
            ts.next()
            m = np.asarray(vals, np.float32).reshape(4, 4).T  # column-major
            if tok == "Transform":
                gs.apply_xf(lambda c: m)
            else:
                gs.apply_xf(lambda c: c @ m)
        elif tok == "Identity":
            gs.apply_xf(lambda c: np.eye(4, dtype=np.float32))
        elif tok == "ActiveTransform":
            which = ts.next()
            gs.active = {"All": "all", "StartTime": "start",
                         "EndTime": "end"}.get(which, "all")
        elif tok == "TransformTimes":
            # shutter interval; our waves sample t in [0,1) stratified and
            # lerp keyframes, so only the EXISTENCE of the interval matters
            res.transform_times = (float(ts.next()), float(ts.next()))
        elif tok == "Camera":
            res.camera_kind = _unquote(ts.next())
            # reference captures graphicsState.currentOutsideMedium at the
            # Camera directive (scene.cpp:154): 'MediumInterface "fog"'
            # pre-world leaves the camera in vacuum
            builder.set_camera_medium(gs.med_outside)
            p = parse_params(ts)
            res.fov = float(pget(p, "fov", 90.0))
            res.lens_radius = float(pget(p, "lensradius", 0.0))
            res.focal_distance = float(pget(p, "focaldistance", 1e6))
            # CTM here is world->camera; camera-to-world = inverse
            res.cam_to_world = np.linalg.inv(gs.ctm).astype(np.float32)
        elif tok == "Film":
            _unquote(ts.next())
            p = parse_params(ts)
            res.width = int(pget(p, "xresolution", 640))
            res.height = int(pget(p, "yresolution", 480))
            res.filename = pget(p, "filename", "out.exr")
            # PixelSensor parameters (film.h:36): iso scales the imaging
            # ratio (iso/100); named sensors approximate to the XYZ sensor
            # (measured spectral response curves not vendored)
            res.iso = float(pget(p, "iso", 100.0))
            res.exposure = float(pget(p, "exposuretime", 1.0))
            wb = pget(p, "whitebalance", 0.0)
            res.white_balance = float(wb) if float(wb) > 0 else None
            res.sensor = pget(p, "sensor", "cie1931")
            if res.sensor != "cie1931":
                from ..core import named_spectra as _ns
                if not _ns.has(res.sensor + "_r"):
                    warn(f"sensor '{res.sensor}' unknown, XYZ sensor used")
        elif tok == "Sampler":
            res.sampler = _unquote(ts.next())
            p = parse_params(ts)
            res.spp = int(pget(p, "pixelsamples", 16))
        elif tok == "Integrator":
            res.integrator = _unquote(ts.next())
            p = parse_params(ts)
            res.max_depth = int(pget(p, "maxdepth", 5))
        elif tok in ("PixelFilter", "Accelerator", "ColorSpace", "Option"):
            _unquote(ts.next())
            parse_params(ts)
        elif tok == "WorldBegin":
            world = True
            gs = GraphicsState()
        elif tok == "WorldEnd":
            pass
        elif tok == "AttributeBegin":
            stack.append(gs.copy())
        elif tok == "AttributeEnd":
            gs = stack.pop()
        elif tok == "TransformBegin":
            stack.append(gs.copy())
        elif tok == "TransformEnd":
            prev = stack.pop()
            prev.material = gs.material
            prev.area_light = gs.area_light
            gs = prev
        elif tok == "ObjectBegin":
            name = _unquote(ts.next())
            objects[name] = []
            current_object = name
            stack.append(gs.copy())
        elif tok == "ObjectEnd":
            current_object = None
            gs = stack.pop()
        elif tok == "ObjectInstance":
            name = _unquote(ts.next())
            for rec in objects.get(name, []):
                _instantiate(rec, gs.ctm)
        elif tok == "ReverseOrientation":
            gs.reverse_orientation = not gs.reverse_orientation
        elif tok == "Material":
            mtype = _unquote(ts.next())
            p = parse_params(ts)
            gs.material = make_material(mtype, p)
        elif tok == "MakeNamedMaterial":
            name = _unquote(ts.next())
            p = parse_params(ts)
            mtype = pget(p, "type", "diffuse")
            named_materials[name] = make_material(mtype, p)
        elif tok == "NamedMaterial":
            name = _unquote(ts.next())
            gs.material = named_materials.get(name, gs.material)
        elif tok == "Texture":
            name = _unquote(ts.next())
            _unquote(ts.next())  # type (float/spectrum)
            cls = _unquote(ts.next())
            p = parse_params(ts)
            val = pvec(p, "value", np.array([0.5, 0.5, 0.5], np.float32))
            rec = {"class": cls, "value": np.atleast_1d(val), "params": p, "tex_id": -1}
            if cls == "imagemap":
                fn = pget(p, "filename", "")
                try:
                    from ..utils import image as image_mod

                    full = os.path.join(ts.base, fn)
                    if fn.endswith(".pfm"):
                        img = image_mod.read_pfm(full)
                    elif fn.endswith((".png", ".jpg", ".jpeg", ".tga")):
                        # 8-bit formats are sRGB-encoded (pbrt ColorEncoding
                        # sRGB for LDR images, util/color.h) -> linearize
                        if not fn.endswith(".png"):
                            raise NotImplementedError("only PNG of the 8-bit formats")
                        raw = image_mod.read_png(full)
                        img = np.where(raw <= 0.04045, raw / 12.92,
                                       ((raw + 0.055) / 1.055) ** 2.4)
                    else:
                        img = image_mod.read_exr(full)
                    rec["image"] = img
                    rec["value"] = img.mean((0, 1))
                    rec["tex_id"] = builder.add_texture_image(img)
                except Exception as e:
                    warn(f"imagemap '{fn}' unreadable ({type(e).__name__}), constant")
            elif cls == "scale":
                # scale-texture wrapper (textures.h ScaledTexture): resolve
                # the inner texture and materialize a scaled copy
                inner_name = pget(p, "tex", "")
                scl = float(pget(p, "scale", 1.0))
                inner = textures.get(inner_name) if isinstance(inner_name, str) else None
                if inner is None:
                    warn(f"scale texture '{name}': unknown inner '{inner_name}'")
                else:
                    rec["value"] = np.atleast_1d(inner["value"]) * scl
                    if inner.get("image") is not None:
                        img_s = inner["image"] * scl
                        rec["image"] = img_s
                        rec["tex_id"] = builder.add_texture_image(img_s)
            elif cls == "checkerboard":
                t1 = pvec(p, "tex1", np.array([0.1, 0.1, 0.1], np.float32))
                t2 = pvec(p, "tex2", np.array([0.9, 0.9, 0.9], np.float32))
                us = float(pget(p, "uscale", 8.0))
                if not (isinstance(t1, str) or isinstance(t2, str)):
                    rec["tex_id"] = builder.add_texture_checker(
                        np.broadcast_to(np.atleast_1d(t1), (3,)),
                        np.broadcast_to(np.atleast_1d(t2), (3,)), us)
            elif cls != "constant":
                warn(f"texture class '{cls}' approximated as constant")
            textures[name] = rec
        elif tok == "AreaLightSource":
            _unquote(ts.next())  # "diffuse"
            p = parse_params(ts)
            L = pvec(p, "L", np.array([1.0, 1, 1], np.float32))
            if "L" in p and p["L"]["type"] == "blackbody":
                # '"blackbody L" [5500]' (crown.pbrt:28): normalized
                # blackbody -> RGB chroma via the CIE curves
                L = _blackbody_rgb(float(np.atleast_1d(L)[0]))
            elif np.atleast_1d(L).size == 1:
                L = np.full(3, float(np.atleast_1d(L)[0]), np.float32)
            gs.area_light = {
                "L": L,
                "scale": float(pget(p, "scale", 1.0)),
                "twosided": bool(pget(p, "twosided", False)),
            }
        elif tok == "LightSource":
            ltype = _unquote(ts.next())
            p = parse_params(ts)
            sc = float(pget(p, "scale", 1.0))
            if ltype == "point":
                I = pvec(p, "I", np.array([1.0, 1, 1], np.float32))
                frm = pvec(p, "from", np.zeros(3, np.float32))
                pos = xf.apply_points(gs.ctm, frm[None])[0]
                m = float(max(I.max(), 1e-9))
                builder.add_point_light(pos, I / m, scale=sc * m)
            elif ltype == "distant":
                L = pvec(p, "L", np.array([1.0, 1, 1], np.float32))
                frm = pvec(p, "from", np.zeros(3, np.float32))
                to = pvec(p, "to", np.array([0.0, 0, 1], np.float32))
                d = xf.apply_vectors(gs.ctm, (frm - to)[None])[0]  # toward light
                m = float(max(L.max(), 1e-9))
                builder.add_distant_light(d, L / m, scale=sc * m)
            elif ltype == "infinite":
                fn = pget(p, "filename")
                if fn is not None:
                    try:
                        from ..utils import image as image_mod

                        full = os.path.join(ts.base, fn)
                        img = (image_mod.read_pfm(full) if fn.endswith(".pfm")
                               else image_mod.read_exr(full))
                        # pbrt-v4 infinite maps are equal-area octahedral
                        builder.set_environment_map(img, scale=sc)
                    except Exception as e:
                        warn(f"env map '{fn}' unreadable ({type(e).__name__}), uniform")
                        builder.add_uniform_infinite_light((1, 1, 1), scale=sc)
                else:
                    L = pvec(p, "L", np.array([1.0, 1, 1], np.float32))
                    m = float(max(np.max(np.atleast_1d(L)), 1e-9))
                    builder.add_uniform_infinite_light(np.asarray(L) / m, scale=sc * m)
            else:
                warn(f"light '{ltype}' unsupported, skipped")
        elif tok == "Shape":
            stype = _unquote(ts.next())
            p = parse_params(ts)
            add_shape(stype, p)
        elif tok == "MakeNamedMedium":
            # scene.cpp:909 CreateMedia: register a named medium with the
            # builder; grids carry world bounds from the CTM
            mname = _unquote(ts.next())
            p = parse_params(ts)
            mtype = pget(p, "type", "homogeneous")
            sigma_a = np.atleast_1d(pvec(p, "sigma_a",
                                         np.ones(3, np.float32)))
            sigma_s = np.atleast_1d(pvec(p, "sigma_s",
                                         np.ones(3, np.float32)))
            if sigma_a.size == 1:
                sigma_a = np.full(3, float(sigma_a), np.float32)
            if sigma_s.size == 1:
                sigma_s = np.full(3, float(sigma_s), np.float32)
            mscale = float(pget(p, "scale", 1.0))
            mg = float(pget(p, "g", 0.0))
            Le = np.atleast_1d(pvec(p, "Le", np.zeros(3, np.float32)))
            if Le.size == 1:
                Le = np.full(3, float(Le), np.float32)
            le_scale = float(pget(p, "Lescale", 1.0)) if np.any(Le > 0) else 0.0
            if mtype == "cloud":
                pass  # procedural; "float density" is a SCALE knob, not a grid
            if mtype in ("uniformgrid", "rgbgrid", "nanovdb") \
                    and "density" in p:
                nx = int(pget(p, "nx", 1))
                ny = int(pget(p, "ny", 1))
                nz = int(pget(p, "nz", 1))
                dens = np.asarray(p["density"]["values"],
                                  np.float32).reshape(nz, ny, nx)
                p0 = np.asarray(pvec(p, "p0", np.zeros(3, np.float32)),
                                np.float32)
                p1 = np.asarray(pvec(p, "p1", np.ones(3, np.float32)),
                                np.float32)
                corners = np.array([[p0[0], p0[1], p0[2]],
                                    [p1[0], p0[1], p0[2]],
                                    [p0[0], p1[1], p0[2]],
                                    [p0[0], p0[1], p1[2]],
                                    [p1[0], p1[1], p0[2]],
                                    [p1[0], p0[1], p1[2]],
                                    [p0[0], p1[1], p1[2]],
                                    [p1[0], p1[1], p1[2]]], np.float32)
                wc = xf.apply_points(gs.ctm, corners)
                bounds = np.stack([wc.min(0), wc.max(0)])
                mid = builder.add_medium(
                    "grid", sigma_a=sigma_a, sigma_s=sigma_s, scale=mscale,
                    g=mg, Le=Le, Le_scale=le_scale, density=dens,
                    bounds=bounds)
            elif mtype == "cloud":
                # CloudMedium (media.h:430): procedural noise density, baked
                # onto a grid in medium space (utils/noise.cloud_density)
                from ..utils import noise as noise_mod

                dens = noise_mod.cloud_density_grid(
                    density=float(pget(p, "density", 1.0)),
                    wispiness=float(pget(p, "wispiness", 1.0)),
                    frequency=float(pget(p, "frequency", 5.0)))
                p0 = np.asarray(pvec(p, "p0", np.zeros(3, np.float32)),
                                np.float32)
                p1 = np.asarray(pvec(p, "p1", np.ones(3, np.float32)),
                                np.float32)
                corners = np.stack([np.where(np.array(
                    [(i >> k) & 1 for k in range(3)], bool), p1, p0)
                    for i in range(8)])
                wc = xf.apply_points(gs.ctm, corners.astype(np.float32))
                mid = builder.add_medium(
                    "grid", sigma_a=sigma_a, sigma_s=sigma_s, scale=mscale,
                    g=mg, Le=Le, Le_scale=le_scale, density=dens,
                    bounds=np.stack([wc.min(0), wc.max(0)]))
            else:
                if mtype not in ("homogeneous",):
                    warn(f"medium type '{mtype}' approximated as homogeneous")
                mid = builder.add_medium(
                    "homogeneous", sigma_a=sigma_a, sigma_s=sigma_s,
                    scale=mscale, g=mg, Le=Le, Le_scale=le_scale)
            named_media[mname] = mid
        elif tok == "MediumInterface":
            # two quoted names; "" = vacuum (scene.cpp MediumInterface)
            inside = _unquote(ts.next())
            outside = ""
            if ts.peek() is not None and ts.peek().startswith('"'):
                outside = _unquote(ts.next())
            gs.med_inside = named_media.get(inside, -1) if inside else -1
            gs.med_outside = named_media.get(outside, -1) if outside else -1
            if inside and inside not in named_media:
                warn(f"unknown medium '{inside}'")
        elif tok == "Attribute":
            _unquote(ts.next())
            parse_params(ts)
            warn("Attribute directive unsupported, skipped")
        else:
            # unknown directive: consume its params defensively
            warn(f"directive '{tok}' unsupported, skipped")
            parse_params(ts)

    return res


def load_scene(path: str):
    """Parse + compile + BVH-build (native SAH) a .pbrt scene on the host.
    Returns (CompiledScene, DeviceBVH, Camera, ParseResult), numpy tables
    that the renderers upload."""
    from .. import accel
    from ..wavefront import camera as camera_mod

    res = parse_file(path)
    sc = res.builder.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        res.cam_to_world, res.fov, res.width, res.height,
        res.lens_radius, res.focal_distance,
    )
    return sc, dbvh, cam, res
