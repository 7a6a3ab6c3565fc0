"""Scene compilation: host builder -> SoA tables (port of the subset of
nn_bvh_tpu/geometry/scene.py the port renders).

`SceneBuilder.build()` returns a `CompiledScene` of host numpy arrays, laid
out exactly as the JAX package lays them out (same material/light tags, same
parameter columns, same fused `tri_shade` record, same placeholder tables).
`to_device` turns it into float32/int32 tensors on one device. `scene_from_numpy`
carries a JAX-built scene and BVH across as numpy arrays, so tests render the
very same tables in both packages.

Every feature of the JAX builder: every material (diffuse, conductor,
dielectric, thin dielectric, diffuse transmission, coated diffuse, coated
conductor, mix, hair, measured, subsurface; named-spectrum eta and k), with
image, checkerboard and procedural textures packed into one mip atlas
(geometry/texture.py) for reflectance and mix amounts; point, distant,
spot, projection, goniometric, uniform-infinite, image-infinite (equal-area
env map) and portal env lights, per-triangle and analytic sphere area
lights; analytic quadrics and bilinear patches; object motion blur
(shutter-end vertex tables); homogeneous and grid participating media (the
cloud, rgbgrid and nanovdb kinds are grids) with their medium interfaces.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import rgb2spec
from . import transform as xf

# material tags (same values as the JAX package)
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_THIN_DIELECTRIC = 3
MAT_DIFFUSE_TRANSMISSION = 4
MAT_COATED_DIFFUSE = 5
MAT_COATED_CONDUCTOR = 6
MAT_MIX = 7
MAT_HAIR = 8
MAT_MEASURED = 9
MAT_SUBSURFACE = 10  # smooth dielectric entry + tabulated BSSRDF (scatter/bssrdf.py)
MAT_SSS_EXIT = 11    # virtual: the exit lobe a subsurface lane takes after its
#   probe (wavefront/subsurface.py); never in mat_type
MAT_INTERFACE = -1   # no material (a medium boundary)
# light tags (same values as the JAX package)
LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_UNIFORM_INFINITE = 2
LIGHT_AREA_TRI = 3
LIGHT_IMAGE_INFINITE = 4
LIGHT_SPOT = 5
LIGHT_PROJECTION = 6
LIGHT_GONIOMETRIC = 7
LIGHT_PORTAL_ENV = 8
LIGHT_SPHERE_AREA = 9
# light_params by tag (scatter/lights.sample_li):
#   AREA_TRI:    [0] tri_index [1] two_sided
#   SPOT:        [0:3] direction [3] cos_total_width [4] cos_falloff_start
#   SPHERE_AREA: [0] radius [1] two_sided [2] inscribed tessellation radius
#   PORTAL_ENV:  [0:12] portal corners p0 p1 p2 p3
# light_params by tag, continued:
#   PROJECTION:  [0:3] direction [3] tan_half_x [4] tan_half_y [5] tex_id [6:9] up
#   GONIOMETRIC: [5] tex_id (equal-area octahedral intensity map)
TEX_RES = 256  # bake resolution of analytic (checker, procedural) textures
# media (same values as the JAX package; cloud, rgbgrid and nanovdb are grids)
MED_HOMOGENEOUS = 0
MED_GRID = 1
MED_GRID_RES = 64  # density grids resampled to a fixed-size stack
MAJ_GRID_RES = 16  # low-res conservative majorant grid

N_MAT_PARAMS = 12   # [rough_u, rough_v, eta, k, transmittance, texture, mix_a,
#  mix_b, mix_amount, coat_roughness, eta_tab, k_tab]
N_LIGHT_PARAMS = 12

SLICE_MATERIALS = tuple(range(MAT_SUBSURFACE + 1))
SLICE_LIGHTS = tuple(range(LIGHT_SPHERE_AREA + 1))

_INT_FIELDS = ("tri_mat", "tri_light", "mat_type", "light_type", "med_type",
               "med_grid_id", "med_temp_grid_id", "tri_med_inside", "tri_med_outside",
               "quad_type", "quad_mat", "quad_light", "quad_med", "tex_desc")
_STATIC_INTS = ("n_tris", "n_lights", "n_media", "camera_medium", "n_quadrics")
# static feature gates (the JAX names): which optional lobes, stages and
# light branches a wave computes at all
_STATIC_FLAGS = ("feat_mix", "feat_hair", "feat_measured", "feat_spectral",
                 "feat_subsurface", "feat_coated", "feat_portal")


class CompiledScene(NamedTuple):
    """Frozen scene tables: host numpy after `build`, tensors after
    `to_device`. Triangles are padded to a multiple of 128 with degenerate
    all-zero triangles (no intersector accepts det == 0)."""

    tri_p: object        # (N, 3, 3) f32 vertex positions
    tri_n: object        # (N, 3, 3) f32 shading normals
    tri_uv: object       # (N, 3, 2) f32
    tri_mat: object      # (N,) i32 material id (-1 = none)
    tri_light: object    # (N,) i32 area-light id (-1 = not emissive)
    n_tris: int          # unpadded triangle count
    mat_type: object     # (M,) i32
    mat_coeffs: object   # (M, 3) f32 sigmoid-poly coefficients of base color
    mat_scale: object    # (M,) f32
    mat_params: object   # (M, N_MAT_PARAMS) f32
    light_type: object   # (L,) i32
    light_pos: object    # (L, 3) f32
    light_coeffs: object  # (L, 3) f32
    light_scale: object  # (L,) f32
    light_params: object  # (L, N_LIGHT_PARAMS) f32
    n_lights: int
    bounds: object       # (2, 3) f32
    tri_shade: object    # (N, 28) f32 fused shading record: v0 v1 v2 | n0 n1 n2
    #   | uv0 uv1 uv2 | mat_id | light_id | med_inside | med_outside
    # textures (geometry/texture.py): every mip level of every texture as
    # per-texel sigmoid-poly coefficients [c0, c1, c2, scale] in one flat
    # atlas; the 1-texel placeholder means none
    tex_atlas: object = None        # (Ntexels, 4)
    tex_desc: object = None         # (T, LMAX, 3) i32 [offset, width, height]
    # participating media (fused per lane by scatter.media.medium_records)
    med_type: object = None         # (K,) i32
    med_sa_coeffs: object = None    # (K, 3) sigma_a sigmoid-poly chroma
    med_ss_coeffs: object = None    # (K, 3) sigma_s
    med_le_coeffs: object = None    # (K, 3) emission chroma
    med_scales: object = None       # (K, 4) [sigma_a scale, sigma_s scale, le scale, g]
    med_grid_id: object = None      # (K,) i32 index into med_grids (-1 = none)
    med_max_density: object = None  # (K,) majorant density (1 for homogeneous)
    med_bounds: object = None       # (K, 2, 3) world AABB of the density grid
    med_grids: object = None        # (G, D, H, W) density stack
    med_temp_grids: object = None   # (G2, D, H, W) Kelvin temperature stack
    med_temp_grid_id: object = None  # (K,) i32 (-1 = RGB Le)
    med_maj_grids: object = None    # (G, MAJ, MAJ, MAJ) supervoxel majorants
    n_media: int = 0
    camera_medium: int = -1         # the medium the camera sits in
    tri_med_inside: object = None   # (N,) i32 medium behind the geometric normal
    tri_med_outside: object = None  # (N,) i32 medium the normal points into
    # measured BRDFs: (T, No, Ni, Np, 4) uplift coefficients over (mu_o,
    # mu_i, dphi) (scatter/measured.py); the 1-entry zero table means none
    measured_coeffs: object = None
    measured_alpha: object = None   # (T,) fitted GGX proxy-sampler roughness
    # named-spectrum tables (S, 471) on the 1-nm grid (core/named_spectra.dense),
    # indexed by mat_params[10] (eta) and [11] (k); None without any
    spec_tables: object = None
    # subsurface materials (scatter/bssrdf.py), one row each; mat_params[3]
    # of a MAT_SUBSURFACE row holds its row id
    sss_coeffs_a: object = None   # (S, 3) sigma_a sigmoid-poly chroma
    sss_scale_a: object = None    # (S,)
    sss_coeffs_s: object = None   # (S, 3) sigma_s
    sss_scale_s: object = None    # (S,)
    sss_g: object = None          # (S,)
    sss_profile: object = None    # (S, 64, 64) r * Sr at unit sigma_t
    sss_cdf: object = None        # (S, 64, 64)
    sss_rho_eff: object = None    # (S, 64)
    sss_radius: object = None     # (64,)
    sss_rho: object = None        # (64,)
    # equal-area env map (ImageInfiniteLight): coefficient image and the
    # luminance sampling tables; 1-entry placeholders without one
    env_coeffs: object = None     # (He, We, 4)
    env_cond_cdf: object = None   # (He, We+1)
    env_marg_cdf: object = None   # (He+1,)
    env_marg_func: object = None  # (He,)
    env_luminance: object = None  # (He, We) normalised sampling function
    # portal warp (scatter/portal.py): rectified env image, SAT, frame rows
    portal_img_coeffs: object = None  # (Rp, Rp, 4)
    portal_sat: object = None         # (Rp+1, Rp+1)
    portal_frame: object = None       # (3, 3)
    # object motion blur: shutter-end copies of the vertex tables (None when
    # static); a wave lerps them at its shutter time
    tri_p_end: object = None      # (N, 3, 3)
    tri_n_end: object = None      # (N, 3, 3)
    tri_shade_end: object = None  # like tri_shade
    # analytic quadrics (geometry/quadrics.py); prim ids above the padded
    # triangle range, their mat/light/medium in tri_shade's appended rows
    quad_type: object = None      # (Q,) i32
    quad_params: object = None    # (Q, 13)
    quad_uv_scale: object = None  # (Q,)
    quad_mat: object = None       # (Q,) i32
    quad_light: object = None     # (Q,) i32
    quad_med: object = None       # (Q, 2) i32 [inside, outside]
    n_quadrics: int = 0
    feat_mix: bool = False
    feat_hair: bool = False
    feat_measured: bool = False
    feat_spectral: bool = False
    feat_subsurface: bool = False
    feat_coated: bool = False
    feat_portal: bool = False

    def replace(self, **kw) -> "CompiledScene":
        return self._replace(**kw)


def host(x) -> np.ndarray:
    """Host numpy view of a numpy array or tensor (set-up code only)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_tri_shade(scene: CompiledScene, use_end: bool = False) -> np.ndarray:
    """The (N + Q, 28) record: one row per triangle (the shutter-end
    vertices with use_end), then one per quadric, whose only meaningful
    columns are material, light and media."""
    tp = host(scene.tri_p_end if use_end else scene.tri_p).astype(np.float32)
    tn = host(scene.tri_n_end if use_end else scene.tri_n).astype(np.float32)
    n = len(tp)
    nq = int(scene.n_quadrics or 0)
    out = np.zeros((n + nq, 28), np.float32)
    out[:n, 0:9] = tp.reshape(n, 9)
    out[:n, 9:18] = tn.reshape(n, 9)
    out[:n, 18:24] = host(scene.tri_uv).astype(np.float32).reshape(n, 6)
    out[:n, 24] = host(scene.tri_mat).astype(np.float32)
    out[:n, 25] = host(scene.tri_light).astype(np.float32)
    if scene.tri_med_inside is not None:
        out[:n, 26] = host(scene.tri_med_inside).astype(np.float32)
        out[:n, 27] = host(scene.tri_med_outside).astype(np.float32)
    else:
        out[:n, 26:28] = -1.0
    if nq:
        out[n:, 24] = host(scene.quad_mat).astype(np.float32)
        out[n:, 25] = host(scene.quad_light).astype(np.float32)
        out[n:, 26:28] = host(scene.quad_med).astype(np.float32)
    return out


def majorant_grid(dens: np.ndarray, res: int = MAJ_GRID_RES) -> np.ndarray:
    """Conservative low-res majorant of a density grid: the supervoxel max
    over the covered fine voxels, dilated by one fine voxel on every side so
    the trilinear density field (which reads neighbour samples) is bounded
    everywhere inside the supervoxel."""
    d = np.asarray(dens, np.float32)
    D, H, W = d.shape
    pad = np.pad(d, 1, mode="edge")
    out = np.zeros((res, res, res), np.float32)
    zb = [int(np.floor(i * D / res)) for i in range(res + 1)]
    yb = [int(np.floor(i * H / res)) for i in range(res + 1)]
    xb = [int(np.floor(i * W / res)) for i in range(res + 1)]
    for z in range(res):
        for y in range(res):
            for x in range(res):
                out[z, y, x] = pad[zb[z]:zb[z + 1] + 2, yb[y]:yb[y + 1] + 2,
                                   xb[x]:xb[x + 1] + 2].max()
    return out


def _resample(grid, r: int = MED_GRID_RES) -> np.ndarray:
    """Nearest resample of a (D, H, W) grid to the r^3 stack resolution."""
    g = np.asarray(grid, np.float32)
    zi = (np.arange(r) * (g.shape[0] / r)).astype(np.int64)
    yi = (np.arange(r) * (g.shape[1] / r)).astype(np.int64)
    xi = (np.arange(r) * (g.shape[2] / r)).astype(np.int64)
    return g[zi][:, yi][:, :, xi]


def to_device(scene: CompiledScene, device) -> CompiledScene:
    """Upload every table once, as float32 / int32 tensors on `device`."""
    def up(name, v):
        if name in _STATIC_INTS:
            return int(v)
        if name in _STATIC_FLAGS:
            return bool(v)
        if v is None:
            return None
        dt = torch.int32 if name in _INT_FIELDS else torch.float32
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.array(v))
        return v.to(device=device, dtype=dt).contiguous()

    return CompiledScene(**{k: up(k, v) for k, v in scene._asdict().items()})


def check_slice(fields: dict) -> None:
    """Raise ValueError for material or light tags the port does not know
    (keys and values as in the JAX CompiledScene)."""
    bad_mats = set(np.unique(host(fields["mat_type"])).tolist()) - set(SLICE_MATERIALS)
    if bad_mats:
        raise ValueError(f"material tags {sorted(bad_mats)} are unknown")
    bad_lights = set(np.unique(host(fields["light_type"])).tolist()) - set(SLICE_LIGHTS)
    if bad_lights:
        raise ValueError(f"light tags {sorted(bad_lights)} are unknown")


def scene_from_numpy(fields: dict, bvh_fields: dict, device):
    """JAX CompiledScene + DeviceBVH, given as dicts of numpy arrays
    (np.asarray of each field) -> (port CompiledScene, port DeviceBVH), both
    as tensors on `device`. The differentiable parameters (mat_coeffs,
    light_scale) come across like every other table, and so do the media
    tables and the medium interfaces."""
    from ..accel.traverse import DeviceBVH

    check_slice(fields)
    sc = CompiledScene(**{k: fields[k] for k in CompiledScene._fields})
    bvh = DeviceBVH(
        node_lo=torch.as_tensor(host(bvh_fields["node_lo"]), device=device).float(),
        node_hi=torch.as_tensor(host(bvh_fields["node_hi"]), device=device).float(),
        node_meta=torch.as_tensor(host(bvh_fields["node_meta"]), device=device).int(),
        n_nodes=int(bvh_fields["n_nodes"]))
    return to_device(sc, device), bvh


class SceneBuilder:
    """Accumulates meshes/materials/lights on the host, then compiles."""

    def __init__(self):
        self._tri_p, self._tri_n, self._tri_uv, self._tri_mat = [], [], [], []
        self._tri_emit = []   # (rgb, scale, two_sided) or None per mesh
        self._tri_med = []    # (med_inside, med_outside) per mesh
        self._materials = []
        self._lights = []
        self._media = []
        self._measured = []      # (No, Ni, Np, 3) RGB tables
        self._sss = []           # subsurface rows
        self._spec_tables = []   # (471,) dense spectra
        self._spec_names = {}    # name -> row of _spec_tables
        self._camera_medium = -1
        self._tri_pe, self._tri_ne = [], []  # shutter-end vertices/normals or None
        self._quadrics = []
        self._env_image = None   # (He, We, 3) equal-area RGB
        self._textures = []      # native-resolution (H, W, 3) RGB images
        self.atlas_seconds = 0.0  # host time of the last build's atlas packing

    def add_texture_image(self, rgb_image) -> int:
        """An RGB image texture at its native resolution (its mip pyramid is
        built by `build`) -> its id for add_material(texture=)."""
        self._textures.append(np.asarray(rgb_image, np.float32))
        return len(self._textures) - 1

    def add_texture_checker(self, rgb1=(0.1, 0.1, 0.1), rgb2=(0.9, 0.9, 0.9),
                            uscale: float = 8.0) -> int:
        """A checkerboard of uscale squares per uv unit, baked at TEX_RES."""
        t = (np.arange(TEX_RES) * uscale / TEX_RES).astype(np.int64)
        par = (t[:, None] + t[None, :]) % 2
        img = np.where(par[..., None] > 0, np.asarray(rgb2, np.float32),
                       np.asarray(rgb1, np.float32))
        self._textures.append(img.astype(np.float32))
        return len(self._textures) - 1

    def add_texture_procedural(self, kind: str, scale: float = 8.0, octaves: int = 6,
                               omega: float = 0.5, seed: int = 0,
                               rgb1=(0.12, 0.1, 0.08), rgb2=(0.9, 0.88, 0.82)) -> int:
        """A procedural texture (fbm, wrinkled, windy, marble, dots) baked over
        uv space at TEX_RES (utils/noise.bake)."""
        from ..utils import noise

        self._textures.append(noise.bake(kind, res=TEX_RES, scale=scale, octaves=octaves,
                                         omega=omega, seed=seed, rgb1=rgb1, rgb2=rgb2))
        return len(self._textures) - 1

    def add_material(self, kind: str = "diffuse", reflectance=(0.5, 0.5, 0.5),
                     roughness: float = 0.0, eta: float | None = None, k: float = 3.9,
                     transmittance: float = 0.0, texture: int = -1,
                     coat_roughness: float = 0.0, mix_materials: tuple = (-1, -1),
                     mix_amount: float = 0.5, beta_n: float | None = None,
                     measured: int = -1, eta_spectrum=None, k_spectrum=None,
                     sigma_a=(0.0011, 0.0024, 0.014), sigma_s=(2.55, 3.21, 3.77),
                     sss_scale: float = 1.0, g: float = 0.0) -> int:
        """A material row, as the JAX builder writes it. coateddiffuse and
        coatedconductor put a dielectric coat (eta, coat_roughness) over the
        base lobe; mix picks mix_materials[1] with probability mix_amount per
        hit, else mix_materials[0] (an amount below 0 is -(texture id + 1):
        the texture's value at the hit); `texture` (an add_texture_* id)
        gives the base color per hit; hair takes roughness as beta_m and
        beta_n (default beta_m), its reflectance sets sigma_a; measured
        names an add_measured_brdf table; subsurface takes sigma_a,
        sigma_s (RGB, times sss_scale), g and eta. eta=None is 1.33 for
        subsurface and 1.5 otherwise. The subsurface row id and the measured
        table id ride in the k slot; a named-spectrum eta or k
        (eta_spectrum / k_spectrum: a name, .spd path, (lam, val) pair or
        dense table) sets the scalar to the table's median."""
        kinds = {"diffuse": MAT_DIFFUSE, "conductor": MAT_CONDUCTOR,
                 "dielectric": MAT_DIELECTRIC, "thindielectric": MAT_THIN_DIELECTRIC,
                 "diffusetransmission": MAT_DIFFUSE_TRANSMISSION,
                 "coateddiffuse": MAT_COATED_DIFFUSE,
                 "coatedconductor": MAT_COATED_CONDUCTOR, "mix": MAT_MIX,
                 "hair": MAT_HAIR, "measured": MAT_MEASURED,
                 "subsurface": MAT_SUBSURFACE}
        if eta is None:
            eta = 1.33 if kind == "subsurface" else 1.5
        if kind == "subsurface":
            k = float(len(self._sss))
            self._sss.append(dict(sigma_a=np.asarray(sigma_a, np.float32),
                                  sigma_s=np.asarray(sigma_s, np.float32),
                                  scale=float(sss_scale), g=float(g), eta=float(eta)))
        if kind == "measured":
            k = float(measured)
        eta_tab = k_tab = -1.0
        if eta_spectrum is not None:
            eta_tab = float(self.add_spectrum_table(eta_spectrum))
            eta = float(np.median(self._spec_tables[int(eta_tab)]))
        if k_spectrum is not None:
            k_tab = float(self.add_spectrum_table(k_spectrum))
            k = float(np.median(self._spec_tables[int(k_tab)]))
        second_rough = roughness if beta_n is None else beta_n
        params = np.array([roughness, second_rough, eta, k, transmittance, float(texture),
                           float(mix_materials[0]), float(mix_materials[1]), mix_amount,
                           coat_roughness, eta_tab, k_tab], np.float32)
        self._materials.append(dict(
            type=kinds[kind], reflectance=np.asarray(reflectance, np.float32),
            params=params))
        return len(self._materials) - 1

    def add_measured_brdf(self, table_rgb) -> int:
        """A measured BRDF: an (No, Ni, Np, 3) RGB grid over (mu_o, mu_i,
        dphi) (scatter/measured.tabulate, bsdf_to_table, load_table) ->
        its id for add_material("measured", measured=id). The tables of one
        scene share a resolution."""
        self._measured.append(np.asarray(table_rgb, np.float32))
        return len(self._measured) - 1

    def add_spectrum_table(self, spec) -> int:
        """A named spectrum (name or .spd path), (lam, val) pair or dense
        (471,) array -> its row in spec_tables; one row per name."""
        from ..core import named_spectra

        key = spec if isinstance(spec, str) else None
        if key is not None and key in self._spec_names:
            return self._spec_names[key]
        dense = (np.asarray(spec, np.float32)
                 if isinstance(spec, np.ndarray) and spec.ndim == 1
                 and spec.shape[0] == named_spectra.DENSE_N
                 else named_spectra.dense(spec))
        self._spec_tables.append(dense.astype(np.float32))
        idx = len(self._spec_tables) - 1
        if key is not None:
            self._spec_names[key] = idx
        return idx

    def _build_sss(self) -> dict:
        """The subsurface tables: one beam-diffusion table per subsurface
        material, built with its g and eta, and its sigma chromas as
        sigmoid-poly coefficients with scales (the JAX builder's layout;
        nothing without a subsurface material)."""
        if not self._sss:
            return {}
        from ..scatter import bssrdf

        ca, sca = rgb2spec.rgb_to_coeffs_host(np.stack([m["sigma_a"] for m in self._sss]))
        cs, scs = rgb2spec.rgb_to_coeffs_host(np.stack([m["sigma_s"] for m in self._sss]))
        scale = np.array([m["scale"] for m in self._sss], np.float32)
        tabs = [bssrdf.compute_beam_diffusion_table(m["g"], m["eta"]) for m in self._sss]
        return dict(
            sss_coeffs_a=ca.astype(np.float32), sss_scale_a=(sca * scale).astype(np.float32),
            sss_coeffs_s=cs.astype(np.float32), sss_scale_s=(scs * scale).astype(np.float32),
            sss_g=np.array([m["g"] for m in self._sss], np.float32),
            sss_profile=np.stack([t.profile for t in tabs]),
            sss_cdf=np.stack([t.cdf for t in tabs]),
            sss_rho_eff=np.stack([t.rho_eff for t in tabs]),
            sss_radius=tabs[0].radius, sss_rho=tabs[0].rho)

    def _add_light(self, kind: int, pos, rgb, scale: float, params=None) -> int:
        self._lights.append(dict(
            type=kind, pos=np.asarray(pos, np.float32), rgb=np.asarray(rgb, np.float32),
            scale=scale,
            params=np.zeros(N_LIGHT_PARAMS, np.float32) if params is None else params))
        return len(self._lights) - 1

    def add_uniform_infinite_light(self, radiance_rgb=(1, 1, 1),
                                   scale: float = 1.0) -> int:
        return self._add_light(LIGHT_UNIFORM_INFINITE, np.zeros(3), radiance_rgb, scale)

    def add_point_light(self, position, intensity_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        return self._add_light(LIGHT_POINT, position, intensity_rgb, scale)

    def add_distant_light(self, direction, radiance_rgb=(1, 1, 1), scale: float = 1.0) -> int:
        """`direction` points toward the light."""
        d = np.asarray(direction, np.float64)
        return self._add_light(LIGHT_DISTANT, (d / np.linalg.norm(d)).astype(np.float32),
                               radiance_rgb, scale)

    def add_spot_light(self, position, direction, intensity_rgb=(1, 1, 1),
                       scale: float = 1.0, cone_angle: float = 30.0,
                       cone_delta: float = 5.0) -> int:
        """Smooth falloff between cone_angle - cone_delta and cone_angle
        (degrees, pbrt's coneangle / conedeltaangle)."""
        d = np.asarray(direction, np.float64)
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:3] = (d / np.linalg.norm(d)).astype(np.float32)
        params[3] = np.cos(np.deg2rad(cone_angle))
        params[4] = np.cos(np.deg2rad(max(cone_angle - cone_delta, 0.0)))
        return self._add_light(LIGHT_SPOT, position, intensity_rgb, scale, params)

    def add_projection_light(self, position, direction, image, scale: float = 1.0,
                             fov: float = 45.0, up=(0, 1, 0)) -> int:
        """A slide projector: `image` (an RGB texture) over a square frustum
        of `fov` degrees about `direction`."""
        d = np.asarray(direction, np.float64)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:3] = d
        params[3] = params[4] = np.tan(np.deg2rad(fov) / 2)
        params[5] = self.add_texture_image(image)
        u = np.asarray(up, np.float64)
        u = u - d * np.dot(u, d)
        params[6:9] = (u / max(np.linalg.norm(u), 1e-9)).astype(np.float32)
        return self._add_light(LIGHT_PROJECTION, position, np.ones(3), scale, params)

    def add_goniometric_light(self, position, intensity_map, intensity_rgb=(1, 1, 1),
                              scale: float = 1.0) -> int:
        """A point light whose intensity over directions is `intensity_map`,
        an equal-area octahedral RGB image."""
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[5] = self.add_texture_image(intensity_map)
        return self._add_light(LIGHT_GONIOMETRIC, position, intensity_rgb, scale, params)

    def set_environment_map(self, equal_area_rgb, scale: float = 1.0) -> int:
        """An image infinite light: an equal-area octahedral radiance map."""
        self._env_image = np.asarray(equal_area_rgb, np.float32)
        return self._add_light(LIGHT_IMAGE_INFINITE, np.zeros(3), np.ones(3), scale)

    def add_portal(self, p0, p1, p2, p3) -> int:
        """Turn the env light into a portal light: its sampling is restricted
        to the solid angle of the planar quad p0 p1 p2 p3."""
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0:12] = np.concatenate([np.asarray(x, np.float32) for x in (p0, p1, p2, p3)])
        for i, light in enumerate(self._lights):
            if light["type"] == LIGHT_IMAGE_INFINITE:
                light["type"] = LIGHT_PORTAL_ENV
                light["params"] = params
                return i
        raise ValueError("add_portal requires set_environment_map first")

    def add_sphere_area_light(self, center, radius, emission_rgb,
                              emission_scale: float = 1.0, two_sided: bool = False,
                              n_theta: int = 16) -> int:
        """One analytic sphere area light record; the caller adds the
        tessellated geometry with this light_id. params[2] is the
        tessellation's inscribed radius, which bounds the light's shadow rays
        so its own mesh never occludes its analytic sample points."""
        params = np.zeros(N_LIGHT_PARAMS, np.float32)
        params[0] = float(radius)
        params[1] = 1.0 if two_sided else 0.0
        params[2] = float(radius) * float(np.cos(np.pi / max(n_theta, 3))) * 0.999
        return self._add_light(LIGHT_SPHERE_AREA, center, emission_rgb,
                               float(emission_scale), params)

    def add_quadric(self, kind: str, center, radius: float, material: int,
                    axis=(0.0, 0.0, 1.0), inner_radius: float = 0.0,
                    zmin: float = -1e30, zmax: float = 1e30, light_id: int = -1,
                    med_inside: int = -1, med_outside: int = -1) -> int:
        """An analytic sphere, disk or cylinder (geometry/quadrics.py)."""
        from . import quadrics

        qt, qp = quadrics.make_record(kind, center, radius, axis=axis,
                                      inner_radius=inner_radius, zmin=zmin, zmax=zmax)
        return self._add_quadric(qt, qp, material, light_id, med_inside, med_outside)

    def add_bilinear_patch(self, p00, p10, p01, p11, material: int, light_id: int = -1,
                           med_inside: int = -1, med_outside: int = -1) -> int:
        """An analytic (possibly non-planar) bilinear patch."""
        from . import quadrics

        qt, qp = quadrics.make_bilinear_record(p00, p10, p01, p11)
        return self._add_quadric(qt, qp, material, light_id, med_inside, med_outside)

    def _add_quadric(self, qt, qp, material, light_id, med_inside, med_outside) -> int:
        self._quadrics.append(dict(
            type=qt, params=qp, material=int(material),
            light=int(light_id if light_id is not None else -1),
            med=(int(med_inside), int(med_outside))))
        return len(self._quadrics) - 1

    def add_medium(self, kind: str = "homogeneous", sigma_a=(1.0, 1.0, 1.0),
                   sigma_s=(0.0, 0.0, 0.0), scale: float = 1.0, g: float = 0.0,
                   Le=(0.0, 0.0, 0.0), Le_scale: float = 0.0, density=None,
                   bounds=None, temperature=None, temperature_scale: float = 1.0,
                   temperature_offset: float = 0.0) -> int:
        """A participating medium, as the JAX builder registers it:
        homogeneous, or a grid of `density` ((D, H, W), resampled to
        MED_GRID_RES^3) over the world box `bounds` ((2, 3)); the kinds
        cloud, rgbgrid and nanovdb are grids too, their densities made on
        the host (the parser bakes a cloud's noise). sigma_a and
        sigma_s are RGB chromas times `scale`; the emission Le * Le_scale is
        multiplied by sigma_a where it is sampled. A `temperature` grid
        (Kelvin, scale and offset applied here) makes the emission blackbody
        radiance at the local temperature times Le_scale."""
        kinds = {"homogeneous": MED_HOMOGENEOUS, "grid": MED_GRID,
                 "rgbgrid": MED_GRID, "cloud": MED_GRID, "nanovdb": MED_GRID}
        if kinds[kind] == MED_GRID:
            if density is None or bounds is None:
                raise ValueError("grid medium needs density + bounds")
            grid = _resample(density)
            max_density = float(np.asarray(density, np.float32).max())
            bounds = np.asarray(bounds, np.float32).reshape(2, 3)
            maj = majorant_grid(grid)
        else:
            grid = maj = None
            max_density = 1.0
            bounds = np.zeros((2, 3), np.float32)
        tgrid = None
        if temperature is not None:
            # the blackbody path reads a flat Le_scale spectrum (media.le_at)
            if not np.any(np.asarray(Le)):
                Le = (1.0, 1.0, 1.0)
            tgrid = _resample((np.asarray(temperature, np.float32) - temperature_offset)
                              * temperature_scale)
        self._media.append(dict(
            type=kinds[kind], sigma_a=np.asarray(sigma_a, np.float32),
            sigma_s=np.asarray(sigma_s, np.float32), scale=float(scale), g=float(g),
            Le=np.asarray(Le, np.float32), Le_scale=float(Le_scale), grid=grid, maj=maj,
            max_density=max_density, bounds=bounds, tgrid=tgrid))
        return len(self._media) - 1

    def set_camera_medium(self, medium: int) -> None:
        self._camera_medium = int(medium)

    def add_mesh(self, vertices, faces, material: int, normals=None, uvs=None,
                 transform=None, emission_rgb=None, emission_scale: float = 1.0,
                 two_sided: bool = False, med_inside: int = -1,
                 med_outside: int = -1, light_id: int | None = None,
                 transform_end=None) -> None:
        """Indexed triangle mesh, placed by the 4x4 `transform` (render
        space when None), with optional per-vertex uvs (hair reads its fiber
        offset from v); with emission_rgb every triangle becomes a diffuse
        area light, with light_id every triangle maps to that registered
        light (the sphere area light). transform_end, when it differs from
        transform, is the shutter-close keyframe: the scene gets motion
        blur. med_inside / med_outside are the media on the side the
        geometric normal points away from / toward; material -1 makes the
        mesh a pure medium boundary."""
        def place(m, verts, norms, faces):
            if m is not None:
                verts = xf.apply_points(m, verts)
                norms = None if norms is None else xf.apply_normals(m, norms)
            p = verts[faces]
            if norms is not None:
                return p, np.asarray(norms, np.float32)[faces]
            ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            return p, np.repeat(ng[:, None, :], 3, axis=1)

        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        p, n = place(transform, vertices, normals, faces)
        if transform_end is not None and (transform is None
                                          or not np.allclose(transform_end, transform)):
            pe, ne = place(transform_end, vertices, normals, faces)
            self._tri_pe.append(pe.astype(np.float32))
            self._tri_ne.append(ne.astype(np.float32))
        else:
            self._tri_pe.append(None)
            self._tri_ne.append(None)
        self._tri_p.append(p)
        self._tri_n.append(n.astype(np.float32))
        self._tri_uv.append(np.zeros((len(faces), 3, 2), np.float32) if uvs is None
                            else np.asarray(uvs, np.float32)[faces])
        self._tri_mat.append(np.full(len(faces), material, np.int32))
        self._tri_med.append((int(med_inside), int(med_outside)))
        if light_id is not None:
            self._tri_emit.append(int(light_id))
        else:
            self._tri_emit.append(
                None if emission_rgb is None else
                (np.asarray(emission_rgb, np.float32), float(emission_scale), two_sided))

    def add_sphere(self, center, radius, material, n_theta=32, n_phi=64,
                   emission_rgb=None, emission_scale: float = 1.0,
                   two_sided: bool = False, **kw):
        """Tessellated sphere (same tessellation as the JAX builder); **kw
        goes to add_mesh (uvs over the (n_theta+1) x (n_phi+1) vertex grid,
        transform, transform_end, med_inside, med_outside). An emissive
        sphere registers one analytic sphere area light for the whole shape."""
        if emission_rgb is not None:
            kw = dict(kw, light_id=self.add_sphere_area_light(
                center, radius, emission_rgb, emission_scale, two_sided=two_sided,
                n_theta=n_theta))
        th = np.linspace(0, np.pi, n_theta + 1)
        ph = np.linspace(0, 2 * np.pi, n_phi + 1)
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        verts = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                          np.cos(tt)], -1).reshape(-1, 3)
        normals = verts.copy()
        verts = verts * radius + np.asarray(center, np.float32)
        idx = lambda i, j: i * (n_phi + 1) + j
        faces = []
        for i in range(n_theta):
            for j in range(n_phi):
                a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
                if i > 0:
                    faces.append([a, b, d])
                if i < n_theta - 1:
                    faces.append([b, c, d])
        self.add_mesh(np.asarray(verts, np.float32), np.asarray(faces), material,
                      normals=normals.astype(np.float32), **kw)

    def add_quad(self, p00, p10, p11, p01, material, **kw):
        verts = np.asarray([p00, p10, p11, p01], np.float32)
        self.add_mesh(verts, np.asarray([[0, 1, 2], [0, 2, 3]]), material, **kw)

    def build(self) -> CompiledScene:
        if not self._tri_p:
            if not self._quadrics:
                raise ValueError("empty scene")
            # a quadric-only scene keeps one degenerate triangle (no
            # intersector accepts det == 0) so the BVH has a leaf
            self.add_mesh(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]), material=-1)
        tri_p = np.concatenate(self._tri_p)
        tri_n = np.concatenate(self._tri_n)
        tri_uv = np.concatenate(self._tri_uv)
        tri_mat = np.concatenate(self._tri_mat)
        n = len(tri_p)
        animated = any(pe is not None for pe in self._tri_pe)
        if animated:
            tri_p_end = np.concatenate([p0 if pe is None else pe
                                        for pe, p0 in zip(self._tri_pe, self._tri_p)])
            tri_n_end = np.concatenate([n0 if ne is None else ne
                                        for ne, n0 in zip(self._tri_ne, self._tri_n)])
        tri_med_in = np.concatenate([np.full(len(c), mi, np.int32)
                                     for c, (mi, _) in zip(self._tri_p, self._tri_med)])
        tri_med_out = np.concatenate([np.full(len(c), mo, np.int32)
                                      for c, (_, mo) in zip(self._tri_p, self._tri_med)])

        # per-mesh emission -> one area light per triangle
        tri_light = np.full(n, -1, np.int32)
        lights = list(self._lights)
        off = 0
        for chunk, emit in zip(self._tri_p, self._tri_emit):
            if isinstance(emit, int):  # every triangle maps to one shape light
                tri_light[off:off + len(chunk)] = emit
            elif emit is not None:
                rgb, sc, two = emit
                for k in range(len(chunk)):
                    tri_light[off + k] = len(lights)
                    params = np.zeros(N_LIGHT_PARAMS, np.float32)
                    params[0] = off + k
                    params[1] = 1.0 if two else 0.0
                    lights.append(dict(type=LIGHT_AREA_TRI, pos=np.zeros(3, np.float32),
                                       rgb=rgb, scale=sc, params=params))
            off += len(chunk)

        # pad to a lane multiple with degenerate triangles
        pad = (-n) % 128
        if pad:
            tri_p = np.concatenate([tri_p, np.zeros((pad, 3, 3), np.float32)])
            tri_n = np.concatenate([tri_n, np.zeros((pad, 3, 3), np.float32)])
            tri_n[n:, :, 2] = 1.0
            if animated:
                tri_p_end = np.concatenate([tri_p_end, np.zeros((pad, 3, 3), np.float32)])
                tri_n_end = np.concatenate([tri_n_end, np.zeros((pad, 3, 3), np.float32)])
                tri_n_end[n:, :, 2] = 1.0
            tri_uv = np.concatenate([tri_uv, np.zeros((pad, 3, 2), np.float32)])
            tri_mat = np.concatenate([tri_mat, np.full(pad, -1, np.int32)])
            tri_light = np.concatenate([tri_light, np.full(pad, -1, np.int32)])
            tri_med_in = np.concatenate([tri_med_in, np.full(pad, -1, np.int32)])
            tri_med_out = np.concatenate([tri_med_out, np.full(pad, -1, np.int32)])

        if not self._materials:
            self.add_material("diffuse")
        mat_type = np.array([m["type"] for m in self._materials], np.int32)
        refl = np.stack([m["reflectance"] for m in self._materials])
        mat_coeffs, mat_scale = rgb2spec.rgb_to_coeffs_host(refl)
        mat_params = np.stack([m["params"] for m in self._materials])

        if lights:
            light_type = np.array([l["type"] for l in lights], np.int32)
            light_pos = np.stack([l["pos"] for l in lights])
            lc, ls = rgb2spec.rgb_to_coeffs_host(np.stack([l["rgb"] for l in lights]))
            light_scale = np.array([l["scale"] for l in lights], np.float32) * ls
            light_params = np.stack([l["params"] for l in lights])
        else:
            light_type = np.zeros(0, np.int32)
            light_pos = np.zeros((0, 3), np.float32)
            lc = np.zeros((0, 3), np.float32)
            light_scale = np.zeros(0, np.float32)
            light_params = np.zeros((0, N_LIGHT_PARAMS), np.float32)

        if self._measured:
            from ..scatter import measured as measured_mod

            measured_coeffs = np.stack([measured_mod.table_to_coeffs(t)
                                        for t in self._measured])
            measured_alpha = np.array([measured_mod.fit_ggx_alpha(t) for t in self._measured],
                                      np.float32)
        else:
            measured_coeffs = np.zeros((1, 2, 2, 2, 4), np.float32)
            measured_alpha = np.ones((1,), np.float32)

        if self._textures:
            from . import texture

            t0 = time.perf_counter()
            tex_atlas, tex_desc = texture.pack_atlas(self._textures)
            self.atlas_seconds = time.perf_counter() - t0
        else:
            tex_atlas = np.zeros((1, 4), np.float32)
            tex_desc = np.zeros((1, 1, 3), np.int32)

        lo = tri_p[:n].reshape(-1, 3).min(0)
        hi = tri_p[:n].reshape(-1, 3).max(0)
        quads = dict(n_quadrics=0)
        if self._quadrics:
            from . import quadrics

            qtype = np.array([q["type"] for q in self._quadrics], np.int32)
            qparams = np.stack([q["params"] for q in self._quadrics])
            for qt, qp in zip(qtype, qparams):
                qlo, qhi = quadrics.bounds(int(qt), qp)
                lo, hi = np.minimum(lo, qlo), np.maximum(hi, qhi)
            quads = dict(quad_type=qtype, quad_params=qparams,
                         quad_uv_scale=quadrics.uv_scale(qtype, qparams),
                         quad_mat=np.array([q["material"] for q in self._quadrics], np.int32),
                         quad_light=np.array([q["light"] for q in self._quadrics], np.int32),
                         quad_med=np.array([q["med"] for q in self._quadrics], np.int32),
                         n_quadrics=len(self._quadrics))
        out = CompiledScene(
            **self._build_media(), **self._build_sss(), **self._build_env(), **quads,
            **self._build_portal(lights),
            feat_portal=bool(np.any(light_type == LIGHT_PORTAL_ENV)),
            measured_coeffs=measured_coeffs, measured_alpha=measured_alpha,
            spec_tables=np.stack(self._spec_tables) if self._spec_tables else None,
            feat_mix=bool(np.any(mat_type == MAT_MIX)),
            feat_hair=bool(np.any(mat_type == MAT_HAIR)),
            feat_measured=bool(np.any(mat_type == MAT_MEASURED)),
            feat_spectral=bool(self._spec_tables),
            feat_subsurface=bool(np.any(mat_type == MAT_SUBSURFACE)),
            feat_coated=bool(np.any((mat_type == MAT_COATED_DIFFUSE)
                                    | (mat_type == MAT_COATED_CONDUCTOR))),
            tri_med_inside=tri_med_in, tri_med_outside=tri_med_out,
            tri_p=tri_p, tri_n=tri_n, tri_uv=tri_uv, tri_mat=tri_mat,
            tri_light=tri_light, n_tris=n,
            mat_type=mat_type, mat_coeffs=mat_coeffs, mat_scale=mat_scale,
            mat_params=mat_params,
            light_type=light_type, light_pos=light_pos, light_coeffs=lc,
            light_scale=light_scale, light_params=light_params,
            n_lights=int(len(lights)), bounds=np.stack([lo, hi]), tri_shade=None,
            tex_atlas=tex_atlas, tex_desc=tex_desc)
        if animated:
            out = out.replace(tri_p_end=tri_p_end, tri_n_end=tri_n_end)
        out = out.replace(tri_shade=make_tri_shade(out))
        if animated:
            out = out.replace(tri_shade_end=make_tri_shade(out, use_end=True))
        return out

    def _build_env(self) -> dict:
        """The env map's coefficient image and luminance sampling tables
        (marginal over rows, conditional within a row), or the JAX builder's
        1-entry placeholders."""
        img = self._env_image
        if img is None:
            return dict(env_coeffs=np.zeros((1, 1, 4), np.float32),
                        env_cond_cdf=np.zeros((1, 2), np.float32),
                        env_marg_cdf=np.zeros((2,), np.float32),
                        env_marg_func=np.zeros((1,), np.float32),
                        env_luminance=np.zeros((1, 1), np.float32))
        lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
               + 0.0722 * img[..., 2]).astype(np.float32) + 1e-9
        he, we = lum.shape
        row_int = lum.mean(1)
        cond = np.concatenate([np.zeros((he, 1), np.float32), np.cumsum(lum, 1) / we], 1) \
            / np.maximum(row_int[:, None], 1e-20)
        marg_cdf = np.concatenate([[0.0], np.cumsum(row_int) / he]).astype(np.float32)
        integral = marg_cdf[-1]
        marg_cdf = marg_cdf / max(integral, 1e-20)
        return dict(env_coeffs=rgb2spec.rgb_image_to_coeffs(img),
                    env_cond_cdf=cond.astype(np.float32), env_marg_cdf=marg_cdf,
                    env_marg_func=(row_int / max(integral, 1e-20)).astype(np.float32),
                    env_luminance=(lum / max(integral, 1e-20)).astype(np.float32))

    def _build_portal(self, lights) -> dict:
        """The first portal light's warp tables (scatter/portal.py), its frame's
        +z turned away from the scene's centroid, or nothing."""
        if self._env_image is None:
            return {}
        for light in lights:
            if light["type"] != LIGHT_PORTAL_ENV:
                continue
            from ..scatter import portal

            quad = np.asarray(light["params"][0:12], np.float32).reshape(4, 3)
            xw, yw, zw = portal.frame_from_quad(*quad)
            centroid = np.concatenate([t.reshape(-1, 3) for t in self._tri_p]).mean(0)
            if np.dot(zw, centroid - quad[0]) > 0:
                xw, yw, zw = yw, xw, -zw  # swapping x and y keeps the frame right-handed
            pic, sat = portal.build_tables(self._env_image, quad, frame=(xw, yw, zw))
            return dict(portal_img_coeffs=pic, portal_sat=sat,
                        portal_frame=np.stack([xw, yw, zw]))
        return {}

    def _build_media(self) -> dict:
        """The media tables, laid out as the JAX builder lays them out (with
        its placeholders when the scene has no media)."""
        media = self._media
        if not media:
            return dict(
                med_type=np.zeros(0, np.int32), med_sa_coeffs=np.zeros((0, 3), np.float32),
                med_ss_coeffs=np.zeros((0, 3), np.float32),
                med_le_coeffs=np.zeros((0, 3), np.float32),
                med_scales=np.zeros((0, 4), np.float32), med_grid_id=np.zeros(0, np.int32),
                med_max_density=np.zeros(0, np.float32),
                med_bounds=np.zeros((0, 2, 3), np.float32),
                med_grids=np.zeros((1, 1, 1, 1), np.float32),
                med_maj_grids=np.ones((1, 1, 1, 1), np.float32),
                med_temp_grids=np.zeros((1, 1, 1, 1), np.float32),
                med_temp_grid_id=np.zeros(0, np.int32), n_media=0, camera_medium=-1)
        coeffs = lambda key: rgb2spec.rgb_to_coeffs_host(np.stack([m[key] for m in media]))
        (sa_c, sa_s), (ss_c, ss_s), (le_c, le_s) = coeffs("sigma_a"), coeffs("sigma_s"), \
            coeffs("Le")
        user = np.array([m["scale"] for m in media], np.float32)
        med_scales = np.stack([sa_s * user, ss_s * user,
                               le_s * np.array([m["Le_scale"] for m in media], np.float32),
                               np.array([m["g"] for m in media], np.float32)], -1)
        grids, majs, tgrids = [], [], []
        grid_id = np.full(len(media), -1, np.int32)
        temp_id = np.full(len(media), -1, np.int32)
        for i, m in enumerate(media):
            if m["grid"] is not None:
                grid_id[i] = len(grids)
                grids.append(m["grid"])
                majs.append(m["maj"])
            if m["tgrid"] is not None:
                temp_id[i] = len(tgrids)
                tgrids.append(m["tgrid"])
        stack = lambda g, fill: np.stack(g) if g else np.full((1, 1, 1, 1), fill, np.float32)
        return dict(
            med_type=np.array([m["type"] for m in media], np.int32), med_sa_coeffs=sa_c,
            med_ss_coeffs=ss_c, med_le_coeffs=le_c, med_scales=med_scales.astype(np.float32),
            med_grid_id=grid_id,
            med_max_density=np.array([m["max_density"] for m in media], np.float32),
            med_bounds=np.stack([m["bounds"] for m in media]), med_grids=stack(grids, 0.0),
            med_maj_grids=stack(majs, 1.0), med_temp_grids=stack(tgrids, 0.0),
            med_temp_grid_id=temp_id, n_media=len(media),
            camera_medium=self._camera_medium)
