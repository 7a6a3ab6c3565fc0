"""imgtool: image manipulation subcommands (port of
nn_bvh_tpu/cli/imgtool.py; numpy on the host, as there).

Subcommands: convert (exposure, scale, tonemap, clamp, crop, flipy,
downsample, gamma, colorspace), cat, makeemitters, denoise (a
cross-bilateral filter guided by the normal and albedo AOVs that
integrator.render_gbuffer writes), diff, info, falsecolor, average, error,
makeequiarea and makesky (directions from the port's
vecmath.equal_area_square_to_sphere on a CPU tensor), assemble, splitn,
bloom, despike, whitebalance (film.make_sensor's white balance).
Images are read from .pfm and .exr, written by extension (.png, .pfm, else
EXR).

Usage: python -m nn_bvh_tpu_torch.cli.imgtool <subcommand> [args...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _read(path: str) -> np.ndarray:
    from ..utils import image as im

    if path.endswith(".pfm"):
        return im.read_pfm(path)
    if path.endswith(".exr"):
        return im.read_exr(path)
    raise SystemExit(f"unsupported input format: {path}")


def _write(path: str, img: np.ndarray) -> None:
    from ..utils import image as im

    if path.endswith(".png"):
        im.write_png(path, img)
    elif path.endswith(".pfm"):
        im.write_pfm(path, img)
    else:
        im.write_exr(path, img)


def cmd_convert(args):
    img = _read(args.input)
    if args.exposure != 0.0:
        img = img * (2.0 ** args.exposure)
    if args.scale != 1.0:
        img = img * args.scale
    if args.tonemap:
        # ACES-filmic-ish curve (imgtool convert --acesfilmic analog)
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        img = np.clip((img * (a * img + b)) / (img * (c * img + d) + e), 0, 1)
    if args.clamp is not None:
        img = np.minimum(img, args.clamp)
    if args.crop:
        x0, x1, y0, y1 = (int(v) for v in args.crop.split(","))
        img = img[y0:y1, x0:x1]
    if args.flipy:
        img = img[::-1]
    for _ in range(args.downsample):
        h, w = img.shape[0] & ~1, img.shape[1] & ~1
        c = img[:h, :w]
        img = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                      + c[1::2, 1::2])
    if args.gamma != 1.0:
        img = np.sign(img) * np.abs(img) ** (1.0 / args.gamma)
    if args.colorspace:
        from ..core import colorspace as cs

        # input assumed linear sRGB (our render output space)
        xyz = np.asarray(img) @ cs.RGB_TO_XYZ["srgb"].T
        img = (xyz @ cs.XYZ_TO_RGB[args.colorspace].T).astype(np.float32)
    _write(args.output, img)


def cmd_cat(args):
    """Print pixel values as text (imgtool cat)."""
    img = _read(args.input)
    if args.csv:
        for y in range(img.shape[0]):
            for x in range(img.shape[1]):
                print(",".join(f"{v:g}" for v in np.atleast_1d(img[y, x])))
    else:
        print(np.array2string(img, precision=5, threshold=1 << 30))


def cmd_makeemitters(args):
    """Emit a pbrt scene fragment with one emissive quad per (downsampled)
    pixel of the input image (imgtool makeemitters, cmd/imgtool.cpp)."""
    img = _read(args.input)
    for _ in range(args.downsample):
        h, w = img.shape[0] & ~1, img.shape[1] & ~1
        c = img[:h, :w]
        img = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                      + c[1::2, 1::2])
    h, w = img.shape[:2]
    lines = []
    for y in range(h):
        for x in range(w):
            rgb = np.atleast_1d(img[y, x])[:3]
            if float(rgb.max()) <= 0:
                continue
            lines.append("AttributeBegin")
            lines.append(
                'AreaLightSource "diffuse" "rgb L" [ %g %g %g ]'
                % tuple(float(v) for v in rgb))
            x0, x1 = x / w, (x + 1) / w
            y0, y1 = 1 - (y + 1) / h, 1 - y / h
            lines.append(
                'Shape "bilinearmesh" "point3 P" [ %g %g 0 %g %g 0 %g %g 0 %g %g 0 ]'
                % (x0, y0, x1, y0, x0, y1, x1, y1))
            lines.append("AttributeEnd")
    out = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w") as fobj:
            fobj.write(out)
    else:
        sys.stdout.write(out)


def cmd_denoise(args):
    """Cross-bilateral denoiser guided by auxiliary normal/albedo AOVs
    (the host stand-in for pbrt's `imgtool denoise-optix`; the AOVs are
    integrator.render_gbuffer's "ns" and "albedo" written as images).
    Joint range weights on color, normal and albedo."""
    img = _read(args.input)
    nrm = _read(args.normal) if args.normal else None
    alb = _read(args.albedo) if args.albedo else None
    r = args.radius
    sig_s = max(r / 2.0, 1e-3)
    h, w = img.shape[:2]
    pad = lambda a: np.pad(a, ((r, r), (r, r), (0, 0)), mode="reflect")
    ip = pad(img)
    npd = pad(nrm) if nrm is not None else None
    apd = pad(alb) if alb is not None else None
    acc = np.zeros_like(img, np.float64)
    wacc = np.zeros((h, w, 1), np.float64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sl = ip[r + dy:r + dy + h, r + dx:r + dx + w]
            wgt = np.exp(-(dx * dx + dy * dy) / (2 * sig_s * sig_s))
            d2 = ((sl - img) ** 2).sum(-1, keepdims=True)
            wgt = wgt * np.exp(-d2 / (2 * args.sigma_color ** 2))
            if npd is not None:
                sn = npd[r + dy:r + dy + h, r + dx:r + dx + w]
                dn = ((sn - nrm) ** 2).sum(-1, keepdims=True)
                wgt = wgt * np.exp(-dn / (2 * args.sigma_normal ** 2))
            if apd is not None:
                sa = apd[r + dy:r + dy + h, r + dx:r + dx + w]
                da = ((sa - alb) ** 2).sum(-1, keepdims=True)
                wgt = wgt * np.exp(-da / (2 * args.sigma_albedo ** 2))
            acc += sl * wgt
            wacc += wgt
    _write(args.output, (acc / np.maximum(wacc, 1e-12)).astype(np.float32))


def cmd_diff(args):
    from ..utils import image as im

    a = _read(args.image)
    b = _read(args.reference)
    out = {"mse": im.mse(a, b), "mrse": im.mrse(a, b),
           "max_abs": float(np.abs(a - b).max())}
    print(json.dumps(out))
    if args.outfile:
        _write(args.outfile, np.abs(a - b))
    if args.fail_threshold is not None and out["mse"] > args.fail_threshold:
        sys.exit(1)


def cmd_info(args):
    img = _read(args.input)
    print(json.dumps({
        "resolution": [img.shape[1], img.shape[0]],
        "channels": int(img.shape[2]) if img.ndim == 3 else 1,
        "min": float(img.min()), "max": float(img.max()),
        "mean": float(img.mean()),
        "nan": int(np.isnan(img).sum()), "inf": int(np.isinf(img).sum()),
    }))


def cmd_falsecolor(args):
    img = _read(args.input)
    lum = img.mean(-1) if img.ndim == 3 else img
    if args.log:
        lum = np.log10(np.maximum(lum, 1e-10))
    lo, hi = (lum.min(), lum.max()) if args.range is None else tuple(
        float(v) for v in args.range.split(","))
    t = np.clip((lum - lo) / max(hi - lo, 1e-12), 0, 1)
    # viridis-ish 3-stop ramp
    stops = np.array([[0.267, 0.005, 0.329], [0.128, 0.567, 0.551], [0.993, 0.906, 0.144]])
    idx = np.minimum((t * 2).astype(int), 1)
    frac = t * 2 - idx
    out = stops[idx] * (1 - frac[..., None]) + stops[idx + 1] * frac[..., None]
    _write(args.output, out.astype(np.float32))


def cmd_average(args):
    imgs = [_read(p) for p in args.inputs]
    _write(args.output, np.mean(imgs, axis=0).astype(np.float32))


def cmd_error(args):
    """Per-image convergence vs reference (imgtool error)."""
    from ..utils import image as im

    ref = _read(args.reference)
    for p in args.inputs:
        a = _read(p)
        print(json.dumps({"image": p, "mse": im.mse(a, ref), "mrse": im.mrse(a, ref)}))


def _equal_area_dirs(res: int) -> np.ndarray:
    """(res, res, 3) float32 directions of the texel centers of an
    equal-area octahedral map."""
    import torch

    from ..core import vecmath as vm

    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u, indexing="xy")
    return vm.equal_area_square_to_sphere(
        torch.as_tensor(np.stack([uu, vv], -1), dtype=torch.float32)).numpy()


def cmd_makeequiarea(args):
    """Equirectangular lat-long env map -> equal-area octahedral
    (imgtool makeequiarea; the renderer's ImageInfiniteLight format)."""
    src = _read(args.input)
    h, w = src.shape[:2]
    d = _equal_area_dirs(args.resolution)
    theta = np.arccos(np.clip(d[..., 1], -1, 1))        # y up
    phi = np.arctan2(d[..., 2], d[..., 0]) % (2 * np.pi)
    x = np.clip((phi / (2 * np.pi) * w).astype(int), 0, w - 1)
    y = np.clip((theta / np.pi * h).astype(int), 0, h - 1)
    _write(args.output, src[y, x].astype(np.float32))


def cmd_makesky(args):
    """Analytic clear-sky env map (imgtool makesky; the reference uses the
    Hosek-Wilkie model — this is a CIE-clear-sky + sun-disk approximation,
    adequate for lighting tests; plug real HW tables in later)."""
    res = args.resolution
    el = np.deg2rad(args.elevation)
    sun_d = np.array([np.cos(el), np.sin(el), 0.0])
    d = _equal_area_dirs(res)
    cos_g = np.clip(d @ sun_d, -1, 1)
    gamma = np.arccos(cos_g)
    cos_t = np.clip(d[..., 1], 0.0, 1.0)  # zenith angle from up (y)
    # CIE clear sky relative luminance
    lum = ((0.91 + 10 * np.exp(-3 * gamma) + 0.45 * cos_g ** 2)
           * (1 - np.exp(-0.32 / np.maximum(cos_t, 0.02))))
    lum = lum / lum.max()
    horizon_warm = np.clip(1 - cos_t, 0, 1) ** 2
    rgb = np.stack([
        lum * (0.45 + 0.45 * horizon_warm),
        lum * (0.55 + 0.25 * horizon_warm),
        lum * (1.0 - 0.3 * horizon_warm),
    ], -1)
    # sun disk as a gaussian no narrower than a texel (so it always lands)
    sun_rad = max(np.deg2rad(0.53), 2 * np.pi / res)
    rgb += np.exp(-((gamma / sun_rad) ** 2))[..., None] * args.sun_scale
    rgb *= (d[..., 1] > -0.05)[..., None]  # black below horizon
    _write(args.output, (rgb * args.scale).astype(np.float32))


def cmd_assemble(args):
    """Reassemble --crop render tiles into one image (imgtool assemble):
    inputs are (image, x0, y0) triples encoded as path:x0,y0."""
    tiles = []
    for spec in args.inputs:
        path, _, off = spec.partition(":")
        x0, y0 = (int(v) for v in off.split(",")) if off else (0, 0)
        tiles.append((path, x0, y0, _read(path)))
    w = max(x0 + t.shape[1] for _, x0, _, t in tiles)
    h = max(y0 + t.shape[0] for _, _, y0, t in tiles)
    out = np.zeros((h, w, tiles[0][3].shape[2]), np.float32)
    for _, x0, y0, t in tiles:
        out[y0:y0 + t.shape[0], x0:x0 + t.shape[1]] = t
    _write(args.output, out)


def cmd_splitn(args):
    """Split an image into n horizontal strips (imgtool splitn)."""
    img = _read(args.input)
    h = img.shape[0]
    for i in range(args.n):
        y0, y1 = i * h // args.n, (i + 1) * h // args.n
        out = args.output.replace("%d", str(i))
        _write(out, img[y0:y1])


def cmd_bloom(args):
    """Add bloom around bright pixels (imgtool convert --bloom*)."""
    img = _read(args.input)
    bright = np.where(img.max(-1, keepdims=True) > args.level, img, 0.0)
    # separable box blur iterated (~= gaussian)
    blur = bright
    # np.convolve(mode="same") returns max(M, N) samples: keep the kernel
    # strictly narrower than both image axes
    r = max(1, min(int(args.width), (min(img.shape[0], img.shape[1]) - 2) // 2))
    for _ in range(3):
        k = np.ones(2 * r + 1, np.float32) / (2 * r + 1)
        blur = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 0, blur)
        blur = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, blur)
    _write(args.output, (img + args.scale * blur).astype(np.float32))


def cmd_despike(args):
    """Replace fireflies above threshold with the 3x3 median
    (imgtool convert --despike)."""
    img = _read(args.input)
    lum = img.mean(-1)
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    stack = [pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
             for dy in range(3) for dx in range(3)]
    med = np.median(np.stack(stack), axis=0)
    spike = (lum > args.level)[..., None]
    _write(args.output, np.where(spike, med, img).astype(np.float32))


def cmd_whitebalance(args):
    """Chromatic adaptation from a source color temperature
    (imgtool whitebalance)."""
    from ..wavefront import film as film_mod
    from ..core import colorspace

    img = _read(args.input)
    sensor = film_mod.make_sensor(white_balance_temp=args.temperature)
    xyz = np.asarray(colorspace.SRGB_TO_XYZ) @ img.reshape(-1, 3).T
    out = (np.asarray(sensor.xyz_to_rgb) @ xyz).T.reshape(img.shape)
    _write(args.output, out.astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--exposure", type=float, default=0.0)
    c.add_argument("--scale", type=float, default=1.0)
    c.add_argument("--tonemap", action="store_true")
    c.add_argument("--clamp", type=float, default=None)
    c.add_argument("--crop", default=None, help="x0,x1,y0,y1")
    c.add_argument("--flipy", action="store_true")
    c.add_argument("--downsample", type=int, default=0,
                   help="2x box-downsample N times")
    c.add_argument("--gamma", type=float, default=1.0)
    c.add_argument("--colorspace", default=None,
                   choices=["srgb", "rec2020", "dci-p3", "aces2065-1"])
    c.set_defaults(fn=cmd_convert)

    t = sub.add_parser("cat")
    t.add_argument("input")
    t.add_argument("--csv", action="store_true")
    t.set_defaults(fn=cmd_cat)

    me = sub.add_parser("makeemitters")
    me.add_argument("input")
    me.add_argument("--output", default=None)
    me.add_argument("--downsample", type=int, default=0)
    me.set_defaults(fn=cmd_makeemitters)

    dn = sub.add_parser("denoise")
    dn.add_argument("input")
    dn.add_argument("output")
    dn.add_argument("--normal", default=None, help="GBuffer normal AOV")
    dn.add_argument("--albedo", default=None, help="GBuffer albedo AOV")
    dn.add_argument("--radius", type=int, default=4)
    dn.add_argument("--sigma-color", type=float, default=0.25)
    dn.add_argument("--sigma-normal", type=float, default=0.3)
    dn.add_argument("--sigma-albedo", type=float, default=0.15)
    dn.set_defaults(fn=cmd_denoise)

    d = sub.add_parser("diff")
    d.add_argument("image")
    d.add_argument("reference")
    d.add_argument("--outfile", default=None)
    d.add_argument("--fail-threshold", type=float, default=None)
    d.set_defaults(fn=cmd_diff)

    i = sub.add_parser("info")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    f = sub.add_parser("falsecolor")
    f.add_argument("input")
    f.add_argument("output")
    f.add_argument("--log", action="store_true")
    f.add_argument("--range", default=None, help="lo,hi")
    f.set_defaults(fn=cmd_falsecolor)

    a = sub.add_parser("average")
    a.add_argument("inputs", nargs="+")
    a.add_argument("--output", required=True)
    a.set_defaults(fn=cmd_average)

    e = sub.add_parser("error")
    e.add_argument("inputs", nargs="+")
    e.add_argument("--reference", required=True)
    e.set_defaults(fn=cmd_error)

    m = sub.add_parser("makeequiarea")
    m.add_argument("input")
    m.add_argument("output")
    m.add_argument("--resolution", type=int, default=512)
    m.set_defaults(fn=cmd_makeequiarea)

    k = sub.add_parser("makesky")
    k.add_argument("output")
    k.add_argument("--elevation", type=float, default=30.0, help="sun deg")
    k.add_argument("--resolution", type=int, default=512)
    k.add_argument("--scale", type=float, default=1.0)
    k.add_argument("--sun-scale", type=float, default=50.0)
    k.set_defaults(fn=cmd_makesky)

    s = sub.add_parser("assemble")
    s.add_argument("inputs", nargs="+", help="path[:x0,y0] tiles")
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_assemble)

    p = sub.add_parser("splitn")
    p.add_argument("input")
    p.add_argument("output", help="pattern containing %%d")
    p.add_argument("--n", type=int, default=2)
    p.set_defaults(fn=cmd_splitn)

    b = sub.add_parser("bloom")
    b.add_argument("input")
    b.add_argument("output")
    b.add_argument("--level", type=float, default=2.0)
    b.add_argument("--width", type=int, default=8)
    b.add_argument("--scale", type=float, default=0.3)
    b.set_defaults(fn=cmd_bloom)

    q = sub.add_parser("despike")
    q.add_argument("input")
    q.add_argument("output")
    q.add_argument("--level", type=float, default=10.0)
    q.set_defaults(fn=cmd_despike)

    w = sub.add_parser("whitebalance")
    w.add_argument("input")
    w.add_argument("output")
    w.add_argument("--temperature", type=float, default=6500.0)
    w.set_defaults(fn=cmd_whitebalance)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
