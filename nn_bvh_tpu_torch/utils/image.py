"""Image I/O on the host (port of nn_bvh_tpu/utils/image.py): PNG, PFM and
uncompressed float EXR writers; PFM, EXR (NONE/RLE/ZIPS/ZIP/PIZ, through
utils/exr.py) and PNG readers; MSE and MRSE.

The PNG reader is the port's own: zlib plus the five scanline filters, 1-16
bit samples, grey, RGB, palette and their alpha forms, non-interlaced. The
JAX parser reads PNG textures through PIL, which the card's machine lacks.
It returns what PIL's `convert("RGB")` gives for 8-bit files (alpha dropped,
grey and palette expanded) and, for 16-bit files, all 16 bits (PIL keeps the
high byte of 16-bit RGB and clips 16-bit grey).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: (H,W,3) float linear [0,1]-ish -> gamma-encoded 8-bit PNG."""
    from ..core import colorspace

    arr = colorspace.srgb_encode(torch.as_tensor(np.asarray(rgb, np.float32))).numpy()
    img = (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (_PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters. filt (H, stride) uint8 without the
    filter bytes, ftype (H,) their types -> (H, stride) uint8. Each byte
    depends on the byte bpp to its left (a), above (b) and above-left (c),
    so the bytes of one anti-diagonal of (row, pixel) are independent and
    are reconstructed together."""
    h, stride = filt.shape
    if not ftype.any():
        return filt
    ncol = stride // bpp
    f = filt.reshape(h, ncol, bpp).astype(np.int32)
    rec = np.zeros((h + 1, ncol + 1, bpp), np.int32)  # row 0 and column 0 are zero
    for d in range(h + ncol - 1):
        y = np.arange(max(0, d - ncol + 1), min(h, d + 1))
        x = d - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        t = ftype[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[y + 1, x + 1] = (f[y, x] + pred) & 255
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced PNG -> (H, W, 3) float32 in [0, 1], sRGB-encoded as
    stored (alpha dropped; grey and palette expanded to RGB)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette = 8, [], None
    while pos < len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype}")
    chans = _PNG_CHANNELS[ctype]
    bits = chans * depth
    stride = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[:h * (stride + 1)]
    raw = raw.reshape(h, stride + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0].astype(np.int32), max(1, bits // 8))
    if depth == 16:
        samples = rows.reshape(h, w * chans, 2).astype(np.uint32)
        samples = (samples[..., 0] << 8) | samples[..., 1]
    elif depth == 8:
        samples = rows.astype(np.uint32)
    else:  # 1, 2 or 4 bits, one sample a pixel
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        samples = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        samples = samples.astype(np.uint32)
    samples = samples.reshape(h, w, chans)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[samples[..., 0]].astype(np.float32) / 255.0
    if depth < 8:  # grey at 1, 2 or 4 bits expands to the full 8-bit range
        samples = samples * (255 // ((1 << depth) - 1))
        depth = 8
    img = samples.astype(np.float32) / float((1 << depth) - 1)
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# ---------------------------------------------------------------------------
# PFM (float32, linear)
# ---------------------------------------------------------------------------

def write_pfm(path: str, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if rgb.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(rgb[::-1].tobytes())  # bottom-up


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    c = 3 if header == b"PF" else 1
    img = data.reshape(h, w, c) if c == 3 else data.reshape(h, w)
    return np.ascontiguousarray(img[::-1])


# ---------------------------------------------------------------------------
# EXR (uncompressed scanline, float32)
# ---------------------------------------------------------------------------

def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Uncompressed FLOAT scanline EXR, channels B,G,R (alphabetical per spec)."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    channels = b""
    for name in (b"B", b"G", b"R"):
        channels += name + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)  # FLOAT
    channels += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_exr_attr(b"channels", b"chlist", channels)
              + _exr_attr(b"compression", b"compression", b"\x00")  # NO_COMPRESSION
              + _exr_attr(b"dataWindow", b"box2i", box)
              + _exr_attr(b"displayWindow", b"box2i", box)
              + _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
              + _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
              + _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
              + _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
              + b"\x00")
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    data_start = len(magic) + len(header) + 8 * h
    line_size = 8 + w * 4 * 3  # y + size prefix + 3 float channels
    offsets = b"".join(struct.pack("<Q", data_start + y * line_size) for y in range(h))
    lines = []
    for y in range(h):
        px = rgb[y]
        payload = (np.ascontiguousarray(px[:, 2]).tobytes()
                   + np.ascontiguousarray(px[:, 1]).tobytes()
                   + np.ascontiguousarray(px[:, 0]).tobytes())
        lines.append(struct.pack("<i", y) + struct.pack("<i", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(magic + header + offsets + b"".join(lines))


def read_exr(path: str) -> np.ndarray:
    """Any scanline EXR (NONE/RLE/ZIPS/ZIP/PIZ; HALF/FLOAT) as (H, W, 3) RGB."""
    from . import exr as exr_mod

    return exr_mod.read_rgb(path)


# ---------------------------------------------------------------------------
# error metrics
# ---------------------------------------------------------------------------

def mse(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def mrse(a: np.ndarray, ref: np.ndarray) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((a - ref) ** 2 / (ref**2 + 0.01)))
