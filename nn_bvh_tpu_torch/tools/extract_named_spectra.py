"""Extract the named-spectrum measurement tables from the reference (a
copy of tools/extract_named_spectra.py, so the port holds its own).

pbrt-v4 ships ~2.8k LoC of measured spectral data (metal eta/k from
Johnson & Christy etc., CIE standard illuminants, glass dispersion curves,
camera sensor response curves) in `util/spectrum.cpp`, exposed through
GetNamedSpectrum() (reference util/spectrum.cpp:2666-2790). This tool parses
the numeric tables out of that file and stores them as
`data/named_spectra.npz`, keyed by the same public names ("metal-Au-eta",
"stdillum-D65", "glass-BK7", ...). Each entry is an (N, 2) float32 array of
(wavelength_nm, value) pairs, raw (un-normalized) — normalization for
illuminants (luminance = 1, spectrum.cpp:158-160) is applied at load time by
core.named_spectra so it uses OUR CIE-Y fit consistently.

The extracted values are physical measurement data, not code.

Usage: python -m nn_bvh_tpu_torch.tools.extract_named_spectra REFERENCE_ROOT [out.npz]

REFERENCE_ROOT is the pbrt-v4 source tree; out.npz defaults to
data/named_spectra.npz.
"""
from __future__ import annotations

import re
import sys

import numpy as np


def extract(spectrum_cpp: str) -> dict[str, np.ndarray]:
    src = open(spectrum_cpp).read()

    # 1. all numeric array definitions: const Float NAME[...] = { ... };
    arrays: dict[str, np.ndarray] = {}
    for m in re.finditer(
            r"const\s+Float\s+(\w+)\s*\[[^\]]*\]\s*=\s*\{(.*?)\};",
            src, re.S):
        name, body = m.group(1), m.group(2)
        body = re.sub(r"//[^\n]*", "", body)
        vals = np.array([float(x) for x in re.findall(
            r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eEf][-+]?\d+)?", body.replace("f", ""))],
            dtype=np.float64)
        arrays[name] = vals

    # 2. local Spectrum vars built via FromInterleaved(ARR, normalize, alloc)
    var_to_arr: dict[str, tuple[str, bool]] = {}
    for m in re.finditer(
            r"Spectrum\s+(\w+)\s*=\s*\n?\s*PiecewiseLinearSpectrum::FromInterleaved\(\s*(\w+),\s*(true|false)",
            src):
        var_to_arr[m.group(1)] = (m.group(2), m.group(3) == "true")

    # 3. the namedSpectra map: {"public-name", var} or inline FromInterleaved
    named: dict[str, np.ndarray] = {}
    norm_names: list[str] = []
    map_src = src[src.index("namedSpectra = {"):]
    map_src = map_src[:map_src.index("};")]
    for m in re.finditer(
            r"\{\"([\w\-./]+)\",\s*\n?\s*(?:PiecewiseLinearSpectrum::FromInterleaved\(\s*(\w+),\s*(true|false)[^}]*|(\w+))\}",
            map_src):
        public, inline_arr, inline_norm, var = m.groups()
        if inline_arr is not None:
            arr_name, normalize = inline_arr, inline_norm == "true"
        else:
            if var not in var_to_arr:
                print(f"  skip {public}: var {var} not resolved")
                continue
            arr_name, normalize = var_to_arr[var]
        flat = arrays[arr_name]
        assert flat.size % 2 == 0, (public, arr_name, flat.size)
        pairs = flat.reshape(-1, 2).astype(np.float32)
        named[public] = pairs
        if normalize:
            norm_names.append(public)

    named["__normalize__"] = np.array(norm_names)
    return named


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit("usage: python -m nn_bvh_tpu_torch.tools.extract_named_spectra "
                         "REFERENCE_ROOT [out.npz]")
    ref = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "data/named_spectra.npz"
    tables = extract(f"{ref}/src/pbrt/util/spectrum.cpp")
    n = len(tables) - 1
    np.savez_compressed(out, **tables)
    print(f"wrote {out}: {n} named spectra, "
          f"{len(tables['__normalize__'])} normalized illuminants")
    for k in sorted(tables):
        if not k.startswith("__") and not k.startswith("canon"):
            print(f"  {k}: {tables[k].shape[0]} samples "
                  f"[{tables[k][0,0]:.0f}..{tables[k][-1,0]:.0f}] nm")


if __name__ == "__main__":
    main()
