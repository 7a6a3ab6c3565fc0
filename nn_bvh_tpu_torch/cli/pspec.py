"""Sampler Fourier power-spectrum analysis (port of nn_bvh_tpu/cli/pspec.py).

The reference tool renders the average power spectrum of a 2D sample
pattern over many independent realizations:

    P(k) = E_sets[ |sum_j exp(-2 pi i <k, x_j>)|^2 / N ]

White noise gives P == 1 at all k; stratified/low-discrepancy patterns
show the characteristic low-frequency suppression ("blue noise" hole)
that predicts integration-error behavior. The Fourier sum is one (K^2, N)
cos/sin contraction of kvec @ x.T, on the CUDA card unless --device cpu
is given; the sample sets come from the port's samplers on the host.

Usage:
    python -m nn_bvh_tpu_torch.cli.pspec --sampler sobol --npoints 256 \
        --nsets 32 --res 129 --outfile spectrum.png [--device cpu]
Prints JSON with the mean power in the low-frequency disk (|k| < sqrt(N)/2)
— the scalar that summarizes stratification quality.
"""

from __future__ import annotations

import argparse
import json
import sys


def sample_points(kind: str, n: int, set_idx: int, seed: int):
    """One realization of n 2D samples from the named sampler -> (n, 2)
    float32 numpy."""
    import numpy as np
    import torch

    from ..core import samplers, lowdiscrepancy as ld

    if kind == "independent":
        rs = np.random.RandomState(seed * 9973 + set_idx)
        return rs.rand(n, 2).astype(np.float32)
    if kind == "stratified":
        rs = np.random.RandomState(seed * 9973 + set_idx)
        m = int(round(n ** 0.5))
        g = (np.mgrid[0:m, 0:m].reshape(2, -1).T + rs.rand(m * m, 2)) / m
        return g.astype(np.float32)[:n]
    if kind == "pmj02":
        return ld.generate_pmj02(n, seed=seed * 131 + set_idx)
    # the sobol family through the sampler: one pixel, n sample indices,
    # a scramble seed per set
    cfg = samplers.make_sampler(kind, seed=seed * 131 + set_idx, spp=n)
    pix = torch.zeros(n, dtype=torch.int32)
    sidx = torch.arange(n, dtype=torch.int32)
    u, v = samplers.get_2d(cfg, pix, sidx, 0)
    return np.stack([u.numpy(), v.numpy()], -1)


def power_spectrum(points_sets, res: int, device=None):
    """Average |F|^2/N over sets on `device` (the CUDA card when None).
    points_sets: (S, N, 2) -> (res, res) float32 numpy."""
    import math

    import numpy as np
    import torch

    from ..devices import resolve_device

    device = resolve_device(device)
    S, N, _ = points_sets.shape
    k = np.arange(res) - res // 2
    KX, KY = np.meshgrid(k, k, indexing="xy")
    kvec = torch.as_tensor(np.stack([KX, KY], -1).reshape(-1, 2), dtype=torch.float32,
                           device=device)
    pts = torch.as_tensor(np.asarray(points_sets), dtype=torch.float32, device=device)
    acc = torch.zeros(res * res, dtype=torch.float32, device=device)
    for s in range(S):
        # kvec @ x.T as two broadcast products and a sum (no FMA, no TF32):
        # the card's phases are the CPU's bit for bit
        x = pts[s]
        phase = -2.0 * math.pi * (kvec[:, :1] * x[:, 0] + kvec[:, 1:] * x[:, 1])  # (K^2, N)
        re = torch.cos(phase).sum(1)
        im = torch.sin(phase).sum(1)
        acc = acc + (re * re + im * im) / N
    return (acc / S).reshape(res, res).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sampler", default="sobol",
                    choices=["independent", "stratified", "sobol", "zsobol",
                             "pmj02", "halton"])
    ap.add_argument("--npoints", type=int, default=256)
    ap.add_argument("--nsets", type=int, default=16)
    ap.add_argument("--res", type=int, default=65)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    sets = np.stack([
        sample_points(args.sampler, args.npoints, s, args.seed)
        for s in range(args.nsets)
    ])
    P = power_spectrum(sets, args.res, args.device)

    # low-frequency disk metric (excluding DC): stratification quality
    k = np.arange(args.res) - args.res // 2
    KX, KY = np.meshgrid(k, k, indexing="xy")
    r = np.sqrt(KX ** 2 + KY ** 2)
    lo = (r > 0) & (r < np.sqrt(args.npoints) / 2)
    hi = r >= np.sqrt(args.npoints) / 2
    out = {
        "sampler": args.sampler,
        "npoints": args.npoints,
        "low_freq_power": float(P[lo].mean()),
        "high_freq_power": float(P[hi].mean()) if hi.any() else None,
    }
    print(json.dumps(out))

    if args.outfile:
        from ..utils import image as image_mod

        img = np.log1p(P) / np.log1p(max(P.max(), 1e-9))
        img3 = np.repeat(img[..., None], 3, -1).astype(np.float32)
        if args.outfile.endswith(".png"):
            image_mod.write_png(args.outfile, img3)
        else:
            image_mod.write_exr(args.outfile, img3)
        print(f"wrote {args.outfile}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
