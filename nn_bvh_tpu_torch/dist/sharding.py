"""Multi-process execution: the pixel axis sharded over a process group
(port of nn_bvh_tpu/dist/sharding.py).

The JAX package shards the ray/pixel axis of a jax Mesh with shard_map;
here each rank of a torch.distributed process group is one shard:

- the scene (geometry, BVH, materials, lights) is replicated: every rank
  builds it and uploads it to its own device;
- each rank owns the contiguous pixel band [rank*R/n, (rank+1)*R/n) as a
  flat (R_local, 3) + (R_local,) film and adds its samples with a plain
  vector add: no filter splat, no per-wave collective;
- the one collective of a render is a gather of the bands at develop time.

The group's backend is gloo (multihost.initialize makes it so, and
make_mesh refuses another): its collectives take host tensors, so the
bands are gathered on the host, as the JAX package gathers at develop
time (gloo's all_gather takes no CUDA tensors, and NCCL refuses two ranks
on one card). The learner's collectives are `psum` and `pmean`
(jax.lax's): one all_reduce of the flattened tensors, summed, and for
pmean divided by the world size.

This module holds the collectives, which the learner imports; the
renderer's modules are imported inside render_sharded.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils import stats

RAY_AXIS = "rays"   # the JAX package's mesh axis; the port's group has one axis


class Mesh(NamedTuple):
    """A process group seen from one rank."""

    world_size: int
    rank: int
    device: torch.device   # the rank's device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialized process group (multihost.initialize), or
    world size 1 without one. `n_devices`, when given, must be the world
    size. The rank's device: `device` when given, else the CUDA card
    LOCAL_RANK (torchrun's; else the rank) modulo the cards this process
    sees, so that ranks may share one card; a CUDA device becomes the
    process's current one. Without a card and without `device` it raises,
    as every entry point of the port does. A group whose backend is not
    gloo raises ValueError."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() != "gloo":
            raise ValueError(f"the port's collectives run over gloo, not {dist.get_backend()}")
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks asked of a process group of {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device is available: pass device='cpu' to run the "
                             "ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(world, rank, device)


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of x's leading axis (shard_map's
    P(axis) split); raises ValueError when the ranks do not divide it."""
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def gather_band(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's band of x, concatenated in rank order (gathered on the
    host), on x's device."""
    if mesh.world_size == 1:
        return x
    with stats.span("band.to_host", sync=True):
        src = x.cpu().contiguous()
    with stats.span("band.all_gather"):
        parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(x.device)


def psum(tensors, mesh: Mesh, mean: bool = False) -> list:
    """The sum over ranks of each tensor (float32, jax.lax.psum), or with
    `mean` their mean (jax.lax.pmean): one all_reduce of them flattened
    together on the host."""
    tensors = list(tensors)
    if mesh.world_size == 1:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32).cpu() for t in tensors])
    dist.all_reduce(flat)
    if mean:
        flat = flat / mesh.world_size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.device))
        at += t.numel()
    return out


def pmean(tensors, mesh: Mesh) -> list:
    """The mean over ranks of each tensor (jax.lax.pmean)."""
    return psum(tensors, mesh, mean=True)


def render_sharded(scene, dbvh, cam, mesh: Mesh, spp: int = 16, sampler: str = "sobol",
                   seed: int = 0, cfg=None,
                   film_state: tuple | None = None, start_sample: int = 0,
                   wave_callback=None, isect=None) -> torch.Tensor:
    """Render with the pixel axis sharded over the mesh's ranks -> (H, W, 3)
    linear sRGB on the rank's device, on every rank.

    Each wave traces this rank's band (integrator.trace_wave, Path and
    RandomWalk kinds) and adds it to the band's film; non-finite XYZ
    counts 0. `film_state`, the band's (xyz, weight) as
    multihost.load_render_state returns them, and `start_sample` resume a
    render; `wave_callback(sample index, xyz, weight)` runs after each
    wave with the band's film (multihost.save_render_state takes it).
    `isect` overrides the traversal (default: dispatch's for the device);
    `cfg` is an integrator.IntegratorConfig (default: its defaults).
    The bands' XYZ and weight travel in one gather. With tracing on
    (utils/stats.py): image.setup, the waves' spans, band.to_host (the
    host read of the band) and band.all_gather (gather_band), and
    image.develop."""
    from ..accel import dispatch
    from ..core import samplers
    from ..geometry import scene as scene_mod
    from ..scatter import lightsamplers
    from ..wavefront import film as film_mod, filters, integrator

    cfg = integrator.IntegratorConfig() if cfg is None else cfg
    n = mesh.world_size
    R = cam.width * cam.height
    if R % n != 0:
        raise ValueError(f"pixel count {R} must divide over {n} ranks")
    device = mesh.device
    stats.advance("image")
    stats.set_unit(rank=mesh.rank)
    with stats.span("image.setup"):
        sampler_cfg = samplers.to_device(samplers.make_sampler(sampler, seed=seed, spp=spp),
                                         device)
        cfg = cfg._replace(filt=filters.to_device(cfg.filt, device))
        if isect is None:
            isect = dispatch.make_intersectors(scene, dbvh, device, sort=not cfg.resort)
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
        scene_d = scene_mod.to_device(scene, device)
        pixel_idx = local_rows(torch.arange(R, dtype=torch.int32, device=device), mesh)
        n_local = pixel_idx.shape[0]
        band = film_mod.make_film(1, n_local, device)
        if film_state is not None:
            xyz, weight = (torch.as_tensor(x, dtype=torch.float32, device=device)
                           for x in film_state)
            band = band._replace(xyz=xyz.reshape(n_local, 3).clone(),
                                 weight=weight.reshape(n_local).clone())
    for s in range(start_sample, spp):
        stats.set_unit(wave=s)
        L, lam, lam_pdf, fw = integrator.trace_wave(scene_d, None, cam, sampler_cfg, cfg,
                                                    pixel_idx, s, ls_tables, isect)[:4]
        # the band's film: a plain vector add, no scatter, no collective
        with stats.span("wave.film"):
            band = film_mod.add_samples(band, pixel_idx, L, lam, lam_pdf, filter_weight=fw,
                                        sequential=True)
        if wave_callback is not None:
            wave_callback(s, band.xyz, band.weight)
    stats.set_unit(wave=None)
    # the bands' XYZ and weight in one gather
    xyzw = gather_band(torch.cat([band.xyz, band.weight[:, None]], 1), mesh)
    with stats.span("image.develop"):
        film = film_mod.make_film(cam.height, cam.width, device)
        film = film._replace(xyz=xyzw[:, :3].contiguous(), weight=xyzw[:, 3].contiguous())
        return film_mod.develop(film)
