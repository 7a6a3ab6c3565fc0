"""Multi-process launch and render-state checkpoints (port of
nn_bvh_tpu/dist/multihost.py).

- `initialize()`: torch.distributed bring-up from torchrun's environment
  (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or explicit arguments, where
  the JAX package reads JAX_COORDINATOR, JAX_NUM_PROCESSES and
  JAX_PROCESS_ID. The same render and train code (sharding.py,
  learn/trainer.py, learn/joint.py) then runs over the group's mesh.
- `run_local()`: start a process group of N processes on this host with
  torchrun's environment (what `torchrun --nproc_per_node=N` does,
  without its agent), with a time limit.
- `save_render_state()` / `load_render_state()`: each rank's checkpoint of
  (its film band, the next sample index, params), so a killed render
  resumes at the next wave boundary. The samplers are deterministic in
  (pixel, sample index), so the resumed image is bit-identical to an
  uninterrupted one. The file layout is the JAX package's: a render state
  it wrote loads here.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout_s: float | None = None) -> bool:
    """Join the process group -> True when this call initialized it.

    coordinator "host:port" (default MASTER_ADDR:MASTER_PORT),
    num_processes (default WORLD_SIZE, else 1) and process_id (default
    RANK, else 0). A no-op for one process, or when a group is already
    initialized. The group's backend is gloo (sharding.py gathers and
    reduces over it on the host), which serves ranks that share a card as
    well as ranks on the CPU. More than one process
    without a coordinator raises ValueError (the JAX package returns
    quietly, and each process would then render the whole image)."""
    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or dist.is_initialized():
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes and no coordinator: set MASTER_ADDR and "
                         "MASTER_PORT (torchrun does) or pass coordinator='host:port'")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def run_local(argv: list, nproc: int, timeout_s: float, env: dict | None = None,
              cwd: str | None = None) -> list:
    """Run `argv` (e.g. [sys.executable, "-m", module, ...]) as `nproc`
    processes of one group on this host: MASTER_ADDR 127.0.0.1, a free
    MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK set over `env` (default
    this process's). -> [(return code, output)] in rank order, standard
    output and error together. Past `timeout_s` every process is killed
    and TimeoutError raised; no process outlives the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(nproc))
    logs = [tempfile.TemporaryFile() for _ in range(nproc)]
    procs = []
    try:
        for r in range(nproc):
            procs.append(subprocess.Popen(argv, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                                          stdout=logs[r], stderr=subprocess.STDOUT, cwd=cwd))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired as e:
        raise TimeoutError(f"{nproc} processes of {argv} ran past {timeout_s} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read().decode(errors="replace"))
            f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def local_band(R: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """[start, end) of the flat pixel range this rank owns (contiguous bands
    in rank order; R // world size pixels each)."""
    mesh = mesh or make_mesh(device="cpu")
    per = R // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def _flat_params(params) -> list:
    """A module's state_dict() values in their order, or a sequence's items
    in order (a JAX tuple of arrays flattens in that order)."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    return list(params)


def _rank(mesh: Mesh | None) -> int:
    return (mesh or make_mesh(device="cpu")).rank


def save_render_state(path: str, xyz, weight, next_sample: int, params=None,
                      mesh: Mesh | None = None) -> None:
    """This rank's checkpoint, `{path}.proc{rank}.npz`: its film band (xyz
    (R_local, 3), weight (R_local,)) under "xyz" and "weight", the next
    sample index under "next_sample" (int64), and the params (see
    _flat_params) as "param_0", "param_1", ..."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    shards = {"xyz": host(xyz), "weight": host(weight), "next_sample": np.int64(next_sample)}
    if params is not None:
        for i, leaf in enumerate(_flat_params(params)):
            shards[f"param_{i}"] = host(leaf)
    np.savez(f"{path}.proc{_rank(mesh)}", **shards)


def load_render_state(path: str, params_template=None, mesh: Mesh | None = None):
    """This rank's checkpoint -> (xyz, weight, next_sample, params or None):
    numpy xyz and weight, an int, and, with a template, its module with the
    saved values loaded in place, or a list of CPU tensors in the
    sequence's order."""
    with np.load(f"{path}.proc{_rank(mesh)}.npz") as z:
        xyz, weight, next_sample = z["xyz"], z["weight"], int(z["next_sample"])
        params = None
        if params_template is not None:
            leaves = [torch.from_numpy(z[f"param_{i}"].copy())
                      for i in range(len(_flat_params(params_template)))]
            if isinstance(params_template, torch.nn.Module):
                keys = params_template.state_dict().keys()
                params_template.load_state_dict(dict(zip(keys, leaves)))
                params = params_template
            else:
                params = leaves
    return xyz, weight, next_sample, params
