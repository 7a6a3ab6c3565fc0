"""treeNet trainer: Adam loop + checkpoint/resume (port of
nn_bvh_tpu/learn/trainer.py).

- One step: loss and gradients of treenet.loss_fn by autograd (the encoder
  recomputed under torch.utils.checkpoint), then Adam.
- Adam is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8): optax.adam's
  update, eps outside the square root in both.
- Checkpoints: `latest.pt`, torch.save of the model's and the optimizer's
  state dicts and the step; on resume the deterministic data stream is
  fast-forwarded by replaying its batches. The JAX package's pickles need
  optax to unpickle, so the port does not read them; weights cross through
  numpy (treenet.params_from_jax).
- Data parallelism over a device mesh waits for the port of dist/ (ROADMAP
  queue 1, item 7).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import treenet
from .treenet import TreeNetConfig

CHECKPOINT = "latest.pt"


class TrainState(NamedTuple):
    model: treenet.TreeNet
    optimizer: torch.optim.Optimizer
    step: int


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("data-parallel training over a mesh is not ported yet "
                                  "(ROADMAP queue 1, item 7: dist/)")


def make_optimizer(model: treenet.TreeNet, cfg: TreeNetConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def make_train_state(cfg: TreeNetConfig, seed: int = 0, device=None) -> TrainState:
    """A fresh model (random weights from a torch.Generator seeded with
    `seed`) and its Adam, at step 0."""
    model = treenet.init_params(cfg, seed, device)
    return TrainState(model, make_optimizer(model, cfg), 0)


def make_train_step(cfg: TreeNetConfig, mesh=None):
    """-> train_step(state, clouds) -> (state, metrics): one Adam step on
    the model in place, the state's step advanced."""
    _no_mesh(mesh)

    def train_step(state: TrainState, clouds: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = treenet.loss_fn(state.model, cfg, clouds)
        loss.backward()
        state.optimizer.step()
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return state._replace(step=state.step + 1), metrics

    return train_step


def train(cfg: TreeNetConfig, scene, n_steps: int = 100, batch_size: int = 8, seed: int = 0,
          checkpoint_dir: str | None = None, checkpoint_window: int = 15, log_every: int = 10,
          mesh=None, callback=None, device=None):
    """Training loop -> (state, history). History rows hold the metrics as
    floats, in sorted key order (as the JAX package's jitted dicts come
    back), and the step."""
    _no_mesh(mesh)
    state = make_train_state(cfg, seed, device)
    dev = next(state.model.parameters()).device
    start = 0
    if checkpoint_dir and os.path.exists(os.path.join(checkpoint_dir, CHECKPOINT)):
        state = load_checkpoint(checkpoint_dir, state)
        start = state.step
        # fast-forward the deterministic stream by replaying its batches
        for _ in range(start):
            scene.next_batch(batch_size)
    step = make_train_step(cfg)
    history = []
    for i in range(start, n_steps):
        clouds = torch.as_tensor(scene.next_batch(batch_size), device=dev)
        state, metrics = step(state, clouds)
        if (i + 1) % log_every == 0 or i == n_steps - 1:
            m = {k: float(metrics[k]) for k in sorted(metrics)}
            m["step"] = i + 1
            history.append(m)
            if callback is not None:
                callback.on_log(state, metrics)
        if checkpoint_dir and (i + 1) % checkpoint_window == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state, history


def save_checkpoint(path: str, state: TrainState, name: str = CHECKPOINT) -> None:
    """torch.save of the state dicts and the step, written whole or not at
    all (a temporary file renamed)."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, name)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, out + ".tmp")
    os.replace(out + ".tmp", out)


def load_checkpoint(path: str, template: TrainState, name: str = CHECKPOINT) -> TrainState:
    """Load a checkpoint into the template's model and optimizer (in place)
    -> the state at the saved step."""
    dev = next(template.model.parameters()).device
    ck = torch.load(os.path.join(path, name), map_location=dev, weights_only=True)
    template.model.load_state_dict(ck["model"])
    template.optimizer.load_state_dict(ck["optimizer"])
    return template._replace(step=int(ck["step"]))
