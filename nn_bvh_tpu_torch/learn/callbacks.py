"""Training callbacks: per-window test monitoring, CSV logs, best checkpoint
(port of nn_bvh_tpu/learn/callbacks.py).

After each logging window the callback evaluates the model on a fixed test
set (predicted tree cost, the greedy kd-tree's cost on the first cloud),
appends a CSV row under out_dir with the JAX package's columns, and keeps
the best-cost checkpoint (`<name>_best.pt`, trainer's format). Plot export
writes matplotlib PNGs when matplotlib is importable and returns None
otherwise.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import kd_tree, trainer, treenet


@dataclass
class TrainLog:
    """Callback object; call .on_log(state, metrics) from the train loop."""

    cfg: Any                      # TreeNetConfig
    out_dir: str
    test_clouds: "np.ndarray | None" = None   # (B, N, 9) fixed eval set
    name: str = "treenet"
    best_cost: float = field(default=np.inf)
    rows: list = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.out_dir, exist_ok=True)
        self._csv = os.path.join(self.out_dir, f"{self.name}_log.csv")

    def on_log(self, state, metrics: dict) -> dict:
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = int(state.step)
        if self.test_clouds is not None:
            dev = next(state.model.parameters()).device
            cost, _ = treenet.predict_tree(state.model, self.cfg,
                                           torch.as_tensor(self.test_clouds, device=dev))
            row["test_cost"] = float(cost.mean())
            # greedy reference comparison on the first cloud
            prims = np.asarray(self.test_clouds[0])
            greedy = kd_tree.build_greedy(prims, levels=self.cfg.levels, n_bins=8)
            row["greedy_cost"] = kd_tree.tree_cost(greedy, prims)
            if row["test_cost"] < self.best_cost:
                self.best_cost = row["test_cost"]
                trainer.save_checkpoint(self.out_dir, state, f"{self.name}_best.pt")
        self.rows.append(row)
        self._append_csv(row)
        return row

    def _append_csv(self, row: dict) -> None:
        exists = os.path.exists(self._csv)
        with open(self._csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(row))
            if not exists:
                w.writeheader()
            w.writerow({k: row.get(k, "") for k in sorted(row)})

    def export_plots(self) -> "str | None":
        """Loss/cost curves as PNG; None without matplotlib or rows."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        if not self.rows:
            return None
        steps = [r["step"] for r in self.rows]
        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        if "loss" in self.rows[0]:
            ax[0].plot(steps, [r.get("loss", np.nan) for r in self.rows])
            ax[0].set_title("loss")
        if any("test_cost" in r for r in self.rows):
            ax[1].plot(steps, [r.get("test_cost", np.nan) for r in self.rows],
                       label="predicted")
            ax[1].plot(steps, [r.get("greedy_cost", np.nan) for r in self.rows],
                       label="greedy", ls="--")
            ax[1].legend()
            ax[1].set_title("tree cost")
        out = os.path.join(self.out_dir, f"{self.name}_curves.png")
        fig.tight_layout()
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out
