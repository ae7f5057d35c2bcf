"""Optimiser and LR scheduling — the port of ``nbody_tpu/train/optim.py``:
Adam with torch's default betas and eps (the JAX package builds the same
optimiser with optax), and a ReduceLROnPlateau stepped once per epoch on
the mean epoch loss.

The trainer writes the scheduler's LR into the optimiser's
``param_groups`` between epochs.
"""

from __future__ import annotations

import dataclasses

import torch


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam(lr, betas=(0.9, 0.999), eps=1e-8), the settings of the JAX
    ``make_optimizer``."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class PlateauScheduler:
    """Exact ``torch.optim.lr_scheduler.ReduceLROnPlateau`` (mode='min',
    threshold_mode='rel') semantics, framework-free and identical to the
    JAX package's. The GNN experiment uses factor=0.25, patience=5; the
    ContConv experiment keeps factor=0.1, patience=10."""

    lr: float
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the (possibly reduced)
        lr. torch's order: best/num_bad update, then the cooldown decrement
        (which zeroes num_bad), then the patience check."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
        self.cooldown_counter = int(d["cooldown_counter"])
