"""Checkpoints with latest-by-step resume — the port of
``nbody_tpu/train/checkpoint.py``.

One ``torch.save`` file per step, ``ckpt_<step>.pt``, written to a
temporary name and moved into place with ``os.replace``, so a reader sees a
whole file or none. The trainer stores in it the model's ``state_dict``
(parameters and batch-norm running statistics), the optimiser's and the
scheduler's state, the epoch and the random state that dropout draws from.
The format is not the JAX package's Orbax one: neither package reads the
other's checkpoints.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, tree: Any) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)

    def latest_step(self) -> Optional[int]:
        """The largest step among the saved files' names, or None."""
        steps = [int(m.group(1)) for f in os.listdir(self.directory)
                 if (m := _NAME.match(f))]
        return max(steps) if steps else None

    def restore_latest(self) -> Tuple[Optional[int], Any]:
        """(step, tree) of the latest checkpoint, tensors on the CPU, or
        (None, None) when nothing is saved."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, torch.load(self._path(step), map_location="cpu", weights_only=True)

    def delete(self, step: int) -> None:
        """Remove a saved step."""
        os.remove(self._path(step))

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX API."""
