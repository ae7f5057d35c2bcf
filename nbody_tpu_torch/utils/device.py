"""The device of a run: the CUDA device unless the caller names another.
Without a card this raises; a run on the CPU is asked for, never fallen
back to."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device. Without one this raises: a run on the CPU is asked
    for (``--device cpu``), never fallen back to."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device("cuda")


def resolve_device(name=None) -> torch.device:
    """The device named by ``name`` (a ``--device`` flag or a ``device=``
    argument) when given, else :func:`default_device`."""
    return torch.device(name) if name else default_device()
