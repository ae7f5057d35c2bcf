"""NaN/Inf guards — the port of ``nbody_tpu/utils/debug.py``, which raises
through ``jax.experimental.checkify``. Here a guard reduces every floating
tensor to one finiteness flag on its device and reads the flags back once.
The experiment entry points' ``--check`` flags run it on the trained parameters.
"""

from __future__ import annotations

from typing import Iterator

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def throw_if_nonfinite(tree, what: str = "state") -> None:
    """Raise ``FloatingPointError`` when any floating tensor of ``tree`` (a
    module, a state dict, a tensor, or nested dicts, lists and tuples of
    them) holds a NaN or an Inf."""
    flags = [torch.isfinite(t).all() for t in _tensors(tree) if t.is_floating_point()]
    if flags and not bool(torch.stack([f.cpu() for f in flags]).all()):
        raise FloatingPointError(f"non-finite values detected in {what}")


def assert_finite_state(pos, vel, acc=None) -> None:
    """Raise if any state tensor went non-finite."""
    for name, t in (("pos", pos), ("vel", vel), ("acc", acc)):
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
