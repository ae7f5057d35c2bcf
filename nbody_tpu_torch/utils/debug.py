"""NaN/Inf guards — the port of ``nbody_tpu/utils/debug.py``, which raises
through ``jax.experimental.checkify``. Here a guard reduces every floating
tensor to one finiteness flag on its device and reads the flags back once.
The experiment entry points' ``--check`` flags run it on the trained parameters.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import torch


class CheckError:
    """What a checked call found: ``throw()`` raises ``FloatingPointError``
    with the message when the check failed and does nothing otherwise
    (checkify's error value, without checkify)."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_accelerations(acc_fn: Callable) -> Callable:
    """Wrap a ``pos -> acc`` callable with a finite-output check: the
    wrapped call returns ``(err, acc)``, and ``err.throw()`` raises when the
    accelerations hold a NaN or an Inf. One readback a call."""

    def wrapped(pos):
        acc = acc_fn(pos)
        return CheckError(None if all_finite(acc) else "non-finite acceleration detected"), acc

    return wrapped


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


def all_finite(tree) -> bool:
    """True iff every floating tensor of ``tree`` (a module, a state dict, a
    tensor, or nested dicts, lists and tuples of them) is free of NaN/Inf:
    the flags are reduced on the device and read back once."""
    flags = [torch.isfinite(t).all() for t in _tensors(tree) if t.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).all())


def throw_if_nonfinite(tree, what: str = "state") -> None:
    """Raise ``FloatingPointError`` when any floating tensor of ``tree`` (as
    :func:`all_finite` takes it) holds a NaN or an Inf."""
    if not all_finite(tree):
        raise FloatingPointError(f"non-finite values detected in {what}")


def assert_finite_state(pos, vel, acc=None) -> None:
    """Raise if any state tensor went non-finite."""
    for name, t in (("pos", pos), ("vel", vel), ("acc", acc)):
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
