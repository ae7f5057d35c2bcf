"""Faults planted in the program underneath a run, to show that ``correct``
comes out false on each fault a cell can have. Each is a context manager
that patches the port and restores it on exit; ``benchmark/readings.py``
reads them on the card and the tests on the CPU.

- ``rollout_unchanged``: every rollout step returns the state it was given;
- ``answer_altered``: one body's predicted acceleration is altered where the
  model makes it (rollout and training);
- ``train_unchanged``: the optimiser step leaves the parameters unchanged;
- ``half_batch``: half of the batch's bodies are left out of the loss, the
  mean taken over the rest.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = {"rollout": ("rollout_unchanged", "answer_altered"),
         "train": ("train_unchanged", "half_batch", "answer_altered")}


@contextlib.contextmanager
def _patched(pairs):
    """Set each (object, attribute, value) for the duration."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    try:
        for obj, name, value in pairs:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def rollout_unchanged():
    import nbody_tpu_torch.train.rollout as ro

    orig = ro.autoregressive_rollout

    def stuck(*args, **kwargs):
        ps, vs, accs = orig(*args, **kwargs)
        return ps[:1].expand_as(ps).clone(), vs[:1].expand_as(vs).clone(), accs

    return _patched([(ro, "autoregressive_rollout", stuck)])


def answer_altered():
    from nbody_tpu_torch.models import ContinuousConvModel, GraphModel

    pairs = []
    for cls in (GraphModel, ContinuousConvModel):
        def altered(self, *args, _orig=cls.forward, **kwargs):
            out = _orig(self, *args, **kwargs).clone()
            out[:, 1] += out.detach().abs().max()
            return out

        pairs.append((cls, "forward", altered))
    return _patched(pairs)


def train_unchanged():
    return _patched([(torch.optim.Adam, "step", lambda self, closure=None: None)])


def half_batch():
    import nbody_tpu_torch.train.trainer as tr

    orig = tr.scaled_rmse_and_mse

    def half(pred, target, scale, node_mask=None):
        mask = torch.ones(pred.shape[:2], dtype=torch.bool, device=pred.device)
        mask[:, pred.shape[1] // 2:] = False
        return orig(pred, target, scale, node_mask=mask)

    return _patched([(tr, "scaled_rmse_and_mse", half)])


def plant(name: str):
    """The context manager of the fault ``name``."""
    return {"rollout_unchanged": rollout_unchanged, "answer_altered": answer_altered,
            "train_unchanged": train_unchanged, "half_batch": half_batch}[name]()
