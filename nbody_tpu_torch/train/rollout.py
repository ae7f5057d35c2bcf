"""Autoregressive surrogate rollout — the port of ``nbody_tpu/train/rollout.py``
(reference ``trainer.py:217-344``).

The JAX package runs the rollout as one ``lax.scan``; here it is a step loop
that keeps every tensor on the model's device and writes into preallocated
(steps, N, 3) outputs, with no host readback per step. The model's weights
live in the module, so the JAX functions' ``variables`` argument has no
counterpart.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from nbody_tpu_torch.train.graphs import build_graph


def _spec(model, graph_spec):
    """``model.graph_spec``, or an override given as (kind, dict) or as the
    JAX package's hashable (kind, tuple(dict.items()))."""
    if graph_spec is None:
        return model.graph_spec
    return graph_spec[0], dict(graph_spec[1])


@contextlib.contextmanager
def _eval_mode(model):
    """The forward in eval mode (batch norms use their running statistics
    and leave them alone, dropout is off), as the JAX functions apply the
    model with ``train=False``; the module's own mode comes back after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


@torch.no_grad()
def predict_accelerations(model, pos, vel, mass, graph_spec=None):
    """Single-snapshot surrogate force: build the model's neighbour graph
    from positions and run the forward pass in eval mode, whatever mode the
    module is in.

    :param pos, vel: (N, 3); :param mass: (N,).
    :return: (N, 3) predicted accelerations.
    """
    x = torch.cat([pos, vel, mass[:, None]], dim=-1)[None]
    idx, valid = build_graph(_spec(model, graph_spec), x[..., :3])
    with _eval_mode(model):
        return model(x, idx, valid)[0]


@torch.no_grad()
def autoregressive_rollout(
    model,
    pos0: torch.Tensor,
    vel0: torch.Tensor,
    mass: torch.Tensor,
    steps: int,
    dt: float,
    graph_spec=None,
    graph_refresh: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roll one scene forward with the surrogate force model.

    Each step is the reference ``Trainer.step``: half-kick with the previous
    acceleration, drift, predict a(t+dt) from the drifted positions and
    half-kicked velocities, half-kick again. The initial acceleration is
    predicted from the given step-0 state. Every forward runs in eval mode;
    the module's own mode is restored at the end.

    :param graph_spec: override of ``model.graph_spec``.
    :param graph_refresh: 1 rebuilds the graph from the drifted positions at
        every step. r > 1 builds it once per segment of r steps, from the
        positions at the segment's start, and reuses it within the segment
        (the JAX package's segment semantics).
    :return: (pos, vel, acc), each (steps, N, 3); row 0 is the initial state
        with the predicted initial acceleration.
    """
    spec = _spec(model, graph_spec)
    mass_col = mass[:, None]

    def forward(pos, vel, idx, valid):
        x = torch.cat([pos, vel, mass_col], dim=-1)[None]
        return model(x, idx, valid)[0]

    def predict(pos, vel):
        idx, valid = build_graph(spec, pos[None])
        return forward(pos, vel, idx, valid)

    n = pos0.shape[0]
    ps = torch.empty((steps, n, 3), dtype=pos0.dtype, device=pos0.device)
    vs = torch.empty_like(ps)
    accs = torch.empty_like(ps)
    with _eval_mode(model):
        pos, vel, acc = pos0, vel0, predict(pos0, vel0)
        ps[0], vs[0], accs[0] = pos, vel, acc
        idx = valid = None
        for s in range(1, steps):
            if graph_refresh > 1 and (s - 1) % graph_refresh == 0:
                idx, valid = build_graph(spec, pos[None])
            v_half = vel + 0.5 * dt * acc
            pos = pos + dt * v_half
            if graph_refresh > 1:
                acc = forward(pos, v_half, idx, valid)
            else:
                acc = predict(pos, v_half)
            vel = v_half + 0.5 * dt * acc
            ps[s], vs[s], accs[s] = pos, vel, acc
    return ps, vs, accs
