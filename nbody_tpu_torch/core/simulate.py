"""Whole-trajectory simulation — the port of ``nbody_tpu/core/simulate.py``.

JAX runs the rollout as one ``lax.scan``. Here it is a Python step loop
whose every operation stays on the device: each step writes into
preallocated ``(steps, N, 3)`` and ``(steps,)`` tensors, and nothing is read
back to the host until the caller asks (no ``.item()`` per step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from nbody_tpu_torch.core import forces
from nbody_tpu_torch.core.integrators import INTEGRATORS

FORCE_BACKENDS = ("dense", "kernel", "auto")
_TREECODE_BACKENDS = ("bh", "bh2", "bh3")


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Static simulation parameters.

    ``force_backend``: "dense" (O(N^2) torch ops, ``core.forces``), "kernel"
    (the B1/B2 kernels of ``ops.pairwise``; their torch twins on the CPU) or
    "auto", which is "kernel" for CUDA tensors and "dense" otherwise. The
    JAX package's size threshold for its auto choice was tuned on a TPU and
    is not carried over.
    """

    g_const: float = 1.0
    softening: float = 0.1
    dt: float = 0.01
    integrator: str = "leapfrog"  # "leapfrog" | "euler"
    calc_energy: bool = True
    force_backend: str = "auto"

    def __post_init__(self):
        if self.integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.force_backend in _TREECODE_BACKENDS:
            raise NotImplementedError(
                f"force_backend={self.force_backend!r}: the Barnes-Hut "
                "treecodes are not ported yet (ROADMAP.md, queue A item 10)")
        if self.force_backend not in FORCE_BACKENDS:
            raise ValueError(f"unknown force backend {self.force_backend!r}")


class Trajectory(NamedTuple):
    """Stacked per-step post-update states."""

    positions: torch.Tensor  # (steps, N, 3)
    velocities: torch.Tensor  # (steps, N, 3)
    accelerations: torch.Tensor  # (steps, N, 3)
    u_energy: Optional[torch.Tensor]  # (steps,) or None
    k_energy: Optional[torch.Tensor]  # (steps,) or None


def resolve_backend(config: SimulationConfig, device: torch.device) -> str:
    if config.force_backend != "auto":
        return config.force_backend
    return "kernel" if torch.device(device).type == "cuda" else "dense"


def make_acc_fn(mass, config: SimulationConfig, mask=None) -> Callable:
    """Bind masses and constants into a ``pos -> acc`` closure on the
    configured backend."""
    g, eps = config.g_const, config.softening
    if resolve_backend(config, mass.device) == "kernel":
        from nbody_tpu_torch.ops.pairwise import accelerations

        return lambda pos: accelerations(pos, mass, g, eps, mask=mask)
    return lambda pos: forces.pairwise_accelerations(pos, mass, g, eps, mask=mask)


def make_energy_fn(mass, config: SimulationConfig, mask=None) -> Callable:
    """``(pos, vel) -> (U, K)`` as 0-d tensors, on the same backend decision
    as the forces."""
    g, eps = config.g_const, config.softening
    if resolve_backend(config, mass.device) == "kernel":
        from nbody_tpu_torch.ops.pairwise import potential_energy

        return lambda pos, vel: (
            potential_energy(pos, mass, g, eps, mask=mask),
            forces.kinetic_energy(vel, mass, mask),
        )
    return lambda pos, vel: forces.energies(pos, vel, mass, g, eps, mask=mask)


@torch.no_grad()
def simulate(pos, vel, mass, steps: int, config: SimulationConfig,
             mask=None) -> Trajectory:
    """Run ``steps`` integration steps and return the stacked trajectory.

    The initial force evaluation seeds the loop (reference
    ``simulation.py:69``); each step then applies the integrator and, with
    ``calc_energy``, the O(N^2) energy diagnostics. Runs on the device of
    ``pos``.

    :param pos: (N, 3) initial positions.
    :param vel: (N, 3) initial velocities.
    :param mass: (N,) masses.
    :param mask: optional (N,) validity mask for padded slots.
    """
    pos = torch.as_tensor(pos, dtype=torch.float32)
    dev = pos.device
    vel = torch.as_tensor(vel, dtype=torch.float32, device=dev)
    mass = torch.as_tensor(mass, dtype=torch.float32, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)

    acc_fn = make_acc_fn(mass, config, mask=mask)
    energy_fn = make_energy_fn(mass, config, mask=mask)
    step_fn = INTEGRATORS[config.integrator]

    n = pos.shape[0]
    ps = torch.empty((steps, n, 3), dtype=torch.float32, device=dev)
    vs = torch.empty_like(ps)
    accs = torch.empty_like(ps)
    us = ks = None
    if config.calc_energy:
        us = torch.empty(steps, dtype=torch.float32, device=dev)
        ks = torch.empty_like(us)

    p, v, a = pos, vel, acc_fn(pos)
    for s in range(steps):
        p, v, a = step_fn(p, v, a, acc_fn, config.dt)
        ps[s], vs[s], accs[s] = p, v, a
        if config.calc_energy:
            us[s], ks[s] = energy_fn(p, v)
    return Trajectory(ps, vs, accs, us, ks)
