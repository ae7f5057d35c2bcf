"""Whole-trajectory simulation — the port of ``nbody_tpu/core/simulate.py``.

JAX runs the rollout as one ``lax.scan``. Here it is a Python step loop
whose every operation stays on the device: each step writes into
preallocated ``(steps, N, 3)`` and ``(steps,)`` tensors, and nothing is read
back to the host until the caller asks (no ``.item()`` per step).

A group of scenes of equal shape, stacked on a leading axis, runs as one
loop (what ``jax.vmap(simulate)`` computes): the direct-sum backends launch
B1 and B2 once a step for the whole group, the treecodes carry one group
partition and launch B9, B10 and B1's near list once a force evaluation for
the whole group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from nbody_tpu_torch.core import forces
from nbody_tpu_torch.core.integrators import INTEGRATORS

TREECODE_BACKENDS = ("bh", "bh2", "bh3")
FORCE_BACKENDS = ("dense", "kernel", "auto") + TREECODE_BACKENDS


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Static simulation parameters.

    ``force_backend``: "dense" (O(N^2) torch ops, ``core.forces``), "kernel"
    (the B1/B2 kernels of ``ops.pairwise``; their torch twins on the CPU),
    "auto", which is "kernel" for CUDA tensors and "dense" otherwise, or a
    treecode of ``ops.treeforce``: "bh", "bh2", "bh3" (B9, B10 and B1's
    near-list form for CUDA tensors, the dense near pass otherwise; energies
    stay exact). The JAX package's size threshold for its auto choice was
    tuned on a TPU and is not carried over.
    """

    g_const: float = 1.0
    softening: float = 0.1
    dt: float = 0.01
    integrator: str = "leapfrog"  # "leapfrog" | "euler"
    calc_energy: bool = True
    force_backend: str = "auto"
    # "bh" knobs (ops/treeforce.py): exact near-set size, Morton block rows,
    # and how often the partition (sort + near sets) is rebuilt — forces are
    # always computed from fresh positions, a stale partition only degrades
    # which blocks are treated exactly.
    bh_near: int = 32
    bh_block: int = 256
    bh_refresh: int = 1
    # "bh2" adds a coarse far level: superblocks of bh_coarse fine blocks;
    # bh_rc refined superblocks per receiver group. Drops the O(N * nb) far
    # term by ~bh_coarse at 1M+.
    bh_coarse: int = 16
    bh_rc: int = 32
    # "bh3" sub-refines the near pass: each near block's rows split into
    # sub-blocks of bh_sub_block rows; bh_n_sub of them are evaluated
    # exactly per receiver block, the rest through their own quadrupoles.
    bh_sub_block: int = 32
    bh_n_sub: int = 24

    def __post_init__(self):
        if self.integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.force_backend not in FORCE_BACKENDS:
            raise ValueError(f"unknown force backend {self.force_backend!r}")


class Trajectory(NamedTuple):
    """Stacked per-step post-update states; a group of S scenes has a scene
    axis after the step axis."""

    positions: torch.Tensor  # (steps, N, 3) or (steps, S, N, 3)
    velocities: torch.Tensor  # (steps, N, 3) or (steps, S, N, 3)
    accelerations: torch.Tensor  # (steps, N, 3) or (steps, S, N, 3)
    u_energy: Optional[torch.Tensor]  # (steps,) or (steps, S), or None
    k_energy: Optional[torch.Tensor]  # (steps,) or (steps, S), or None


def resolve_backend(config: SimulationConfig, device: torch.device) -> str:
    if config.force_backend != "auto":
        return config.force_backend
    return "kernel" if torch.device(device).type == "cuda" else "dense"


def treecode_fns(mass, config: SimulationConfig, mask=None, i_chunk: int = 8):
    """``(build, acc)`` of the configured treecode: ``build(pos)`` makes a
    partition, ``acc(pos, partition)`` the accelerations under it (the near
    pass ``auto``: the kernels for CUDA tensors; ``i_chunk`` bounds the dense
    near pass). A group of scenes (``mass`` (S, N), ``pos`` (S, N, 3)) gets
    a group partition and ``(S, N, 3)`` accelerations. A treecode takes no
    mask."""
    from nbody_tpu_torch.ops import treeforce as tf

    c, name = config, config.force_backend
    if mask is not None:
        raise ValueError(f"force_backend={name!r} does not support masks")
    kw = dict(n_near=c.bh_near, block=c.bh_block)
    if name != "bh":
        kw.update(coarse=c.bh_coarse, rc=c.bh_rc)
    if name == "bh3":
        kw.update(sub_block=c.bh_sub_block, n_sub=c.bh_n_sub)
    # looked up per call, so that a test may wrap the module's functions
    return (lambda p: getattr(tf, f"build_{name}_partition")(p, mass, **kw),
            lambda p, part: getattr(tf, f"{name}_accelerations")(
                p, mass, c.g_const, c.softening, partition=part, i_chunk=i_chunk))


def make_acc_fn(mass, config: SimulationConfig, mask=None) -> Callable:
    """Bind masses and constants into a ``pos -> acc`` closure on the
    configured backend; every backend takes a group of scenes (``mass`` (S,
    N)). A treecode builds a fresh partition per call."""
    g, eps = config.g_const, config.softening
    if config.force_backend in TREECODE_BACKENDS:
        build, acc = treecode_fns(mass, config, mask)
        return lambda pos: acc(pos, build(pos))
    if resolve_backend(config, mass.device) == "kernel":
        from nbody_tpu_torch.ops.pairwise import accelerations

        return lambda pos: accelerations(pos, mass, g, eps, mask=mask)
    return lambda pos: forces.pairwise_accelerations(pos, mass, g, eps, mask=mask)


def make_potential_fn(mass, config: SimulationConfig, mask=None) -> Callable:
    """``pos -> U``, a 0-d tensor (``(S,)`` for a group), on the same backend
    decision as the forces. Energies are always exact: a treecode maps to B2
    on a CUDA device and to the dense path otherwise."""
    g, eps = config.g_const, config.softening
    backend = resolve_backend(config, mass.device)
    if backend in TREECODE_BACKENDS:
        backend = "kernel" if mass.device.type == "cuda" else "dense"
    if backend == "kernel":
        from nbody_tpu_torch.ops.pairwise import potential_energy

        return lambda pos: potential_energy(pos, mass, g, eps, mask=mask)
    return lambda pos: forces.potential_energy(pos, mass, g, eps, mask=mask)


@torch.no_grad()
def simulate(pos, vel, mass, steps: int, config: SimulationConfig,
             mask=None) -> Trajectory:
    """Run ``steps`` integration steps and return the stacked trajectory.

    The initial force evaluation seeds the loop (reference
    ``simulation.py:69``); each step then applies the integrator and, with
    ``calc_energy``, the O(N^2) potential energy; the kinetic energies come
    from the stacked velocities at the end (:func:`forces.kinetic_energies`).
    Runs on the device of ``pos``. A treecode with ``bh_refresh > 1``
    carries its partition and rebuilds it before step i's force evaluation
    when ``i % bh_refresh == 0 and i > 0``, as the JAX scan does; the
    initial partition seeds the first acceleration.

    A group of S scenes (``pos``/``vel`` (S, N, 3), ``mass`` (S, N)) gives
    a :class:`Trajectory` with a scene axis after the step axis, each scene
    what a run of it alone gives, in one step loop: on the card B1 and B2
    launch once a step for all of it, and a treecode carries one partition
    of the group (rebuilt for every scene at once) and launches each of its
    kernels once a force evaluation, with each scene's single-call bits.

    :param pos: (N, 3) initial positions, or (S, N, 3).
    :param vel: (N, 3) initial velocities, or (S, N, 3).
    :param mass: (N,) masses, or (S, N).
    :param mask: optional (N,) validity mask for padded slots, shared by a
        group's scenes.
    """
    pos = torch.as_tensor(pos, dtype=torch.float32)
    dev = pos.device
    vel = torch.as_tensor(vel, dtype=torch.float32, device=dev)
    mass = torch.as_tensor(mass, dtype=torch.float32, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    potential_fn = make_potential_fn(mass, config, mask=mask)
    carry = config.force_backend in TREECODE_BACKENDS and config.bh_refresh > 1
    if carry:
        build, bh_acc = treecode_fns(mass, config, mask)
        part = build(pos)
        acc_fn = lambda q: bh_acc(q, part)  # noqa: E731 (reads `part` when called)
    else:
        acc_fn = make_acc_fn(mass, config, mask=mask)
    step_fn = INTEGRATORS[config.integrator]

    lead = tuple(pos.shape[:-1])  # (N,) or (S, N)
    ps = torch.empty((steps, *lead, 3), dtype=torch.float32, device=dev)
    vs = torch.empty_like(ps)
    accs = torch.empty_like(ps)
    us = ks = None
    if config.calc_energy:
        us = torch.empty((steps, *lead[:-1]), dtype=torch.float32, device=dev)

    p, v, a = pos, vel, acc_fn(pos)
    for s in range(steps):
        if carry and s > 0 and s % config.bh_refresh == 0:
            part = build(p)
        p, v, a = step_fn(p, v, a, acc_fn, config.dt)
        ps[s], vs[s], accs[s] = p, v, a
        if config.calc_energy:
            us[s] = potential_fn(p)
    if config.calc_energy:
        ks = forces.kinetic_energies(vs, mass, mask)
    return Trajectory(ps, vs, accs, us, ks)
