"""Ring all-pairs gravity over a mesh axis — the port of
``nbody_tpu/parallel/ring.py``.

The particle axis is split over the ranks of the axis: each rank owns a
block of targets and a travelling block of sources. Every hop adds the
force of the resident source block on the local targets, then passes the
source block to the next rank (:func:`parallel.mesh.ppermute`, positions and
masses in one (chunk, 4) tensor). After ``n`` hops every target has seen
every source once.

Block backends (``backend``), named as the port names them elsewhere:

- ``"kernel"`` (JAX ``"pallas"``): B1's cross form,
  :func:`ops.pairwise.partial_accelerations`, which launches the kernel for
  CUDA tensors and runs its plain version for CPU tensors (so it also
  stands for JAX's ``"pallas_interpret"``). In a hop the only coincident
  pairs are global self-pairs; their exact difference is zero, so they
  cancel inside the kernel and no diagonal mask is passed.
- ``"dense"`` (JAX ``"dense"``): the (Ni, Nj) weight matrix with the
  ``diag_delta`` self-pair mask, ``W @ pos_j - pos_i * rowsum(W)``. It holds
  an (Ni, Nj, 3) difference tensor: for small shards.

Every function takes the global arrays (the same on every rank, as the JAX
functions take global arrays) and returns the global result on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nbody_tpu_torch.core.forces import kinetic_energy
from nbody_tpu_torch.core.integrators import INTEGRATORS
from nbody_tpu_torch.ops.pairwise import pair_potential, partial_accelerations
from nbody_tpu_torch.parallel.mesh import (PARTICLE_AXIS, Mesh, all_gather,
                                           particle_sharding, ppermute, psum)

BACKENDS = ("dense", "kernel")


def _block_accelerations_dense(pos_i, pos_j, mass_j, g_const, softening, diag_delta):
    """Force of sources ``(pos_j, mass_j)`` on targets ``pos_i``, global
    self-pairs (row - col == ``diag_delta`` = global col base - global row
    base) masked out: JAX ``_block_accelerations_dense``."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    diff = pos_j[None, :, :] - pos_i[:, None, :]
    d2 = (diff * diff).sum(-1) + float(softening) ** 2
    inv = torch.rsqrt(torch.clamp(d2, min=1e-30))
    w = inv * inv * inv * mass_j[None, :]
    row = torch.arange(ni, device=pos_i.device)[:, None]
    col = torch.arange(nj, device=pos_i.device)[None, :]
    w = torch.where(row - col == diag_delta, 0.0, w)
    return g_const * (w @ pos_j - pos_i * w.sum(1, keepdim=True))


def _block_accelerations_kernel(pos_i, pos_j, mass_j, g_const, softening, diag_delta):
    del diag_delta  # global self-pairs cancel inside B1 (zero difference)
    return partial_accelerations(pos_i, pos_j, mass_j, g_const, softening)


_BLOCK_BACKENDS = {"dense": _block_accelerations_dense,
                   "kernel": _block_accelerations_kernel}


def _check(backend: str) -> None:
    if backend not in _BLOCK_BACKENDS:
        raise ValueError(f"unknown ring backend {backend!r}: one of {BACKENDS}")


def _ring_acc_local(pos_l, mass_l, g_const, softening, mesh, axis, backend):
    """This rank's (N/n, 3) accelerations: n hops of the source ring."""
    n_dev, me, chunk = mesh.size(axis), mesh.index(axis), pos_l.shape[0]
    block = _BLOCK_BACKENDS[backend]
    src = torch.cat([pos_l, mass_l[:, None]], dim=1)  # [x, y, z, m]: one send a hop
    acc = torch.zeros_like(pos_l)
    for s in range(n_dev):
        delta = ((me - s) % n_dev - me) * chunk  # global col base - global row base
        acc = acc + block(pos_l, src[:, :3].contiguous(), src[:, 3].contiguous(),
                          g_const, softening, delta)
        if s < n_dev - 1:
            src = ppermute(src, mesh, axis)
    return acc


@torch.no_grad()
def ring_accelerations(pos, mass, g_const: float, softening: float, mesh: Mesh,
                       axis: str = PARTICLE_AXIS, backend: str = "dense") -> torch.Tensor:
    """Direct-sum accelerations (N, 3) with the particle axis split over
    ``mesh``'s ``axis``; N divisible by its size (pad with zero-mass
    slots otherwise)."""
    _check(backend)
    sh = particle_sharding(mesh, axis)
    acc_l = _ring_acc_local(sh.local(pos), sh.local(mass), g_const, softening, mesh,
                            axis, backend)
    return all_gather(acc_l, mesh, axis)


def _ring_energies_local(pos_l, vel_l, mass_l, g_const, softening, mesh, axis):
    """(U, K) from this rank's shard, both psum-ed: B2 masked on hop 0 (the
    shard's own pairs, once each) and B2's cross form on the later hops,
    halved (each cross pair is met from both of its ranks)."""
    n_dev = mesh.size(axis)
    u = pair_potential(pos_l, mass_l, pos_l, mass_l, g_const, softening,
                       masked=True).double()
    src = torch.cat([pos_l, mass_l[:, None]], dim=1)
    for _ in range(1, n_dev):
        src = ppermute(src, mesh, axis)
        u = u + 0.5 * pair_potential(pos_l, mass_l, src[:, :3].contiguous(),
                                     src[:, 3].contiguous(), g_const, softening,
                                     masked=False).double()
    k = kinetic_energy(vel_l, mass_l).double()
    u, k = psum(torch.stack([u, k]), mesh, axis).float()
    return u, k


@torch.no_grad()
def ring_energies(pos, vel, mass, g_const: float, softening: float, mesh: Mesh,
                  axis: str = PARTICLE_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U, K) with the semantics of ``core.forces.energies``,
    U = -G sum_{i<j} m_i m_j / (d_ij + eps), over the ring. Each hop's
    block goes through B2 (:func:`ops.pairwise.pair_potential`: the kernel
    for CUDA tensors, its plain version for CPU ones); the hops' terms are
    added in float64. JAX forms the same sums densely with norm-expansion
    distances; the exact differences here differ from it by rounding."""
    sh = particle_sharding(mesh, axis)
    return _ring_energies_local(sh.local(pos), sh.local(vel), sh.local(mass), g_const,
                                softening, mesh, axis)


@torch.no_grad()
def ring_simulate(pos, vel, mass, steps: int, g_const: float, softening: float,
                  dt: float, mesh: Mesh, integrator: str = "leapfrog",
                  backend: str = "dense", calc_energy: bool = False,
                  axis: str = PARTICLE_AXIS, return_trajectory: bool = False):
    """Multi-rank leapfrog / Euler rollout over ring force evaluations; the
    state stays split over ``axis`` for the whole run and is gathered at
    the end.

    :return: ``((pos, vel, acc), energies)``: the final (N, 3) state, or
        with ``return_trajectory`` the stacked (steps, N, 3) trajectories;
        ``energies`` is ``(u, k)`` of shape (steps,) when ``calc_energy``,
        else None.
    """
    _check(backend)
    sh = particle_sharding(mesh, axis)
    p, v, m = (sh.local(t.to(torch.float32)) for t in (pos, vel, mass))
    step = INTEGRATORS[integrator]

    def acc_fn(q):
        return _ring_acc_local(q, m, g_const, softening, mesh, axis, backend)

    a = acc_fn(p)
    traj, us, ks = [], [], []
    for _ in range(steps):
        p, v, a = step(p, v, a, acc_fn, dt)
        if calc_energy:
            u, k = _ring_energies_local(p, v, m, g_const, softening, mesh, axis)
            us.append(u)
            ks.append(k)
        if return_trajectory:
            traj.append((p, v, a))
    if return_trajectory:
        # (steps, N/n, 3) per rank, gathered along the particle axis
        out = tuple(all_gather(torch.stack(t).transpose(0, 1).contiguous(), mesh, axis)
                    .transpose(0, 1) for t in zip(*traj))
    else:
        out = tuple(all_gather(t, mesh, axis) for t in (p, v, a))
    return out, ((torch.stack(us), torch.stack(ks)) if calc_energy else None)
