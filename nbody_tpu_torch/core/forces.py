"""Direct-sum gravitational forces and energies, dense path — the port of
``nbody_tpu/core/forces.py``:

    a_i = G * sum_{j != i} m_j * (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
    K   = sum_i 1/2 m_i |v_i|^2
    U   = -G * sum_{i<j} m_i m_j / (|r_i - r_j| + eps)

O(N^2) memory; the kernels in ``nbody_tpu_torch.ops.pairwise`` compute the
same quantities in O(N). Every function takes an optional validity ``mask``
so padded particle slots contribute nothing, and a group of scenes stacked
on a leading axis (``(S, N, 3)`` positions, ``(S, N)`` masses, one shared
``(N,)`` mask), what ``jax.vmap`` of the JAX functions computes.
"""

from __future__ import annotations

import torch


def _pairwise_d2(pos):
    """(..., N, N) squared distances from exact displacement differences (no
    |a|^2 + |b|^2 - 2ab cancellation)."""
    diff = pos[..., None, :, :] - pos[..., :, None, :]
    return (diff * diff).sum(-1)


def _interaction_weights(pos, mass, softening, mask=None):
    """(..., N, N) W_ij = m_j / (|r_j - r_i|^2 + eps^2)^{3/2}, zero diagonal."""
    n = pos.shape[-2]
    d2 = _pairwise_d2(pos) + float(softening) ** 2
    inv_d = torch.rsqrt(d2)
    inv_d3 = inv_d * inv_d * inv_d
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    w = torch.where(eye, 0.0, inv_d3) * mass[..., None, :]
    if mask is not None:
        w = w * mask[None, :].to(w.dtype)
    return w


def pairwise_accelerations(pos, mass, g_const, softening, mask=None):
    """Softened direct-sum accelerations (N, 3), computed as
    ``W @ pos - pos * rowsum(W)`` exactly as the JAX dense path does.

    :param pos: (N, 3) positions, or (S, N, 3) for a group of scenes.
    :param mass: (N,) masses, or (S, N).
    :param mask: optional (N,) bool/0-1 validity for padded slots.
    """
    w = _interaction_weights(pos, mass, softening, mask)
    acc = g_const * (w @ pos - pos * w.sum(dim=-1, keepdim=True))
    if mask is not None:
        acc = acc * mask[:, None].to(acc.dtype)
    return acc


def kinetic_energy(vel, mass, mask=None):
    """Total kinetic energy sum(1/2 m |v|^2), a 0-d tensor (``(S,)`` for a
    group of scenes): one state of :func:`kinetic_energies`, with its bits."""
    return kinetic_energies(vel[None], mass, mask)[0]


def kinetic_energies(vels, mass, mask=None):
    """K of every state of a stacked trajectory: velocities (T, N, 3) give
    (T,), a group's (T, S, N, 3) with masses (S, N) give (T, S). Each body's
    term comes from elementwise operations and each scene's sum from a
    contiguous (T, N) tensor of them, so a scene's K has the same bits
    whether it ran alone or in a group: a reduction over (T, S, N) would
    cut the sum otherwise for every S."""
    v2 = vels[..., 0] * vels[..., 0] + vels[..., 1] * vels[..., 1] + vels[..., 2] * vels[..., 2]
    k = 0.5 * mass * v2
    if mask is not None:
        k = k * mask.to(k.dtype)
    if k.dim() == 2:
        return k.sum(-1)
    return torch.stack([k[:, s].contiguous().sum(-1) for s in range(k.shape[1])], dim=1)


# Above this size the dense (N, N) energy matrix stops fitting; stream row
# chunks instead (exact, O(chunk * N) memory).
_ENERGY_CHUNK_THRESHOLD = 4096
_ENERGY_CHUNK = 1024


def potential_energy(pos, mass, g_const, softening, mask=None, chunk_size=None):
    """Total pairwise potential energy, a 0-d tensor:

        U = -G * sum_{i<j} m_i m_j / (|r_i - r_j| + eps)

    The reference softens PE by *adding eps to the distance* (not in
    quadrature); this reproduces that. Large N streams row chunks so the
    (N, N) pair matrix is never materialised. A group of scenes gives (S,).
    """
    n = pos.shape[-2]
    if chunk_size is None:
        chunk_size = n if n <= _ENERGY_CHUNK_THRESHOLD else _ENERGY_CHUNK
    if chunk_size < n:
        return _potential_energy_chunked(pos, mass, g_const, softening, mask,
                                         chunk_size)
    dist = torch.sqrt(_pairwise_d2(pos)) + softening
    mm = mass[..., :, None] * mass[..., None, :]
    if mask is not None:
        m01 = mask.to(pos.dtype)
        mm = mm * m01[:, None] * m01[None, :]
    # strict upper triangle == each unordered pair once
    iu = torch.ones((n, n), dtype=torch.bool, device=pos.device).triu(1)
    pair = torch.where(iu, -mm / dist, 0.0)
    return g_const * pair.sum((-2, -1))


def _potential_energy_chunked(pos, mass, g_const, softening, mask, chunk_size):
    """Row-chunk streamed PE: each chunk adds its strict-upper-triangle
    pairs against the full set (global column > global row), with distances
    from the norm expansion as in the JAX chunked path."""
    n = pos.shape[-2]
    if mask is not None:
        mass = mass * mask.to(mass.dtype)
    cols = torch.arange(n, device=pos.device)
    sq = (pos * pos).sum(-1)
    total = torch.zeros(pos.shape[:-2], dtype=pos.dtype, device=pos.device)
    for start in range(0, n, chunk_size):
        rows = cols[start:start + chunk_size]
        pr, mr = pos[..., rows, :], mass[..., rows]
        d2 = ((pr * pr).sum(-1)[..., :, None] + sq[..., None, :]
              - 2.0 * (pr @ pos.transpose(-1, -2)))
        dist = torch.sqrt(torch.clamp(d2, min=0.0)) + softening
        upper = cols[None, :] > rows[:, None]
        total = total + torch.where(upper, -(mr[..., :, None] * mass[..., None, :]) / dist,
                                    0.0).sum((-2, -1))
    return g_const * total


def energies(pos, vel, mass, g_const, softening, mask=None):
    """(U, K) tuple of 0-d tensors."""
    return (
        potential_energy(pos, mass, g_const, softening, mask),
        kinetic_energy(vel, mass, mask),
    )
