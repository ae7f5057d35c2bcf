"""Disk-galaxy initial conditions — the port of ``nbody_tpu/ics/disk.py``
(reference ``src/galaxify/galaxies.py:54-192``).

Drawn from ``jax.random``'s keyed streams (``utils.prng``), so a key gives
the JAX package's galaxy: exponential radial sampling, rim-tapered heights,
Hernquist mass weights, enclosed-mass circular velocities. The enclosed mass
is a sort + prefix sum + searchsorted, O(N log N) and exact under ties.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ics.profiles import _F32_EPS, spherical_hernquist_distribution
from nbody_tpu_torch.utils import prng


def euler_rotation_matrix(angle) -> torch.Tensor:
    """Composed rotation ``R = Rz @ Ry @ Rx`` applied as ``x @ R.T`` —
    the reference's ``pos @ rx.T @ ry.T @ rz.T``."""
    ax, ay, az = (float(a) for a in angle)
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    rx = torch.tensor([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=torch.float32)
    ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=torch.float32)
    rz = torch.tensor([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=torch.float32)
    return rz @ ry @ rx


def enclosed_mass(distances: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    """m_enc[i] = sum of masses at strictly smaller radius (exact under ties)."""
    d_sorted, order = torch.sort(distances)
    csum = torch.cumsum(masses[order], dim=0)
    # index of the first element with d_sorted >= d == count of strictly smaller
    idx = torch.searchsorted(d_sorted, distances, side="left")
    return torch.where(idx > 0, csum[torch.clamp(idx - 1, min=0)], 0.0)


def generate_disk(
    key: torch.Tensor,
    n_bodies: int,
    total_mass: float = 1.0,
    radial_scale: float = 3.0,
    height_scale: float = 0.3,
    g_const: float = 4.5e-6,
    black_hole_mass: float = 0.01,
    offset=(0.0, 0.0, 0.0),
    initial_vel=(0.0, 0.0, 0.0),
    clockwise: bool = True,
    angle=(0.0, 0.0, 0.0),
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Disk galaxy with a central black hole (reference ``generate_disk``).

    Body 0 is the black hole (mass fraction ``black_hole_mass`` of
    ``total_mass``) at the origin; stars get exponential radii, rim-tapered
    heights, Hernquist-weighted masses and circular orbital velocities from
    the enclosed mass.

    :param key: a ``utils.prng`` key (``prng.PRNGKey(seed)``; replaces the
        reference's ``np.random.seed``), split as JAX splits it.
    :param device: where the draws run and the result goes (default: the
        key's device).
    :return: (positions (N,3), velocities (N,3), masses (N,)) float32.
    """
    gdev = key.device if device is None else torch.device(device)
    f32 = torch.float32
    k_r, k_z, k_phi = prng.split(key, 3, gdev)
    is_star = torch.arange(n_bodies, device=gdev) != 0  # body 0 = black hole

    # Exponential radial sampling: -R_d * log(1 - U), U in [eps, 1)
    distances = -radial_scale * torch.log(1.0 - prng.uniform(k_r, n_bodies, _F32_EPS, 1.0))
    distances = torch.where(is_star, distances, 0.0)

    # Height tapering toward the rim; the reference keeps the (possibly
    # negative) 1 - sqrt(d) factor as-is, and so does this.
    zs = (prng.uniform(k_z, n_bodies, -1.0, 1.0) * height_scale
          * (1.0 - torch.sqrt(distances)))
    zs = torch.where(is_star, zs, 0.0)

    phi = prng.uniform(k_phi, n_bodies, 0.0, 2 * math.pi)
    positions = torch.stack(
        [torch.cos(phi) * distances, torch.sin(phi) * distances, zs], dim=1)

    # Masses: BH fraction + Hernquist-weighted stars normalised to the rest.
    mass_bh = total_mass * black_hole_mass
    star_weights = spherical_hernquist_distribution(
        torch.where(is_star, distances, 1.0), r0=1.0, total_mass=total_mass)
    star_weights = torch.where(is_star, star_weights, 0.0)
    masses = star_weights * ((total_mass - mass_bh) / star_weights.sum())
    masses = torch.where(is_star, masses, mass_bh)

    # Circular velocities from the enclosed mass.
    m_enc = enclosed_mass(distances, masses)
    v = torch.sqrt(g_const * m_enc / torch.where(is_star, distances, 1.0))
    v = torch.where(is_star, v, 0.0)
    velocities = torch.stack(
        [v * torch.cos(phi + math.pi / 2), v * torch.sin(phi + math.pi / 2),
         torch.zeros_like(v)], dim=1)
    if clockwise:
        velocities = velocities * torch.tensor([-1.0, -1.0, 1.0], device=gdev)

    rot = euler_rotation_matrix(angle).to(gdev)
    positions = positions @ rot.T + torch.tensor(offset, dtype=f32, device=gdev)
    velocities = velocities @ rot.T + torch.tensor(initial_vel, dtype=f32, device=gdev)
    return positions, velocities, masses
