"""Spiral-galaxy initial conditions — the port of ``nbody_tpu/ics/spiral.py``
(reference ``src/galaxify/galaxies.py:195-296``), vectorised over bodies.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)


def generate_spiral(
    generator: torch.Generator,
    n_bodies: int,
    total_mass: float = 1.0,
    radial_scale: float = 3.0,
    height_scale: float = 0.3,
    g_const: float = 4.5e-6,
    black_hole_mass: float = 0.01,
    n_arms: int = 2,
    pitch_angle: float = -math.pi / 6,
    arm_strength: float = 0.3,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spiral galaxy with a central black hole (reference ``generate_spiral``).

    - radii ~ Gamma(shape=2, scale=radial_scale), drawn as
      -log(u1) - log(u2) from two uniforms of ``generator``
      (``torch.distributions.Gamma`` takes no generator)
    - arm perturbation phi + A sin(n (phi - ln(r/Rd)/tan p))
    - gaussian z
    - v_circ from the exponential-disk enclosed mass M (1 - e^{-r/Rd}(1 + r/Rd))
    - dispersions (0.1, 0.07, 0.05) * v_circ
    - uniform star masses

    :param generator: the random stream; draws happen on its device.
    :param device: where the result goes (default: the generator's device).
    :return: (positions (N,3), velocities (N,3), masses (N,)) float32.
    """
    gdev = generator.device
    f32 = torch.float32

    def rand():
        return torch.rand(n_bodies, generator=generator, device=gdev, dtype=f32)

    def randn():
        return torch.randn(n_bodies, generator=generator, device=gdev, dtype=f32)

    is_star = torch.arange(n_bodies, device=gdev) != 0  # body 0 = black hole

    mass_bh = total_mass * black_hole_mass
    star_mass = (total_mass - mass_bh) / max(n_bodies - 1, 1)
    masses = torch.where(is_star, star_mass, mass_bh).to(f32)

    # Gamma(2) = Exp(1) + Exp(1); 1 - U lies in (0, 1], so the logs are finite
    r = (-torch.log(1.0 - rand()) - torch.log(1.0 - rand())) * radial_scale
    phi = rand() * (2 * math.pi)
    safe_r = torch.clamp(r, min=_F32_TINY)
    phi_spiral = torch.where(
        r > 0,
        phi + arm_strength * torch.sin(
            n_arms * (phi - torch.log(safe_r / radial_scale) / math.tan(pitch_angle))),
        phi,
    )

    z = randn() * height_scale
    positions = torch.stack(
        [r * torch.cos(phi_spiral), r * torch.sin(phi_spiral), z], dim=1)
    positions = torch.where(is_star[:, None], positions, 0.0)

    # Exponential-disk enclosed mass -> circular velocity
    m_enc = total_mass * (1.0 - torch.exp(-r / radial_scale) * (1.0 + r / radial_scale))
    v_circ = torch.where(r < 1e-8, 0.0, torch.sqrt(g_const * m_enc / safe_r))

    v_r = randn() * (0.1 * v_circ)
    v_phi = v_circ + randn() * (0.07 * v_circ)
    v_z = randn() * (0.05 * v_circ)
    velocities = torch.stack(
        [v_r * torch.cos(phi_spiral) - v_phi * torch.sin(phi_spiral),
         v_r * torch.sin(phi_spiral) + v_phi * torch.cos(phi_spiral),
         v_z], dim=1)
    velocities = torch.where(is_star[:, None], velocities, 0.0)
    dev = gdev if device is None else device
    return positions.to(dev), velocities.to(dev), masses.to(dev)
