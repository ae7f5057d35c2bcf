"""Spiral-galaxy initial conditions — the port of ``nbody_tpu/ics/spiral.py``
(reference ``src/galaxify/galaxies.py:195-296``), vectorised over bodies and
drawn from ``jax.random``'s keyed streams (``utils.prng``), so a key gives
the JAX package's galaxy.

The draws give the same bits on every device. So does the galaxy: its
``sin``, ``cos``, ``log``, ``exp`` and ``sqrt`` are taken in float64 and
rounded to float32 (:func:`_f32_of`), its divisions by constants divide by
a tensor (:func:`_over`), and the rest is float32 arithmetic, which every
device rounds alike. torch's CUDA float32 functions differ from its CPU
ones by an ulp here and there, and its CUDA division by a Python number
multiplies by the reciprocal; the enclosed mass ``1 - e^{-x}(1 + x)``
cancels for small ``x``, so such an ulp moved a velocity by up to 1e-4 of
the largest.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.utils import prng

_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _f32_of(fn, x: torch.Tensor) -> torch.Tensor:
    """float32 ``fn(x)`` through float64: the correctly rounded value but
    for a double rounding (about once in 2**28 draws), on every device."""
    return fn(x.double()).float()


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """float32 ``x / c`` correctly rounded on every device."""
    return x / torch.full_like(x, c)


def generate_spiral(
    key: torch.Tensor,
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

    - radii ~ Gamma(shape=2, scale=radial_scale)
    - arm perturbation phi + A sin(n (phi - ln(r/Rd)/tan p))
    - gaussian z
    - v_circ from the exponential-disk enclosed mass M (1 - e^{-r/Rd}(1 + r/Rd))
    - dispersions (0.1, 0.07, 0.05) * v_circ
    - uniform star masses

    :param key: a ``utils.prng`` key (``prng.PRNGKey(seed)``), split six
        ways as JAX splits it.
    :param device: where the draws run and the result goes (default: the
        key's device).
    :return: (positions (N,3), velocities (N,3), masses (N,)) float32.
    """
    gdev = key.device if device is None else torch.device(device)
    f32 = torch.float32
    k_r, k_phi, k_z, k_vr, k_vphi, k_vz = prng.split(key, 6, gdev)
    is_star = torch.arange(n_bodies, device=gdev) != 0  # body 0 = black hole

    mass_bh = total_mass * black_hole_mass
    star_mass = (total_mass - mass_bh) / max(n_bodies - 1, 1)
    masses = torch.where(is_star, star_mass, mass_bh).to(f32)

    r = prng.gamma(k_r, 2.0, n_bodies) * radial_scale
    phi = prng.uniform(k_phi, n_bodies, 0.0, 2 * math.pi)
    safe_r = torch.clamp(r, min=_F32_TINY)
    phi_spiral = torch.where(
        r > 0,
        phi + arm_strength * _f32_of(torch.sin, n_arms * (
            phi - _over(_f32_of(torch.log, _over(safe_r, radial_scale)),
                        math.tan(pitch_angle)))),
        phi,
    )

    z = prng.normal(k_z, n_bodies) * height_scale
    cos_s, sin_s = _f32_of(torch.cos, phi_spiral), _f32_of(torch.sin, phi_spiral)
    positions = torch.stack([r * cos_s, r * sin_s, z], dim=1)
    positions = torch.where(is_star[:, None], positions, 0.0)

    # Exponential-disk enclosed mass -> circular velocity
    x = _over(r, radial_scale)
    m_enc = total_mass * (1.0 - _f32_of(torch.exp, -x) * (1.0 + x))
    v_circ = torch.where(r < 1e-8, 0.0, _f32_of(torch.sqrt, g_const * m_enc / safe_r))

    v_r = prng.normal(k_vr, n_bodies) * (0.1 * v_circ)
    v_phi = v_circ + prng.normal(k_vphi, n_bodies) * (0.07 * v_circ)
    v_z = prng.normal(k_vz, n_bodies) * (0.05 * v_circ)
    velocities = torch.stack(
        [v_r * cos_s - v_phi * sin_s,
         v_r * sin_s + v_phi * cos_s,
         v_z], dim=1)
    velocities = torch.where(is_star[:, None], velocities, 0.0)
    return positions, velocities, masses
