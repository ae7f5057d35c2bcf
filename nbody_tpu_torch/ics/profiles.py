"""Radial mass-density profiles — the port of ``nbody_tpu/ics/profiles.py``."""

from __future__ import annotations

import math

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def spherical_hernquist_distribution(
    r, r0: float = 1.0, total_mass: float = 1.0, avoid_distance_zero: bool = True
):
    """Hernquist density profile

        rho(r) = (total_mass / 2 pi) * r0 / (r * (r0 + r)^3)

    :param r: radial distance(s).
    :param avoid_distance_zero: replace r == 0 with float32 eps (the
        reference's guard).
    """
    r = torch.as_tensor(r)
    if avoid_distance_zero:
        r = torch.where(r == 0, torch.full_like(r, _F32_EPS), r)
    return (total_mass / (2 * math.pi)) * (r0 / (r * (r0 + r) ** 3))
