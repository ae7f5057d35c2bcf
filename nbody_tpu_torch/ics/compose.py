"""System composition: merge several generated galaxies into one simulation
(e.g. collisions) — the port of ``nbody_tpu/ics/compose.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def compose(
    *systems: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate (positions, velocities, masses) triples into one system.

    Example — two-disk collision:

        a = generate_disk(g1, 5000, offset=(-10, 0, 0), initial_vel=(0.001, 0, 0))
        b = generate_disk(g2, 5000, offset=(10, 0, 0), initial_vel=(-0.001, 0, 0))
        pos, vel, mass = compose(a, b)
    """
    if not systems:
        raise ValueError("compose() needs at least one system")
    return tuple(torch.cat([s[i] for s in systems], dim=0) for i in range(3))
