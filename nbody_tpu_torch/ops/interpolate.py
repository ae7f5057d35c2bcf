"""Trilinear interpolation over a (D, D, D, ...) filter grid — the port of
``nbody_tpu/ops/interpolate.py`` (``F.grid_sample`` with
``align_corners=True`` on coordinates normalised by D - 1 is exactly this
direct trilinear interpolation at grid coordinates in [0, D - 1])."""

from __future__ import annotations

from typing import Tuple

import torch


def trilinear_corners(coords: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner flat indices and lerp weights for grid coordinates.

    :param coords: (E, 3) grid-space coordinates, clamped to [0, D - 1].
    :param d: grid resolution D.
    :return: (idx, w): (E, 8) int32 indices into a (D*D*D,) layout with
        index = (x*D + y)*D + z, and (E, 8) weights summing to 1, corners in
        (ox, oy, oz) order.
    """
    c = torch.clamp(coords, 0.0, d - 1)
    c0 = torch.clamp(torch.floor(c), 0, d - 2) if d > 1 else torch.zeros_like(c)
    f = c - c0
    c0 = c0.to(torch.int32)
    idxs, ws = [], []
    for ox in (0, 1):
        wx = f[:, 0] if ox else 1.0 - f[:, 0]
        for oy in (0, 1):
            wy = f[:, 1] if oy else 1.0 - f[:, 1]
            for oz in (0, 1):
                wz = f[:, 2] if oz else 1.0 - f[:, 2]
                if d > 1:
                    flat = ((c0[:, 0] + ox) * d + (c0[:, 1] + oy)) * d + (c0[:, 2] + oz)
                else:
                    flat = torch.zeros_like(c0[:, 0])
                idxs.append(flat)
                ws.append(wx * wy * wz)
    return torch.stack(idxs, 1), torch.stack(ws, 1)


def trilinear_interpolate(filters: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``filters[x, y, z]`` interpolated at fractional coordinates (the
    per-edge gather form, for tests and small channel counts).

    :param filters: (D, D, D, ci, co) filter bank.
    :param coords: (E, 3) coordinates in [0, D - 1].
    :return: (E, ci, co).
    """
    d, _, _, ci, co = filters.shape
    flat = filters.reshape(d * d * d, ci * co)
    idx, w = trilinear_corners(coords, d)
    out = (flat[idx.long()] * w[:, :, None]).sum(1)
    return out.reshape(-1, ci, co)
