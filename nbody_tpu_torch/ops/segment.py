"""Masked neighbour-axis reductions — the port of ``nbody_tpu/ops/segment.py``.

Neighbours live in dense ``(N, k)`` arrays (``ops.knn``), so the reference's
scatter is a masked reduction over the neighbour axis.
"""

from __future__ import annotations

import torch


def masked_sum(values: torch.Tensor, valid: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Sum ``values`` (..., k, d) over ``axis`` counting only ``valid`` slots
    (a mask shaped like ``values`` without the trailing feature dim)."""
    return torch.where(valid[..., None], values, 0.0).sum(dim=axis)


def masked_mean(values: torch.Tensor, valid: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Mean over valid slots; nodes with no valid neighbour get 0."""
    s = masked_sum(values, valid, axis=axis)
    cnt = valid.to(values.dtype).sum(dim=axis)[..., None]
    return s / torch.clamp(cnt, min=1.0)


def masked_aggregate(values, valid, how: str, axis: int = 1):
    """Dispatch on the reference's ``aggr`` string ('sum' | 'mean')."""
    if how == "sum":
        return masked_sum(values, valid, axis=axis)
    if how == "mean":
        return masked_mean(values, valid, axis=axis)
    raise ValueError(f"unknown aggregation {how!r}")
