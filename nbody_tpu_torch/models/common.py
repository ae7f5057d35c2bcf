"""Shared model plumbing for dense (B, N, k) neighbour representations — the
port of ``nbody_tpu/models/common.py``."""

from __future__ import annotations

import torch


def gather_neighbors(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour features: (B, N, d), (B, N, k) -> (B, N, k, d)."""
    b = torch.arange(h.shape[0], device=h.device)[:, None, None]
    return h[b, idx.long()]


def select_input_features(x: torch.Tensor, input_dim: int) -> torch.Tensor:
    """Node features are x = [pos(3) | vel(3) | mass(1)]; a model with
    input_dim == 4 uses only [pos | mass]."""
    if input_dim == 4:
        return torch.cat([x[..., :3], x[..., 6:]], dim=-1)
    return x


def masked_mse(pred, target, node_mask=None):
    """Mean squared error over valid nodes x output dims."""
    se = (pred - target) ** 2
    if node_mask is None:
        return se.mean()
    m = node_mask.to(pred.dtype)[..., None]
    return (se * m).sum() / (m.sum() * se.shape[-1])


def scaled_rmse_and_mse(pred, target, scale_factor, node_mask=None):
    """The reference's training objective: loss = s * sqrt(mse), and mse."""
    mse = masked_mse(pred, target, node_mask)
    return scale_factor * torch.sqrt(mse), mse
