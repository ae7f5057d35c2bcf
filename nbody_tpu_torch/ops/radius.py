"""Fixed-radius neighbour search with padded output — the port of
``nbody_tpu/ops/radius.py``.

The nearest ``k_max`` candidates, then the exact cut ``d^2 < r^2`` on
distances recomputed from the gathered positions. A node with more than
``k_max`` neighbours in the radius keeps the nearest ``k_max`` (PyG's
``radius_graph`` truncates at ``max_num_neighbors=32`` in no defined order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops.knn import knn_neighbors
from nbody_tpu_torch.ops.spatial import batched_knn_morton, knn_morton


def radius_neighbors(
    pos: torch.Tensor,
    radius: float,
    k_max: int = 32,
    mask: Optional[torch.Tensor] = None,
    include_self: bool = True,
    chunk_size: Optional[int] = None,
    method: str = "exact",
    impl: str = "dense",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbours within ``radius``, padded to ``(N, k_max)``.

    :param pos: (N, 3) positions.
    :param mask: optional (N,) validity for padded slots.
    :param include_self: include the self edge (PyG ``loop=True``).
    :param chunk_size: row chunk of the exact streamed kNN.
    :param method: "exact" (streamed kNN) or "morton" (the curve search).
    :param impl: Morton implementation, "dense" or "kernel".
    :return: (idx, valid), (N, k_max) int32 and bool.
    """
    n = pos.shape[0]
    k_max = min(k_max, n)
    if method == "morton":
        idx, valid = knn_morton(pos, k_max, mask=mask, include_self=include_self,
                                impl=impl)
    elif method == "exact":
        idx, valid = knn_neighbors(pos, k_max, mask=mask, include_self=include_self,
                                   chunk_size=chunk_size)
    else:
        raise ValueError(f"unknown radius search method {method!r}")
    return _within(pos, idx, valid, radius)


def _within(pos, idx, valid, radius):
    """The cut ``d^2 < r^2`` on the listed neighbours ``idx`` (N, k) of one
    scene's (N, 3) positions, or of each scene of a batch (a leading axis
    on all three)."""
    rows = idx.long()
    if pos.dim() == 3:
        rows = rows + pos.shape[1] * torch.arange(pos.shape[0], device=pos.device)[:, None, None]
    d = pos.reshape(-1, 3)[rows] - pos[..., None, :]
    d2_sel = (d * d).sum(-1)
    r2 = float(torch.tensor(float(radius), dtype=torch.float32) ** 2)  # as float32 squares it
    valid = valid & (d2_sel < r2)
    return torch.where(valid, idx, 0).to(torch.int32), valid


def batched_radius_neighbors(pos, radius, k_max=32, mask=None, include_self=True,
                             method="exact", impl="dense"):
    """:func:`radius_neighbors` over a leading batch axis, each scene what a
    call on it alone gives. The Morton search with ``impl="kernel"`` is one
    batched search (:func:`batched_knn_morton`: one B7 and one B8 launch);
    the other methods run scene by scene."""
    if method == "morton" and impl == "kernel":
        idx, valid = batched_knn_morton(pos, min(k_max, pos.shape[1]), mask=mask,
                                        include_self=include_self, impl=impl)
        return _within(pos, idx, valid, radius)
    outs = [radius_neighbors(pos[b], radius, k_max=k_max,
                             mask=None if mask is None else mask[b],
                             include_self=include_self, method=method, impl=impl)
            for b in range(pos.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
