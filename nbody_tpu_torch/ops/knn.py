"""Fixed-degree exact k-nearest-neighbour search — the port of
``nbody_tpu/ops/knn.py``.

``approx=True`` is the JAX package's ``lax.approx_max_k`` selection as XLA
computes it on every backend but the TPU: the exact top-k, so it returns
what ``approx=False`` returns. (On the TPU, XLA's approximate top-k reads
recall 0.980-0.988 in ``results/large_scale/knn_recall.json``.)

Neighbours come back as a dense ``(N, k)`` index array plus an ``(N, k)``
validity mask, not as a COO edge list, so message passing is a gather and a
masked reduction. Self edges are excluded unless ``include_self``; when a
snapshot has fewer than ``k`` other valid particles, the surplus slots are
invalid and point at index 0.

Ties: ``torch.topk`` may order equal distances differently from
``lax.top_k``, so the two packages agree on index sets for tie-free inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nbody_tpu_torch.core.forces import _pairwise_d2

# float32 max, not inf: "not a candidate" stays a finite sentinel, and a
# slot is valid iff its distance is below it.
_INF = float(torch.finfo(torch.float32).max)

# Above this size the (N, N) distance matrix stops fitting comfortably and
# row chunks are streamed instead (exact result, O(chunk * N) memory).
_CHUNKED_THRESHOLD = 4096
_DEFAULT_CHUNK = 1024


def knn_neighbors(
    pos: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    include_self: bool = False,
    chunk_size: Optional[int] = None,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of every particle: dense distances and top-k for
    small N, a streamed row-chunk scan above ``_CHUNKED_THRESHOLD``.

    :param pos: (N, 3) positions.
    :param mask: optional (N,) validity for padded slots.
    :param chunk_size: row-chunk size of the streamed path; None picks it.
    :param approx: the JAX package's ``approx_max_k`` selection of the
        chunked path, which off the TPU is the exact top-k (see the module
        docstring): the same chunk scan and the same ids.
    :return: (idx, valid) — (N, k) int32 indices and (N, k) bool validity.
    """
    del approx  # the exact selection is approx_max_k's off the TPU
    n = pos.shape[0]
    k = min(k, n)
    if chunk_size is None:
        chunk_size = n if n <= _CHUNKED_THRESHOLD else _DEFAULT_CHUNK
    if chunk_size < n:
        return _knn_chunked(pos, k, mask, include_self, chunk_size)
    d2 = _pairwise_d2(pos)
    if not include_self:
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        d2 = d2.masked_fill(eye, _INF)
    if mask is not None:
        d2 = d2.masked_fill(~mask.bool()[None, :], _INF)  # never pick padding
    neg_d2, idx = torch.topk(-d2, k, dim=-1)
    valid = neg_d2 > -_INF
    if mask is not None:
        valid = valid & mask.bool()[:, None]  # padded rows have no neighbours
    idx = torch.where(valid, idx, 0)
    return idx.to(torch.int32), valid


def _knn_chunked(pos, k, mask, include_self, chunk_size):
    """Exact kNN over row chunks: each chunk's (chunk, N) squared distances
    come from the norm expansion |a|^2 + |b|^2 - 2 a.b (no (chunk, N, 3)
    temporary). The matrix product must run in full float32: TF32 keeps ~3
    decimal digits and would reorder neighbours."""
    if pos.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "chunked kNN needs full-float32 matmuls; "
            "torch.backends.cuda.matmul.allow_tf32 is True")
    n = pos.shape[0]
    sq = (pos * pos).sum(-1)
    cols = torch.arange(n, device=pos.device)
    col_ok = None if mask is None else mask.bool()
    idx = torch.empty((n, k), dtype=torch.int64, device=pos.device)
    valid = torch.empty((n, k), dtype=torch.bool, device=pos.device)
    for start in range(0, n, chunk_size):
        rows = cols[start:start + chunk_size]
        pr = pos[rows]
        d2 = sq[rows][:, None] + sq[None, :] - 2.0 * (pr @ pos.T)
        d2 = torch.clamp(d2, min=0.0)
        if not include_self:
            d2 = d2.masked_fill(cols[None, :] == rows[:, None], _INF)
        if col_ok is not None:
            d2 = d2.masked_fill(~col_ok[None, :], _INF)
        neg, sel = torch.topk(-d2, k, dim=-1)
        idx[rows] = sel
        valid[rows] = neg > -_INF
    if mask is not None:
        valid = valid & mask.bool()[:, None]
    idx = torch.where(valid, idx, 0)
    return idx.to(torch.int32), valid


def knn_query(
    pos_q: torch.Tensor,
    pos_c: torch.Tensor,
    k: int,
    q_offset: int = 0,
    include_self: bool = False,
    mask_c: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest *candidates* of a separate query set — the asymmetric kNN
    of the particle-sharded surrogate (``parallel/surrogate.py``): a rank's
    query shard searches the all-gathered candidates. Distances come from
    the norm expansion |q|^2 + |c|^2 - 2 q.c, as in the JAX function.

    :param pos_q: (Nq, 3) query positions (a shard of the candidates).
    :param pos_c: (Nc, 3) candidate positions (the full array).
    :param q_offset: index of query row 0 among the candidates: query i's
        own slot ``q_offset + i`` is excluded unless ``include_self``.
    :param mask_c: optional (Nc,) candidate validity.
    :return: (idx, valid) — (Nq, k) int32 indices into the candidates.
    """
    if pos_q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("knn_query needs full-float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    nq, nc = pos_q.shape[0], pos_c.shape[0]
    k = min(k, nc)
    d2 = ((pos_q * pos_q).sum(1)[:, None] + (pos_c * pos_c).sum(1)[None, :]
          - 2.0 * (pos_q @ pos_c.T))
    d2 = torch.clamp(d2, min=0.0)
    cols = torch.arange(nc, device=pos_q.device)[None, :]
    if not include_self:
        rows = q_offset + torch.arange(nq, device=pos_q.device)
        d2 = d2.masked_fill(cols == rows[:, None], _INF)
    if mask_c is not None:
        d2 = d2.masked_fill(~mask_c.bool()[None, :], _INF)
    neg, idx = torch.topk(-d2, k, dim=-1)
    valid = neg > -_INF
    return torch.where(valid, idx, 0).to(torch.int32), valid


def batched_knn_neighbors(pos, k, mask=None, include_self=False, approx=False):
    """:func:`knn_neighbors` over a leading batch axis: (B, N, 3) ->
    (B, N, k) indices and validity, each snapshot with its own graph."""
    outs = [
        knn_neighbors(pos[b], k, mask=None if mask is None else mask[b],
                      include_self=include_self, approx=approx)
        for b in range(pos.shape[0])
    ]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
