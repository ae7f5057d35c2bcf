"""Graph construction dispatch — the port of ``nbody_tpu/train/graphs.py``:
every model declares a ``graph_spec`` and the engine builds the matching
padded neighbour lists from positions on the positions' device."""

from __future__ import annotations

from nbody_tpu_torch.ops.knn import batched_knn_neighbors
from nbody_tpu_torch.ops.radius import batched_radius_neighbors
from nbody_tpu_torch.ops.spatial import batched_knn_morton


def build_graph(graph_spec, pos, mask=None):
    """:param graph_spec: ("knn", {k, include_self[, method, window, block,
        n_copies, impl]}) or ("radius", {radius, k_max, include_self[,
        method, impl]}) from ``model.graph_spec``. kNN methods: "exact"
        (default) and "morton" (``ops/spatial.py``; impl "dense" or
        "kernel"); "approx" is TPU-only and raises.
    :param pos: (B, N, 3) positions.
    :param mask: optional (B, N) node validity.
    :return: (idx, valid) padded neighbour lists, both (B, N, k).
    """
    kind, kw = graph_spec
    if kind == "knn":
        method = kw.get("method", "approx" if kw.get("approx") else "exact")
        if method == "morton":
            return batched_knn_morton(
                pos, kw["k"], mask=mask, include_self=kw.get("include_self", False),
                window=kw.get("window", 64), block=kw.get("block", 256),
                n_copies=kw.get("n_copies", 4), impl=kw.get("impl", "dense"))
        if method not in ("exact", "approx"):
            raise ValueError(f"unknown kNN method {method!r}")
        return batched_knn_neighbors(pos, kw["k"], mask=mask,
                                     include_self=kw.get("include_self", False),
                                     approx=method == "approx")
    if kind == "radius":
        return batched_radius_neighbors(
            pos, kw["radius"], k_max=kw.get("k_max", 32), mask=mask,
            include_self=kw.get("include_self", True),
            method=kw.get("method", "exact"), impl=kw.get("impl", "dense"))
    raise ValueError(f"unknown graph spec kind {kind!r}")
