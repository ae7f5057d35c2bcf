"""Graph construction dispatch — the port of ``nbody_tpu/train/graphs.py``:
every model declares a ``graph_spec`` and the engine builds the matching
padded neighbour lists from positions on the positions' device."""

from __future__ import annotations

from nbody_tpu_torch.ops.knn import batched_knn_neighbors


def build_graph(graph_spec, pos, mask=None):
    """:param graph_spec: ("knn", {k, include_self[, method]}) from
        ``model.graph_spec``; the port has the exact method only.
    :param pos: (B, N, 3) positions.
    :param mask: optional (B, N) node validity.
    :return: (idx, valid) padded neighbour lists, both (B, N, k).
    """
    kind, kw = graph_spec
    if kind != "knn":
        raise NotImplementedError(
            f"graph kind {kind!r}: radius graphs come with the ContConv slice "
            "(ROADMAP.md, queue A item 8)")
    method = kw.get("method", "exact")
    if method != "exact":
        raise NotImplementedError(
            f"kNN method {method!r}: the port has exact kNN only "
            "(Morton search: ROADMAP.md, queue A item 9)")
    return batched_knn_neighbors(pos, kw["k"], mask=mask,
                                 include_self=kw.get("include_self", False))
