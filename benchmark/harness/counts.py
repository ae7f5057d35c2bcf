"""Frozen peaks of the card and the operation and byte counts that the
per-layer metrics divide by.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores (the configurations state float32 with
TF32 off) and 3.35 TB/s of HBM bandwidth.

A roofline bound is the larger of operations over the FLOP peak and bytes
(each input read once, each output written once) over the bandwidth. Each
multiply-add counts 2 operations. The rules per kernel:

- B3, the ContConv collect of one layer: 2 ci co per (receiver, cell) pair
  plus 16 ci per live edge (8 corners, a multiply and an add each).
- B7, the Morton select: 9 per (query, candidate) (three differences, three
  products, two adds and the compare), 3 block candidates a query, over
  every curve copy.

The model counts (``*_forward_flops``) are the least work the architecture
needs, so that no correct implementation can read above the peak:

- EdgeConv in its node-sized form: the two split products of the first
  Linear per node (2 N d dim each), per (edge, channel) the add, the tanh
  and the mean's add (3), then the second Linear after the mean (2 N dim^2).
- ContConv: the encoder's Linear layers, the collect of each layer by the
  B3 rule above, the decoder's Linear layers.
- Normalisation, activations on nodes, the geometry of edges, the graph
  search and the integrator are not counted: they are small beside the
  products, and leaving them out can only make the share lower.
- A training step counts 3 forwards; recomputation under remat is not
  counted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time of the work at the
    card's peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b3_counts(n: int, k: int, pairs: float, edges: float, ci: int, co: int, d: int):
    """(flops, bytes) of one ContConv layer's collect over ``n`` receivers
    with k slots: node features, neighbour ids, the edges' grid coordinates
    and windows and the filter bank in, the output rows out."""
    flops = 2.0 * ci * co * pairs + 16.0 * ci * edges
    nbytes = F32 * (n * ci + n * k * (1 + 3 + 1) + d ** 3 * ci * co + n * co)
    return flops, nbytes


def b7_counts(n: int, k: int, block: int, copies: int):
    """(flops, bytes) of one Morton select over ``copies`` curve copies of
    ``n`` rows: the padded sorted candidates in (x, y, z, id), the k ids and
    distances of every padded query row out."""
    npad = -(-n // block) * block
    flops = 9.0 * copies * npad * 3 * block
    nbytes = copies * ((npad + 2 * block) * 4 * F32 + npad * k * 2 * F32)
    return flops, nbytes


def dense_flops(rows: int, dims: Sequence[int]) -> float:
    """Multiply-adds of a stack of Linear layers over ``rows`` rows, x 2."""
    return float(sum(2 * rows * a * b for a, b in zip(dims, dims[1:])))


def gnn_forward_flops(n: int, k: int, cfg: dict) -> float:
    """One forward of the EdgeConv model over ``n`` nodes with k neighbours."""
    width = cfg["input_dim"]
    dim = cfg["gnn_dim"]
    total = 0.0
    for _ in range(cfg["message_passing_steps"]):
        total += 2 * (2.0 * n * width * dim)  # u and v
        total += 3.0 * n * k * dim  # add, tanh, mean per edge and channel
        total += 2.0 * n * dim * dim  # dense1 after the mean
        width = dim
    head = [cfg["input_dim"] + dim, *(cfg.get("output_hiddens") or ()), 3]
    return total + dense_flops(n, head)


def contconv_forward_flops(n: int, k: int, cfg: dict, layers: Sequence[Tuple[float, float]]) -> float:
    """One forward of the ContConv model over ``n`` nodes; ``layers`` holds
    each conv layer's (receiver-cell pairs, live edges)."""
    dim = cfg["continuous_conv_dim"]
    total = dense_flops(n, [cfg["in_channels"], *cfg["encoder_hiddens"], dim])
    for (pairs, edges), d in zip(layers, cfg["filter_resolution"]):
        total += b3_counts(n, k, pairs, edges, dim, dim, d)[0]
    return total + dense_flops(n, [2 * dim, *cfg["decoder_hiddens"], 3])
