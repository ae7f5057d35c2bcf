"""EdgeConv message-passing surrogate — the port of ``nbody_tpu/models/gnn.py``
(reference ``gnn.py:25-161``).

Architecture: optional tanh-MLP node encoder, a stack of EdgeConv layers
(edge MLP ``Linear(2d->d) -> tanh -> Linear(d->d)``, sum or mean
aggregation), skip-concat of the encoder output with the GNN output,
LayerNorm, linear-or-MLP decoder, output divided by ``output_scale``.
``input_dim == 4`` selects [pos | mass] from the 7 node features.

Messages live in dense (B, N, k, .) tensors: gather the neighbours, run the
edge MLP, masked-reduce over k. ``fused_edgeconv=True`` computes the same
function with one k-sized tensor per layer (see :class:`EdgeConv`), and
``remat=True`` recomputes each EdgeConv in the backward pass instead of
keeping its k-sized tensors; both leave the parameter names as they are.
The approximate (TPU-only) neighbour search raises
``NotImplementedError``. ``knn_method="morton"`` builds graphs with
``ops/spatial.py``; ``knn_impl`` takes the port's names, "dense" and
"kernel".
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nbody_tpu_torch.models.common import gather_neighbors, select_input_features
from nbody_tpu_torch.models.mlp import MLP, Dense, OutputHead, reset_dense
from nbody_tpu_torch.ops.segment import masked_aggregate

# Node features of the datasets: [pos(3) | vel(3) | mass(1)].
NODE_FEATURES = 7


class EdgeConv(nn.Module):
    """PyG ``EdgeConv`` on dense neighbour lists: for every node i,
    aggr_j MLP([h_i || h_j - h_i]) over its k (masked) neighbours.

    ``fused=True`` computes the same function from the same two ``Dense``
    layers with one (B, N, k, dim) tensor instead of the (B, N, k, 2d)
    message input and its two products (reference ``gnn.py:36-97``):

        W1^T [h_i || h_j - h_i] + b1  =  u_i + v_j - b1
            with u = dense0([h || -h]),  v = dense0([0 || h])

    are node-sized products, and ``dense1`` commutes past the neighbour
    reduction: mean_j(t_j W2 + b2) = (mean_j t_j) W2 + b2, the sum adds
    (count - 1) b2, and a node without valid neighbours stays 0 as in the
    unfused layer. Only the gather of ``v`` is k-sized."""

    def __init__(self, in_dim: int, dim: int, aggr: str = "sum", fused: bool = False):
        super().__init__()
        self.dense0 = Dense(2 * in_dim, dim)
        self.dense1 = Dense(dim, dim)
        self.aggr = aggr
        self.fused = fused

    def split_terms(self, h):
        """The fused layer's node-sized terms (u', v): the edge's
        pre-activation is ``u'_i + v_j`` with the bias folded into
        ``u' = u - b1``; both (B, N, dim)."""
        d = h.shape[-1]
        w = self.dense0.weight  # (dim, 2d): [W1a | W1b] on [h_i | h_j - h_i]
        u = torch.nn.functional.linear(h, w[:, :d] - w[:, d:])  # u - b1
        v = torch.nn.functional.linear(h, w[:, d:], self.dense0.bias)
        return u, v

    def forward(self, h, nbr_idx, nbr_valid):
        if not self.fused:
            h_j = gather_neighbors(h, nbr_idx)  # (B, N, k, d)
            h_i = h[:, :, None, :].expand_as(h_j)
            e = self.dense1(torch.tanh(self.dense0(torch.cat([h_i, h_j - h_i], dim=-1))))
            return masked_aggregate(e, nbr_valid, self.aggr, axis=2)
        u, v = self.split_terms(h)
        t = torch.tanh(u[:, :, None, :] + gather_neighbors(v, nbr_idx))  # (B, N, k, dim)
        out = self.dense1(masked_aggregate(t, nbr_valid, self.aggr, axis=2))
        cnt = nbr_valid.to(h.dtype).sum(dim=2, keepdim=True)
        if self.aggr == "sum":
            return out + (cnt - 1.0) * self.dense1.bias
        # a node without valid neighbours aggregates to 0 in the unfused
        # layer (the masked mean's 0 / 1), not to b2
        return torch.where(cnt > 0, out, 0.0)


class GraphModel(nn.Module):
    """Constructor arguments of the JAX ``GraphModel`` (reference
    ``gnn.py:26-53``); ``neighbors`` is the kNN degree of the graphs built
    for this model. ``generator`` draws the initial weights."""

    def __init__(
        self,
        input_dim: int = 1,
        output_hiddens: Optional[Tuple[int, ...]] = None,
        output_dim: int = 3,
        node_encoder_dims: Optional[Tuple[int, ...]] = None,
        gnn_dim: int = 128,
        encoder_dropout: float = 0.0,
        message_passing_steps: int = 4,
        aggr: str = "sum",
        neighbors: int = 50,
        scale_factor: float = 1.0,
        zero_init_output: bool = False,
        output_scale: float = 1.0,
        knn_method: Optional[str] = None,
        knn_window: int = 64,
        knn_impl: Optional[str] = None,
        knn_copies: int = 4,
        knn_block: int = 256,
        fused_edgeconv: bool = False,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if knn_method == "approx":
            raise NotImplementedError(
                "knn_method='approx' selects with lax.approx_max_k, a TPU-only "
                "top-k; use 'exact' or 'morton'")
        if knn_method not in (None, "exact", "morton"):
            raise ValueError(f"unknown knn_method {knn_method!r}")
        self.input_dim = input_dim
        self.output_hiddens = output_hiddens
        self.output_dim = output_dim
        self.node_encoder_dims = node_encoder_dims
        self.gnn_dim = gnn_dim
        self.encoder_dropout = encoder_dropout
        self.message_passing_steps = message_passing_steps
        self.aggr = aggr
        self.neighbors = neighbors
        self.scale_factor = scale_factor
        self.zero_init_output = zero_init_output
        self.output_scale = output_scale
        self.knn_method = knn_method
        self.knn_window = knn_window
        self.knn_impl = knn_impl
        self.knn_copies = knn_copies
        self.knn_block = knn_block
        self.fused_edgeconv = fused_edgeconv
        self.remat = remat

        width = 4 if input_dim == 4 else NODE_FEATURES
        self.encoder = None
        if node_encoder_dims:
            self.encoder = MLP(width, tuple(node_encoder_dims) + (gnn_dim,),
                               dropout=encoder_dropout)
            width = gnn_dim
        enc_width = width
        self.convs = nn.ModuleList()
        for _ in range(message_passing_steps):
            self.convs.append(EdgeConv(width, gnn_dim, aggr, fused=fused_edgeconv))
            width = gnn_dim
        self.norm = nn.LayerNorm(enc_width + width, eps=1e-5)
        self.head = OutputHead(enc_width + width, output_hiddens, output_dim,
                               zero_init=zero_init_output)
        if generator is not None:
            reset_dense(self, generator)

    @property
    def graph_spec(self):
        """How the data pipeline must build neighbour lists for this model."""
        method = self.knn_method or "exact"
        spec = {"k": self.neighbors, "include_self": False, "method": method}
        if method == "morton":
            spec["window"] = self.knn_window
            spec["block"] = self.knn_block
            spec["n_copies"] = self.knn_copies
            if self.knn_impl:
                spec["impl"] = self.knn_impl
        return ("knn", spec)

    def forward(self, x, nbr_idx, nbr_valid, node_mask=None):
        """:param x: (B, N, 7) node features [pos | vel | mass].
        :param nbr_idx: (B, N, k) neighbour indices.
        :param nbr_valid: (B, N, k) bool neighbour validity.
        :param node_mask: accepted for API parity; every layer is per node,
            so padding cannot leak into valid nodes.
        :return: (B, N, output_dim) predicted accelerations.
        """
        x = select_input_features(x, self.input_dim)
        if self.encoder is not None:
            x = self.encoder(x)
        encoder_output = x
        for conv in self.convs:
            if self.remat:
                # keep the layer's (B, N, .) input only and run the layer
                # again in the backward pass: no k-sized tensor is saved
                x = checkpoint(conv, x, nbr_idx, nbr_valid, use_reentrant=False)
            else:
                x = conv(x, nbr_idx, nbr_valid)
        out = self.head(self.norm(torch.cat([encoder_output, x], dim=-1)))
        if self.output_scale != 1.0:
            out = out / self.output_scale
        return out

    def get_config(self):
        """Parity with ``GraphModel.get_config`` (reference gnn.py:116-128)."""
        return {
            "input_dim": self.input_dim,
            "output_hiddens": self.output_hiddens,
            "output_dim": self.output_dim,
            "node_encoder_dims": self.node_encoder_dims,
            "gnn_dim": self.gnn_dim,
            "encoder_dropout": self.encoder_dropout,
            "message_passing_steps": self.message_passing_steps,
            "aggr": self.aggr,
            "neighbors": self.neighbors,
            "scale_factor": self.scale_factor,
            "zero_init_output": self.zero_init_output,
            "output_scale": self.output_scale,
        }
