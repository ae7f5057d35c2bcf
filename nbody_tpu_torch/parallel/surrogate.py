"""Particle-sharded surrogate forward, rollout and training gradients — the
port of ``nbody_tpu/parallel/surrogate.py``.

The N particles are split over a mesh axis. Node state is small (positions
12 bytes a node, features ~30, hidden 256), so each layer all-gathers the
inputs it must read and computes only its own rows:

    x_full  = all_gather(x_shard)                          # (N, 7)
    idx     = neighbours of the shard's rows among x_full  # (N/n, k)
    per layer:
        h_full  = all_gather(h_shard)
        h_shard = layer(h_shard, idx, h_src=h_full)        # own rows only
    head(LayerNorm([enc_shard || h_shard]))

The layers are the models' own modules (``EdgeConv``, ``ContinuousConv``,
the encoder ``MLP``, ``LayerNorm``, ``OutputHead``) applied with their
gather-source arguments (``h_src``, ``feat_src``, ``pos_src``): the layer
math lives in ``models/`` only, and the kernels are the single-rank ones
(B3-B5 in a ContConv layer on the card, B7 and B8 in the Morton search).

Graphs: a Morton spec is built replicated on the gathered positions (the
single-rank graph, bit for bit) and sliced to the shard; the exact graph is
:func:`ops.knn.knn_query` of the shard against the gathered positions.

The model's weights live in the module, so the JAX functions' ``variables``
argument has no counterpart. Every function takes the global arrays (the
same on every rank) and returns the global result on every rank; the
gradient functions return the full gradients on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from nbody_tpu_torch.models.common import select_input_features
from nbody_tpu_torch.models.contconv import conv_geometry
from nbody_tpu_torch.models.mlp import MaskedBatchNorm
from nbody_tpu_torch.ops.knn import knn_query
from nbody_tpu_torch.parallel.mesh import (PARTICLE_AXIS, Mesh, all_gather,
                                           particle_sharding, psum, psum_all)
from nbody_tpu_torch.train.graphs import build_graph


@contextlib.contextmanager
def _mode(model, train: bool):
    """The model in train or eval mode for the block, its own mode after."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def _rows(mesh: Mesh, axis: str, shard: int) -> slice:
    me = mesh.index(axis)
    return slice(me * shard, (me + 1) * shard)


def _shard_graph(model, pos_l, pos_full, mesh, axis):
    """The shard's neighbour lists into the gathered positions. A Morton
    spec builds the single-rank graph replicated (O(N W) a rank, the same
    bits) and slices it; otherwise the shard queries every candidate with
    :func:`knn_query`, O(N^2 / n) a rank: the GNN's k nearest, or the
    ContConv's ``radius_kmax`` nearest cut at ``d^2 < r^2`` as
    ``ops.radius.radius_neighbors`` cuts them."""
    kind, kw = model.graph_spec
    rows = _rows(mesh, axis, pos_l.shape[0])
    if kw.get("method") == "morton":
        idx, valid = build_graph(model.graph_spec, pos_full[None])
        return idx[0, rows], valid[0, rows]
    if kind == "knn":
        return knn_query(pos_l, pos_full, model.neighbors, q_offset=rows.start,
                         include_self=False)
    idx, valid = knn_query(pos_l, pos_full, min(model.radius_kmax, pos_full.shape[0]),
                           q_offset=rows.start, include_self=model.self_loops)
    d = pos_full[idx.long()] - pos_l[:, None, :]
    r2 = float(torch.tensor(float(model.radius), dtype=torch.float32) ** 2)
    valid = valid & ((d * d).sum(-1) < r2)
    return torch.where(valid, idx, 0).to(torch.int32), valid


def _head(model, enc_l, h_l):
    """Skip-concat, LayerNorm, decoder head and the ``output_scale``
    division: the tail both model families share."""
    out = model.head(model.norm(torch.cat([enc_l, h_l], dim=-1)))
    if model.output_scale != 1.0:
        out = out / model.output_scale
    return out


def _gather_x(pos_l, vel_l, mass_l, mesh, axis):
    x_l = torch.cat([pos_l, vel_l, mass_l[:, None]], dim=-1)
    return x_l, all_gather(x_l, mesh, axis)


def _gnn_forward_local(model, pos_l, vel_l, mass_l, mesh, axis):
    """One shard's rows of the ``GraphModel`` forward."""
    rows = _rows(mesh, axis, pos_l.shape[0])
    x_l, x_full = _gather_x(pos_l, vel_l, mass_l, mesh, axis)
    idx, valid = _shard_graph(model, pos_l, x_full[:, :3], mesh, axis)
    h_full = select_input_features(x_full, model.input_dim)
    h_l = select_input_features(x_l, model.input_dim)
    if model.encoder is not None:
        h_full = model.encoder(h_full)
        h_l = h_full[rows]
    enc_l = h_l
    for li, conv in enumerate(model.convs):
        args = (h_l[None], idx[None], valid[None], h_full[None])
        h_l = (checkpoint(conv, *args, use_reentrant=False) if model.remat
               else conv(*args))[0]
        if li < len(model.convs) - 1:
            h_full = all_gather(h_l, mesh, axis)
    return _head(model, enc_l, h_l)


def _check_chunks(model) -> None:
    chunks = max(conv.node_chunks for conv in model.convs)
    if chunks > 1:
        raise ValueError(
            f"node_chunks={chunks}: the particle-sharded ContConv forward does not "
            "chunk its receivers; split the particles over more ranks instead")


def _contconv_forward_local(model, pos_l, vel_l, mass_l, mesh, axis):
    """One shard's rows of the ``ContinuousConvModel`` forward, in the
    model's mode. The encoder runs on the replicated full node array, so in
    train mode its batch norm takes the single-rank statistics over the same
    (1, N) batch and every rank updates its running statistics alike."""
    _check_chunks(model)
    rows = _rows(mesh, axis, pos_l.shape[0])
    x_l, x_full = _gather_x(pos_l, vel_l, mass_l, mesh, axis)
    pos_full = x_full[:, :3]
    idx, valid = _shard_graph(model, pos_l, pos_full, mesh, axis)
    h_full = select_input_features(x_full, model.in_channels)
    if model.encoder is not None:
        h_full = model.encoder(h_full[None])[0]
    h_l = h_full[rows]
    enc_l = h_l
    geom = conv_geometry(pos_l[None], idx[None], valid[None], model.radius,
                         pos_src=pos_full[None])
    for li, conv in enumerate(model.convs):
        out = conv(pos_l[None], h_l[None], idx[None], valid[None], geom=geom,
                   feat_src=h_full[None])
        h_l = model.conv_dropout(torch.tanh(out))[0]
        if li < len(model.convs) - 1:
            h_full = all_gather(h_l, mesh, axis)
    return _head(model, enc_l, h_l)


def _local_inputs(mesh, axis, *arrays):
    sh = particle_sharding(mesh, axis)
    return [sh.local(a) for a in arrays]


@torch.no_grad()
def _predict(forward, model, pos, vel, mass, mesh, axis):
    with _mode(model, False):
        out_l = forward(model, *_local_inputs(mesh, axis, pos, vel, mass), mesh, axis)
    return all_gather(out_l, mesh, axis)


def sharded_predict(model, pos, vel, mass, mesh: Mesh, axis: str = PARTICLE_AXIS):
    """Surrogate accelerations (N, 3) of a ``GraphModel`` with the particle
    axis split over ``mesh``'s ``axis``: the counterpart of
    ``train.rollout.predict_accelerations`` (eval mode). N must be divisible
    by the axis size."""
    return _predict(_gnn_forward_local, model, pos, vel, mass, mesh, axis)


def sharded_contconv_predict(model, pos, vel, mass, mesh: Mesh,
                             axis: str = PARTICLE_AXIS):
    """The ``ContinuousConvModel`` twin of :func:`sharded_predict` (eval
    mode: the encoder's batch norm uses its running statistics). A layer
    with ``node_chunks > 1`` raises ``ValueError``."""
    return _predict(_contconv_forward_local, model, pos, vel, mass, mesh, axis)


@torch.no_grad()
def _rollout(forward, model, pos0, vel0, mass, steps, dt, mesh, axis):
    """KDK leapfrog with the learned force on this rank's rows (the
    semantics of ``train.rollout.autoregressive_rollout``), gathered along
    the particle axis at the end."""
    p, v, m = _local_inputs(mesh, axis, pos0, vel0, mass)
    with _mode(model, False):
        a = forward(model, p, v, m, mesh, axis)
        ps, vs, accs = [p], [v], [a]
        for _ in range(steps - 1):
            v_half = v + 0.5 * dt * a
            p = p + dt * v_half
            a = forward(model, p, v_half, m, mesh, axis)
            v = v_half + 0.5 * dt * a
            ps.append(p)
            vs.append(v)
            accs.append(a)
    # (N/n, steps, 3) a rank, gathered along the particles
    return tuple(all_gather(torch.stack(t, dim=1), mesh, axis).transpose(0, 1)
                 for t in (ps, vs, accs))


def sharded_rollout(model, pos0, vel0, mass, steps: int, dt: float, mesh: Mesh,
                    axis: str = PARTICLE_AXIS):
    """Particle-sharded autoregressive rollout of a ``GraphModel``.

    :return: (pos, vel, acc), each (steps, N, 3); row 0 is the seed state
        with its predicted acceleration.
    """
    return _rollout(_gnn_forward_local, model, pos0, vel0, mass, steps, dt, mesh, axis)


def sharded_contconv_rollout(model, pos0, vel0, mass, steps: int, dt: float,
                             mesh: Mesh, axis: str = PARTICLE_AXIS):
    """The ``ContinuousConvModel`` twin of :func:`sharded_rollout` (radius
    graphs rebuilt from the predicted positions every step)."""
    return _rollout(_contconv_forward_local, model, pos0, vel0, mass, steps, dt, mesh,
                    axis)


def _sharded_rmse_step(forward, model, pos, vel, mass, y, mesh, axis):
    """The scaled RMSE ``L = sqrt(S / 3N)`` (S = sum of squares of
    ``scale * (pred - y)`` over every rank) and its parameter gradients.
    Each rank differentiates its LOCAL sum of squares only, with no
    all-reduce inside the autograd path (a psum there would scale every
    cotangent by n); the all-gathers inside the forward sum their
    cotangents over the ranks in their backward. Then

        dL/dp = psum(dS_local/dp) / (2 * 3N * L).

    :return: (loss, {parameter name: gradient}), the same on every rank.
    """
    p, v, m, y_l = _local_inputs(mesh, axis, pos, vel, mass, y)
    n = pos.shape[0]
    named = [(k, t) for k, t in model.named_parameters() if t.requires_grad]
    pred = forward(model, p, v, m, mesh, axis)
    sse = ((model.scale_factor * (pred - y_l)) ** 2).sum()
    grads = torch.autograd.grad(sse, [t for _, t in named], allow_unused=True)
    total = psum(sse.detach(), mesh, axis)
    loss = torch.sqrt(total / (n * 3))
    coef = 0.5 / torch.clamp(loss * (n * 3), min=1e-30)
    summed = psum_all([torch.zeros_like(t) if g is None else g
                       for (_, t), g in zip(named, grads)], mesh, axis)
    return loss, {k: (g * coef).view_as(t) for (k, t), g in zip(named, summed)}


def sharded_loss_and_grad(model, pos, vel, mass, y, mesh: Mesh,
                          axis: str = PARTICLE_AXIS) -> Tuple[torch.Tensor, dict]:
    """The reference's scaled-RMSE loss of a ``GraphModel`` against target
    accelerations ``y`` (N, 3) and its parameter gradients, with the
    particle axis split over ``mesh``: the single-rank gradients, reached
    by autograd through the sharded forward. Dropout must be 0 (the forward
    runs without it, as the JAX one does).

    :return: (loss, {parameter name: gradient}), the same on every rank.
    """
    if model.encoder_dropout != 0.0:
        raise ValueError("sharded training applies the encoder without dropout; "
                         f"encoder_dropout={model.encoder_dropout}")
    with _mode(model, False):
        return _sharded_rmse_step(_gnn_forward_local, model, pos, vel, mass, y, mesh, axis)


def sharded_contconv_loss_and_grad(model, pos, vel, mass, y, mesh: Mesh,
                                   axis: str = PARTICLE_AXIS):
    """The ``ContinuousConvModel`` twin of :func:`sharded_loss_and_grad`,
    in train mode: the encoder's batch norm takes its statistics over the
    replicated full node array (the single-rank statistics of the same
    batch) and updates the model's running statistics, as a training
    forward does. On the card the layers run B3 and their backward B4 and
    B5 on each rank's rows.

    :return: (loss, {parameter name: gradient}, {buffer name: new running
        statistic}), the same on every rank.
    """
    if model.encoder_dropout != 0.0 or model.continuous_conv_dropout != 0.0:
        raise ValueError("sharded training does not apply dropout; encoder_dropout="
                         f"{model.encoder_dropout}, continuous_conv_dropout="
                         f"{model.continuous_conv_dropout}")
    with _mode(model, True):
        loss, grads = _sharded_rmse_step(_contconv_forward_local, model, pos, vel,
                                         mass, y, mesh, axis)
    stats = {f"{name}.{b}": getattr(mod, b).detach().clone()
             for name, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)
             for b in ("running_mean", "running_var")}
    return loss, grads, stats
