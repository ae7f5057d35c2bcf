"""Plain forward passes of the two published surrogates, from a flat dict of
weights (the benchmark's draw) and the configuration.

- EdgeConv GNN (PyG ``EdgeConv`` as the reference repository's ``gnn.py``
  stacks it): per node i, aggr_j MLP([h_i || h_j - h_i]) over its k
  neighbours, the MLP ``Linear(2d, d) -> tanh -> Linear(d, d)``; then
  LayerNorm of [encoder output || last layer] and the output Linear.
- Continuous convolution (Ummenhofer et al., ICLR 2020, as the reference
  repository's ``contconv.py``): per edge the ball-to-cube map of the
  displacement, the poly6 window (1 - d^2/r^2)^3 inside the radius, and the
  trilinear lookup of a (D, D, D, ci, co) filter grid; the mean over
  neighbours in the radius and tanh per layer; an MLP encoder with batch
  norm before, a LayerNorm and an MLP decoder after.

``precision="tf32"`` rounds the operands of every matrix product (forward
and backward) to TF32's 10-bit mantissa, as the tensor cores do: the
control that a correct run must tell apart from float32.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).transpose(-1, -2), round_tf32(a).transpose(-1, -2) @ g


def matmul(a, b, precision="float32"):
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def linear(x, w, bias, precision="float32"):
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), precision) + bias
    return y.reshape(*lead, w.shape[0])


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _features(pos, mass):
    """[pos | mass], the input of both models' ``input_dim`` / ``in_channels`` 4."""
    return torch.cat([pos, mass[:, None]], dim=-1)


def _head(h, w, prefix, n_layers, precision):
    for i in range(n_layers):
        h = linear(h, w[f"{prefix}.{i}.weight"], w[f"{prefix}.{i}.bias"], precision)
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h


def _masked_mean(e, valid):
    s = torch.where(valid[..., None], e, 0.0).sum(1)
    return s / torch.clamp(valid.to(e.dtype).sum(1)[:, None], min=1.0)


def gnn_forward(w, cfg, pos, mass, idx, valid, precision="float32", rows=None):
    """(N, 3) accelerations of the EdgeConv model; ``rows`` evaluates the
    edge MLP in blocks of that many receivers."""
    h = _features(pos, mass)
    enc = h
    n = h.shape[0]
    rows = rows or n
    for layer in range(cfg["message_passing_steps"]):
        p = f"convs.{layer}"
        outs = []
        for r0 in range(0, n, rows):
            sl = slice(r0, r0 + rows)
            h_i = h[sl][:, None, :].expand(-1, idx.shape[1], -1)
            h_j = h[idx[sl].long()]
            e = torch.tanh(linear(torch.cat([h_i, h_j - h_i], dim=-1),
                                  w[f"{p}.dense0.weight"], w[f"{p}.dense0.bias"], precision))
            e = linear(e, w[f"{p}.dense1.weight"], w[f"{p}.dense1.bias"], precision)
            if cfg["aggr"] == "mean":
                outs.append(_masked_mean(e, valid[sl]))
            else:
                outs.append(torch.where(valid[sl][..., None], e, 0.0).sum(1))
        h = torch.cat(outs)
    out = layer_norm(torch.cat([enc, h], dim=-1), w["norm.weight"], w["norm.bias"])
    return _head(out, w, "head.layers", 1 + len(cfg.get("output_hiddens") or ()), precision)


def ball_to_cube(r):
    n2 = (r * r).sum(-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(n2, min=1e-24))
    return r / (norm + 1e-8) * torch.tanh(norm)


def conv_geometry(pos, idx, valid, radius):
    """Per edge the grid-space displacement map, the window and whether it
    lies in the radius."""
    r = pos[idx.long()] - pos[:, None, :]
    dist2 = (r * r).sum(-1)
    r2 = float(torch.tensor(float(radius), dtype=torch.float32) ** 2)
    in_radius = (dist2 < r2) & valid
    window = torch.where(in_radius, (1.0 - dist2 / r2) ** 3, 0.0)
    return ball_to_cube(r), window, in_radius


def corners(mapped, d):
    """The 8 trilinear corners of each edge: (cells (M, k, 8) int64, weights
    (M, k, 8)), the grid index (x D + y) D + z, corners in (x, y, z) order."""
    c = torch.clamp((mapped + 1.0) * ((d - 1) / 2.0), 0.0, d - 1)
    c0 = torch.clamp(torch.floor(c), 0, d - 2)
    f = c - c0
    c0 = c0.long()
    cells, ws = [], []
    for ox in (0, 1):
        wx = f[..., 0] if ox else 1.0 - f[..., 0]
        for oy in (0, 1):
            wy = f[..., 1] if oy else 1.0 - f[..., 1]
            for oz in (0, 1):
                wz = f[..., 2] if oz else 1.0 - f[..., 2]
                cells.append(((c0[..., 0] + ox) * d + c0[..., 1] + oy) * d + c0[..., 2] + oz)
                ws.append(wx * wy * wz)
    return torch.stack(cells, -1), torch.stack(ws, -1)


def conv_collect(feat, idx, mapped, window, filters, precision="float32"):
    """sum_e window_e * feat[idx_e] @ T(filters at the edge's grid point), per
    receiver: each edge's corner-weighted features binned by cell, then one
    product of the bins with the whole filter bank."""
    d, ci, co = filters.shape[0], filters.shape[3], filters.shape[4]
    z = d * d * d
    m, k = idx.shape
    cells, cw = corners(mapped, d)
    wf = feat[idx.long()] * window[..., None]  # (M, k, ci)
    base = (torch.arange(m, device=feat.device) * z)[:, None]
    bins = torch.zeros((m * z, ci), dtype=feat.dtype, device=feat.device)
    for c in range(8):
        bins.index_add_(0, (base + cells[..., c]).reshape(-1),
                        (wf * cw[..., c, None]).reshape(-1, ci))
    return matmul(bins.view(m, z * ci), filters.reshape(z * ci, co), precision)


def _batch_norm(x, w, b, mean, var, train, eps=1e-5):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def contconv_forward(w, cfg, pos, mass, idx, valid, precision="float32", train=False,
                     rows=None):
    """(N, 3) accelerations of the continuous-convolution model. ``train``
    takes the encoder's batch statistics from the batch (the training
    forward); ``rows`` collects in blocks of that many receivers."""
    h = _features(pos, mass)
    n_enc = len(cfg["encoder_hiddens"]) + 1
    for i in range(n_enc):
        h = linear(h, w[f"encoder.layers.{i}.weight"], w[f"encoder.layers.{i}.bias"], precision)
        if i < n_enc - 1:
            p = f"encoder.norms.{i}"
            h = torch.tanh(_batch_norm(h, w[f"{p}.weight"], w[f"{p}.bias"], w[f"{p}.running_mean"],
                                       w[f"{p}.running_var"], train))
    enc = h
    mapped, window, in_radius = conv_geometry(pos, idx, valid, cfg["radius"])
    cnt = torch.clamp(in_radius.to(h.dtype).sum(-1, keepdim=True), min=1.0)
    n = h.shape[0]
    rows = rows or n
    for layer in range(cfg["continuous_conv_layers"]):
        filt = w[f"convs.{layer}.filters"]
        out = torch.cat([conv_collect(h, idx[sl], mapped[sl], window[sl], filt, precision)
                         for sl in (slice(r0, r0 + rows) for r0 in range(0, n, rows))])
        h = torch.tanh(out / cnt if cfg["agg"] == "mean" else out)
    out = layer_norm(torch.cat([enc, h], dim=-1), w["norm.weight"], w["norm.bias"])
    return _head(out, w, "head.layers", 1 + len(cfg["decoder_hiddens"]), precision)


def forward(w, cfg, pos, mass, idx, valid, precision="float32", train=False, rows=None):
    """The configuration's model (``cfg["model"]``: ``gnn`` or ``contconv``)."""
    if cfg["model"] == "gnn":
        return gnn_forward(w, cfg, pos, mass, idx, valid, precision, rows)
    return contconv_forward(w, cfg, pos, mass, idx, valid, precision, train, rows)


def scaled_rmse(pred, target, scale):
    """The training objective: scale * sqrt(mean squared error over bodies and
    axes)."""
    return scale * torch.sqrt(((pred - target) ** 2).mean())
