"""Linear layers, masked batch norm, the MLP block and the decoder head —
the port of ``nbody_tpu/models/mlp.py``.

``Dense`` is ``nn.Linear``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
bias, the initialisation the JAX package's ``Dense`` copies. A model's
weights are drawn from flax's streams (``models/init.py``). Weights are
stored (out, in) as in torch; ``models.convert`` transposes the flax (in,
out) kernels. ``Dropout`` is flax's, on the trainer's ``dropout`` keys.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from nbody_tpu_torch.models.init import flax_key
from nbody_tpu_torch.utils import prng


class Dense(nn.Linear):
    """``nn.Linear``, whose own initialisation is the reference's
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""


class Dropout(nn.Module):
    """flax ``nn.Dropout`` (``flax/linen/stochastic.py``) on the step's
    ``dropout`` key: in training it keeps ``x / keep_prob`` where
    ``bernoulli(flax_key(key, *path, 1), keep_prob, x.shape)`` and writes 0
    elsewhere, ``keep_prob = 1 - rate``; in eval mode, or at rate 0, it
    passes ``x`` through.

    :param path: the flax module path, e.g. ``("MLP_0", "Dropout_0")``.

    ``key`` is set before each training forward (``set_dropout_key``: the
    ``Trainer`` sets each step's key, as the JAX trainer passes
    ``rngs={"dropout": key}``); a training forward without one raises.
    ``rows = (first, total)`` makes the mask this rank's rows ``first ..`` of
    the mask of a ``total``-row batch (``Trainer(mesh=)``): an element's
    bits depend on its index alone.
    """

    def __init__(self, rate: float, path: Sequence[str]):
        super().__init__()
        self.rate = float(rate)
        self.path = tuple(path)
        self.key: Optional[torch.Tensor] = None
        self.rows: Optional[Tuple[int, int]] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.key is None:
            raise RuntimeError(
                f"dropout {'/'.join(self.path)} is training without a key: the Trainer "
                "sets each step's (set_dropout_key)")
        keep = 1.0 - self.rate
        offset = 0 if self.rows is None else self.rows[0] * math.prod(x.shape[1:])
        mask = prng.bernoulli(flax_key(self.key, *self.path, 1), keep, tuple(x.shape),
                              device=x.device, offset=offset)
        # divide by a tensor on x's device: torch's CUDA division by a
        # Python number multiplies by the reciprocal
        return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device), 0.0)


def set_dropout_key(model: nn.Module, key: Optional[torch.Tensor],
                    rows: Optional[Tuple[int, int]] = None) -> None:
    """Give every :class:`Dropout` of ``model`` the step's ``dropout`` key
    (and ``rows``)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.key, m.rows = key, rows


def has_dropout(model: nn.Module) -> bool:
    """Whether a training forward of ``model`` draws dropout masks."""
    return any(isinstance(m, Dropout) and 0.0 < m.rate < 1.0 for m in model.modules())


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d whose batch statistics cover the valid nodes only — the
    port of the JAX ``MaskedBatchNorm`` (torch's BatchNorm1d on PyG's
    unpadded node batch). Train mode normalises with the biased batch
    variance and updates the running variance with the unbiased one; eval
    mode normalises with the running statistics. ``momentum`` keeps the flax
    decay convention: 0.9 here is torch momentum 0.1. With ``mask=None`` the
    statistics reduce over every leading axis.

    Parameters ``weight`` (flax ``scale``) and ``bias``; buffers
    ``running_mean`` and ``running_var`` (flax ``batch_stats`` ``mean`` and
    ``var``).

    ``sum_over``, None by default, is set by a data-parallel trainer
    (``Trainer(mesh=)``) to a differentiable sum over its ranks: the
    training statistics then cover the valid nodes of every rank's rows,
    the statistics of the whole batch.
    """

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.sum_over = None

    def _batch_stats(self, xf, mask):
        """(count, mean, biased variance) over the valid rows of ``xf``,
        with ``sum_over`` over the valid rows of every rank."""
        f = xf.shape[-1]
        if self.sum_over is not None:
            w = (torch.ones_like(xf[:, :1]) if mask is None
                 else mask.to(xf.dtype).reshape(-1, 1))
            s = self.sum_over(torch.cat([(xf * w).sum(0), w.sum()[None]]))
            cnt = torch.clamp(s[f], min=1.0)
            mean = s[:f] / cnt
            return cnt, mean, self.sum_over((w * (xf - mean) ** 2).sum(0)) / cnt
        if mask is not None:
            w = mask.to(xf.dtype).reshape(-1, 1).expand(xf.shape)
            cnt = torch.clamp(w[:, 0].sum(), min=1.0)
            mean = (xf * w).sum(0) / cnt
            return cnt, mean, (w * (xf - mean) ** 2).sum(0) / cnt
        cnt = torch.tensor(float(xf.shape[0]), dtype=xf.dtype, device=xf.device)
        mean = xf.mean(0)
        return cnt, mean, ((xf - mean) ** 2).mean(0)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.training:
            cnt, mean, var = self._batch_stats(x.reshape(-1, x.shape[-1]), mask)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


class MLP(nn.Module):
    """Per hidden layer Linear -> [norm] -> tanh -> dropout, plain final
    layer: PyG's ``MLP`` as the reference uses it (``plain_last=True``). The
    GNN encoder has ``norm=None``; the ContConv encoder keeps PyG's
    ``"batch_norm"`` default (:class:`MaskedBatchNorm`, whose statistics see
    only the nodes of ``mask``).

    :param in_features: input width.
    :param features: hidden widths followed by the output width.
    """

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0, norm: Optional[str] = None):
        super().__init__()
        if norm not in (None, "batch_norm"):
            raise ValueError(f"unknown norm {norm!r}")
        dims = [in_features, *features]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims, dims[1:]))
        self.norms = (nn.ModuleList(MaskedBatchNorm(f) for f in features[:-1])
                      if norm == "batch_norm" else None)
        # both models' encoder is flax's MLP_0
        self.dropouts = nn.ModuleList(Dropout(dropout, ("MLP_0", f"Dropout_{i}"))
                                      for i in range(len(features) - 1))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        for i, layer in enumerate(self.layers[:-1]):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x, mask=mask)
            x = self.dropouts[i](torch.tanh(x))
        return self.layers[-1](x)


class OutputHead(nn.Module):
    """The reference's decoder head: a plain Linear when there are no hidden
    widths, otherwise Linear/tanh layers and a plain final Linear.
    ``zero_init`` starts the final Linear at zero weight and bias."""

    def __init__(self, in_features: int, hiddens: Optional[Sequence[int]],
                 output_dim: int, zero_init: bool = False):
        super().__init__()
        dims = [in_features, *(hiddens or ()), output_dim]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims, dims[1:]))
        if zero_init:
            with torch.no_grad():
                self.layers[-1].weight.zero_()
                self.layers[-1].bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)
