"""Linear layers, the MLP block and the decoder head — the port of
``nbody_tpu/models/mlp.py``.

``Dense`` is ``nn.Linear`` with its default initialisation, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias, drawn from an explicit
``torch.Generator`` when one is given. The JAX package's ``Dense`` copies
exactly this initialisation, so the two start from the same distribution.
Weights are stored (out, in) as in torch; ``models.convert`` transposes the
flax (in, out) kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` whose initialisation can draw from a given generator."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)


def reset_dense(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-draw every :class:`Dense` of ``module`` from ``generator``, in
    registration order (zero-initialised heads are left at zero)."""
    for m in module.modules():
        if isinstance(m, Dense) and not getattr(m, "zero_init", False):
            m.reset_parameters(generator)


class MLP(nn.Module):
    """Per hidden layer Linear -> tanh -> dropout, plain final layer: PyG's
    ``MLP`` as the GNN encoder uses it (``norm=None``, ``plain_last=True``;
    the batch-norm variant comes with the ContConv slice).

    :param in_features: input width.
    :param features: hidden widths followed by the output width.
    """

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims, dims[1:]))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.dropout(torch.tanh(layer(x)))
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
            last = self.layers[-1]
            last.zero_init = True
            with torch.no_grad():
                last.weight.zero_()
                last.bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)
