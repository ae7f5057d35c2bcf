"""Flax variables of the JAX ``GraphModel`` and ``ContinuousConvModel`` ->
``state_dict`` of the port's models.

The input is the flax parameter tree with numpy arrays as leaves (for
example ``jax.tree_util.tree_map(np.asarray, variables)``), so this module
needs no JAX, or with torch tensors as leaves (``models.init``'s draws,
kept on their device). Name map:

- ``MLP_0/Dense_i``        -> ``encoder.layers.i``
- ``EdgeConv_i/Dense_j``   -> ``convs.i.dense{j}``
- ``LayerNorm_0``          -> ``norm``
- ``OutputHead_0/Dense_i`` -> ``head.layers.i``

A flax ``Dense.kernel`` is (in, out) and becomes ``Linear.weight`` (out, in);
``LayerNorm.scale`` becomes ``weight``.

``ContinuousConvModel`` (:func:`contconv_model_state_dict`) adds:

- ``MLP_0/MaskedBatchNorm_i``   -> ``encoder.norms.i`` (``scale`` ->
  ``weight``, ``bias``; ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``)
- ``ContinuousConv_i/filters``  -> ``convs.i.filters``, kept in the flax
  (D, D, D, ci, co) layout
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = re.compile(r"Dense_(\d+)$")


def _vector(x) -> torch.Tensor:
    """A float32 copy of a numpy or torch leaf (a torch leaf stays on its
    device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _dense(prefix: str, tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _vector(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _vector(tree["bias"])


def _dense_layers(prefix: str, tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    for name, sub in tree.items():
        m = _DENSE.match(name)
        if m is None:
            raise KeyError(f"unexpected parameter {prefix}/{name}")
        _dense(f"{prefix}.{m.group(1)}", sub, out)


def graph_model_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for :class:`nbody_tpu_torch.models.GraphModel` from a
    flax ``GraphModel`` parameter tree (``variables`` or
    ``variables["params"]``)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "MLP_0":
            _dense_layers("encoder.layers", sub, out)
        elif name.startswith("EdgeConv_"):
            i = int(name.split("_")[1])
            for dname, dsub in sub.items():
                _dense(f"convs.{i}.dense{_DENSE.match(dname).group(1)}", dsub, out)
        elif name == "LayerNorm_0":
            out["norm.weight"] = _vector(sub["scale"])
            out["norm.bias"] = _vector(sub["bias"])
        elif name == "OutputHead_0":
            _dense_layers("head.layers", sub, out)
        else:
            raise KeyError(f"unexpected parameter group {name}")
    return out


def contconv_model_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for :class:`nbody_tpu_torch.models.ContinuousConvModel`
    made of the flax ``variables``: ``params`` and, when the encoder has
    batch norms, ``batch_stats``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("MLP_0", {})
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "MLP_0":
            for lname, lsub in sub.items():
                i = int(lname.rsplit("_", 1)[1])
                if lname.startswith("Dense_"):
                    _dense(f"encoder.layers.{i}", lsub, out)
                elif lname.startswith("MaskedBatchNorm_"):
                    out[f"encoder.norms.{i}.weight"] = _vector(lsub["scale"])
                    out[f"encoder.norms.{i}.bias"] = _vector(lsub["bias"])
                    out[f"encoder.norms.{i}.running_mean"] = _vector(stats[lname]["mean"])
                    out[f"encoder.norms.{i}.running_var"] = _vector(stats[lname]["var"])
                else:
                    raise KeyError(f"unexpected parameter MLP_0/{lname}")
        elif name.startswith("ContinuousConv_"):
            i = int(name.split("_")[1])
            out[f"convs.{i}.filters"] = _vector(sub["filters"])
        elif name == "LayerNorm_0":
            out["norm.weight"] = _vector(sub["scale"])
            out["norm.bias"] = _vector(sub["bias"])
        elif name == "OutputHead_0":
            _dense_layers("head.layers", sub, out)
        else:
            raise KeyError(f"unexpected parameter group {name}")
    return out
