"""Flax's parameter streams in plain torch: a key gives the JAX package's
initial model.

``model.init(key, ...)`` gives every parameter a key of its own: the key
folded with the first four bytes (big-endian) of the SHA-1 of the
parameter's module path and a counter, the number of keys that module has
drawn so far (``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``,
``Scope.make_rng``; ``flax_fix_rng_separator`` off, so the parts are
hashed with nothing between them). A ``Dense`` draws its kernel with
counter 1 and its bias with 2, so ``params/EdgeConv_0/Dense_0/kernel`` is
drawn from ``flax_key(key, "EdgeConv_0", "Dense_0", 1)``. Dropout draws its
mask the same way from the ``dropout`` key of a step (``Dropout_i`` with
counter 1).

Each parameter is drawn in flax's shape ((in, out) for a kernel, (D, D,
D, ci, co) for filters) with the JAX package's initialiser, then laid into
the port's parameters by ``models.convert``:

- ``Dense`` kernels: ``variance_scaling(1/3, "fan_in", "uniform")``
  (``nbody_tpu/models/mlp.py:22-26``), a uniform on [-1, 1) times
  ``sqrt(3 * variance)``, that constant rounded as JAX rounds it (the
  variance to float32, then a float32 product and square root);
- ``Dense`` biases: ``_torch_bias_init`` (``mlp.py:29-41``), a uniform on
  [-1/sqrt(fan_in), 1/sqrt(fan_in));
- ContConv filters: ``normal(stddev=1.0)`` (``models/contconv.py:157``);
- ones and zeros: LayerNorm and batch-norm scales and biases, batch-norm
  statistics, and the ``zero_init`` head's last layer.

The draws run on the key's device and give the same bits on the CPU and a
card (``utils/prng.py``): the uniform leaves are JAX's bits, the normal
ones JAX's but for a few draws in 10^5, by at most 2 ulps.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Union

import numpy as np
import torch

from nbody_tpu_torch.utils import prng

Foldable = Union[str, int]


def flax_key(root: torch.Tensor, *suffix: Foldable) -> torch.Tensor:
    """``LazyRng.create(root, *suffix).as_jax_rng()``: ``root`` folded with
    the first four bytes of the SHA-1 of the strings (UTF-8) and integers
    (big-endian, as few bytes as they need) of ``suffix``."""
    if not suffix:
        return root
    h = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        elif isinstance(x, (int, np.integer)):
            x = int(x)
            h.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise TypeError(f"a flax key folds strings and integers, not {type(x)}")
    return prng.fold_in(root, int.from_bytes(h.digest()[:4], byteorder="big"))


def dense_kernel_scale(fan_in: int) -> float:
    """``jnp.sqrt(3 * variance)`` of ``variance_scaling(1/3, "fan_in",
    "uniform")`` as JAX computes it: the variance rounded to float32, then
    the float32 product and square root (both exactly rounded)."""
    variance = np.float32((1.0 / 3.0) / fan_in)
    return float(np.sqrt(np.float32(3) * variance, dtype=np.float32))


def dense_params(root: torch.Tensor, path: Sequence[str], fan_in: int,
                 features: int) -> Dict[str, torch.Tensor]:
    """The flax ``Dense`` of the JAX package at ``path``: its kernel
    (fan_in, features) and bias (features,)."""
    kernel = prng.uniform(flax_key(root, *path, 1), (fan_in, features), -1.0, 1.0)
    bound = float(fan_in) ** -0.5
    return {"kernel": kernel * dense_kernel_scale(fan_in),
            "bias": prng.uniform(flax_key(root, *path, 2), (features,), -bound, bound)}


def _zeros_dense(root, fan_in: int, features: int) -> Dict[str, torch.Tensor]:
    dev = root.device
    return {"kernel": torch.zeros(fan_in, features, device=dev),
            "bias": torch.zeros(features, device=dev)}


def _norm(root, features: int) -> Dict[str, torch.Tensor]:
    """LayerNorm's and MaskedBatchNorm's ``scale`` (ones) and ``bias``
    (zeros)."""
    return {"scale": torch.ones(features, device=root.device),
            "bias": torch.zeros(features, device=root.device)}


def _layers(root, path: Sequence[str], layers, zero_last: bool = False) -> dict:
    """``Dense_i`` of a stack of port ``Dense`` layers under ``path``."""
    tree = {}
    for i, layer in enumerate(layers):
        if zero_last and i == len(layers) - 1:
            tree[f"Dense_{i}"] = _zeros_dense(root, layer.in_features, layer.out_features)
        else:
            tree[f"Dense_{i}"] = dense_params(root, (*path, f"Dense_{i}"),
                                              layer.in_features, layer.out_features)
    return tree


def graph_model_params(model, key: torch.Tensor) -> dict:
    """The flax ``params`` tree of ``GraphModel.init(key, ...)`` for the
    port's ``GraphModel`` ``model`` (its widths read from its layers),
    drawn on the key's device."""
    params = {}
    if model.encoder is not None:
        params["MLP_0"] = _layers(key, ("MLP_0",), model.encoder.layers)
    for i, conv in enumerate(model.convs):
        params[f"EdgeConv_{i}"] = _layers(key, (f"EdgeConv_{i}",), [conv.dense0, conv.dense1])
    params["LayerNorm_0"] = _norm(key, model.norm.normalized_shape[0])
    params["OutputHead_0"] = _layers(key, ("OutputHead_0",), model.head.layers,
                                     zero_last=model.zero_init_output)
    return params


def contconv_model_variables(model, key: torch.Tensor) -> dict:
    """The flax variables (``params`` and ``batch_stats``) of
    ``ContinuousConvModel.init(key, ...)`` for the port's model, drawn on
    the key's device."""
    params, stats = {}, {}
    if model.encoder is not None:
        enc = _layers(key, ("MLP_0",), model.encoder.layers)
        for i, bn in enumerate(model.encoder.norms or ()):
            f = bn.weight.shape[0]
            enc[f"MaskedBatchNorm_{i}"] = _norm(key, f)
            stats[f"MaskedBatchNorm_{i}"] = {"mean": torch.zeros(f, device=key.device),
                                             "var": torch.ones(f, device=key.device)}
        params["MLP_0"] = enc
    for i, conv in enumerate(model.convs):
        params[f"ContinuousConv_{i}"] = {"filters": prng.normal(
            flax_key(key, f"ContinuousConv_{i}", 1), tuple(conv.filters.shape))}
    params["LayerNorm_0"] = _norm(key, model.norm.normalized_shape[0])
    params["OutputHead_0"] = _layers(key, ("OutputHead_0",), model.head.layers,
                                     zero_last=model.zero_init_output)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = {"MLP_0": stats}
    return variables


def _draw_pending(module, incompatible_keys) -> None:
    """``load_state_dict`` post-hook: loaded weights are the model's own."""
    module.draw_pending = False


def init_weights(model, key) -> None:
    """End of a model's ``__init__``: with a key, set its weights to flax's
    draws from it (:meth:`draw_weights`); without one, mark the model
    ``draw_pending``: its parameters keep torch's own initialisation until a
    ``Trainer`` draws them from its init key at first use, as the JAX
    trainer runs ``model.init``. Loading a ``state_dict`` clears the mark."""
    model.draw_pending = key is None
    model.register_load_state_dict_post_hook(_draw_pending)
    if key is not None:
        model.draw_weights(key)


__all__ = ["flax_key", "dense_kernel_scale", "dense_params", "graph_model_params",
           "contconv_model_variables", "init_weights"]
