"""The weights of a cell, drawn from ``--seed`` on the device in two calls:
one uniform draw for every Linear layer (U(-1/sqrt(fan_in), 1/sqrt(fan_in))
for weight and bias, the initialisation of the published models) and one
normal draw for every ContConv filter bank (N(0, 1), as ``torch.randn`` in
the reference repository). Norm scales are 1 and shifts 0, batch-norm
statistics 0 and 1. Every layer is drawn, the output layer too, so the
weights stand for a model in training: a configuration's
``zero_init_output`` is kept as published and passed to the program, whose
zero output layer these weights then replace (a zero output layer would make
every gradient but its own 0 at the first step, and the check would not see
the layers below it).

The names are the models' state-dict keys. The same draw goes to the
program and, drawn again after the window, to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _dense(out: List, name: str, fan_in: int, fan_out: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    out.append((f"{name}.weight", (fan_out, fan_in), ("uniform", bound)))
    out.append((f"{name}.bias", (fan_out,), ("uniform", bound)))


def _norm(out: List, name: str, width: int, stats: bool = False) -> None:
    out.append((f"{name}.weight", (width,), ("const", 1.0)))
    out.append((f"{name}.bias", (width,), ("const", 0.0)))
    if stats:
        out.append((f"{name}.running_mean", (width,), ("const", 0.0)))
        out.append((f"{name}.running_var", (width,), ("const", 1.0)))


def spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter and buffer of the model."""
    out: List = []
    if cfg["model"] == "gnn":
        dim, width = cfg["gnn_dim"], cfg["input_dim"]
        for layer in range(cfg["message_passing_steps"]):
            _dense(out, f"convs.{layer}.dense0", 2 * width, dim)
            _dense(out, f"convs.{layer}.dense1", dim, dim)
            width = dim
        head_in = cfg["input_dim"] + dim
        hidden = list(cfg.get("output_hiddens") or ())
    else:
        dim = cfg["continuous_conv_dim"]
        dims = [cfg["in_channels"], *cfg["encoder_hiddens"], dim]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            _dense(out, f"encoder.layers.{i}", a, b)
        for i, width in enumerate(cfg["encoder_hiddens"]):
            _norm(out, f"encoder.norms.{i}", width, stats=True)
        for layer, d in enumerate(cfg["filter_resolution"][:cfg["continuous_conv_layers"]]):
            out.append((f"convs.{layer}.filters", (d, d, d, dim, dim), ("normal", 1.0)))
        head_in = 2 * dim
        hidden = list(cfg["decoder_hiddens"])
    _norm(out, "norm", head_in)
    dims = [head_in, *hidden, 3]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        _dense(out, f"head.layers.{i}", a, b)
    return out


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} from ``seed``."""
    items = spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = {kind: sum(math.prod(s) for _, s, (k, _) in items if k == kind)
             for kind in ("uniform", "normal")}
    pool = {
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0,
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
    }
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, scale) in items:
        if kind == "const":
            out[name] = torch.full(shape, scale, dtype=torch.float32, device=device)
            continue
        size = math.prod(shape)
        out[name] = (pool[kind][at[kind]:at[kind] + size] * scale).reshape(shape)
        at[kind] += size
    return out
