"""Times B11 (``ops.edgeconv_kernel.windowed_tanh_sum``) and the whole
``edge_message_sum`` on the inputs ``chip_smoke.py`` phase 10 gives them:

    python -m nbody_tpu_torch.experiments.edgeconv_bench --n-bodies 1000000

It is the tool for A/B runs of B11: run it from two checkouts on one card,
one after the other, in the order A, B, B, A. It uses only what every
version of the port has (the module's ``windowed_tanh_sum``,
``plan_windowed_gather`` and ``edge_message_sum``, and ``utils.timing``'s
``cuda_time_ms`` and ``kernel_events``), so a copy of this file placed in an
older checkout times that one. It checks nothing: the card tests and
``chip_smoke.py`` hold the kernel to its plain version.

Two rows, each printed as JSON:

- ``synthetic``: phase 10a's input (:func:`synthetic`: N rows padded to
  whole tiles, k = 8, d = 64, tile 256, half 384, senders within 500 rows,
  90% of slots set, from seed 23), B11 in float32 and bfloat16 gather:
  milliseconds between CUDA events (the mean of ``REPS`` calls after a
  warm-up) and the kernel's own device milliseconds from the profiler;
- ``path``: phase 10b's data (:func:`path_data`): spiral bodies in Morton
  order, their k = 8 Morton graph and ``u'``, ``v`` of the first EdgeConv
  of the 1M model with its committed weights (``PARAMS_1M``): the plan,
  torch's gather + tanh + masked sum, B11 alone on the plan's in-window
  edges, and ``edge_message_sum`` in float32 and bfloat16 (ms by events;
  device ms and kernels a call from the profiler).

``chip_smoke.py`` draws its phase-10 inputs from :func:`window_case`,
:func:`synthetic` and :func:`path_data`, so the two read the same data.
``--device cpu`` builds the same inputs at a small N, runs each function
once and times nothing.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.models.common import select_input_features
from nbody_tpu_torch.ops import edgeconv_kernel as ek
from nbody_tpu_torch.ops.spatial import morton_keys
from nbody_tpu_torch.train.graphs import build_graph
from nbody_tpu_torch.utils import timing

WINDOW = dict(tile=256, half=384)  # the JAX module's defaults
# the crossover / train_1m GNN (results/large_scale/train_1m.json) and its
# committed weights, found beside this checkout's package
GNN_1M = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean", neighbors=8,
              scale_factor=1e6, knn_method="morton", knn_impl="kernel")
PARAMS_1M = Path(__file__).resolve().parents[2] / "results" / "large_scale" / "train_1m_params.pt"
B11_NAME = "windowed_tanh_sum"  # a substring of B11's kernel name, as the profiler reports it
REPS = 20  # timed calls a function, after the warm-up


def window_case(gen, rows: int, k: int, d: int, spread: int, half: int, dev):
    """(u, vpad, idx, mask) drawn from ``gen``: ``rows`` receivers of width
    ``d``, ``vpad`` with ``half`` zero rows at each end, each of k senders
    within ``spread`` rows of its receiver (clamped to the table), 90% of
    the slots set."""
    u = torch.randn(rows, d, generator=gen)
    vpad = torch.nn.functional.pad(torch.randn(rows, d, generator=gen), (0, 0, half, half))
    off = torch.randint(-spread, spread + 1, (rows, k), generator=gen)
    idx = (torch.arange(rows)[:, None] + off).clamp(0, rows - 1).to(torch.int32)
    mask = torch.rand(rows, k, generator=gen) < 0.9
    return [t.to(dev) for t in (u, vpad, idx, mask)]


def synthetic(n: int, dev):
    """Phase 10a's (u, vpad, idx, mask) at ``n`` rows padded to whole tiles."""
    rows = -(-n // WINDOW["tile"]) * WINDOW["tile"]
    return window_case(torch.Generator().manual_seed(23), rows, 8, 64, 500, WINDOW["half"], dev)


def path_data(n: int, dev):
    """(pos, mass, u', v, idx, valid): ``n`` Morton-sorted spiral bodies,
    their k = 8 Morton graph and the first EdgeConv of the 1M model."""
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), n, device=dev)
    order = torch.sort(morton_keys(pos), stable=True).indices
    pos, vel, mass = pos[order], vel[order], mass[order]
    model = GraphModel(**GNN_1M, fused_edgeconv=True)
    model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
    model.to(dev).eval()
    with torch.no_grad():
        idx, valid = build_graph(model.graph_spec, pos[None])
        h = select_input_features(torch.cat([pos, vel, mass[:, None]], -1)[None], 4)
        u, v = (t[0].contiguous() for t in model.convs[0].split_terms(h))
    return pos, mass, u, v, idx[0].contiguous(), valid[0].contiguous()


def gather_sum(u, v, idx, valid):
    """Torch's gather + tanh + masked sum: the fused layer's own k-sized step."""
    t = torch.tanh(u[:, None, :] + v[idx.long()])
    return torch.where(valid[:, :, None], t, 0.0).sum(dim=1)


def window_inputs(u, v, idx, plan):
    """(u, vpad, idx) padded to the plan's whole tiles, as
    ``windowed_tanh_sum`` takes them (B11 alone on ``plan.in_mask``)."""
    half, extra = WINDOW["half"], plan.in_mask.shape[0] - u.shape[0]
    up, idxp = (torch.nn.functional.pad(t, (0, 0, 0, extra)) for t in (u, idx))
    return up, torch.nn.functional.pad(v, (0, 0, half, half + extra)), idxp


def _times(fn, dev, reps: int = REPS, name=None):
    """(ms between events, device ms a call, kernels a call); None on the
    CPU. ``name``: the device ms of the kernels whose name holds it, per
    event; otherwise every kernel, per call."""
    if dev.type != "cuda":
        fn()
        return None, None, None
    ms = timing.cuda_time_ms(fn, reps=reps, warmup=2)
    events = [e for e in timing.kernel_events(fn, reps=reps) if name is None or name in e[0]]
    per = len(events) if name else reps
    return ms, sum(t for _, t in events) / max(per, 1), len(events) / reps


def bench_synthetic(n: int, dev) -> dict:
    u, vpad, idx, mask = synthetic(n, dev)
    row = {"case": "synthetic", "rows": u.shape[0], "k": 8, "d": 64, **WINDOW,
           "edges_in_window": int((mask & ek._window_rows(idx, **WINDOW)).sum())}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ms, dev_ms, _ = _times(lambda: ek.windowed_tanh_sum(u, vpad, idx, mask, **WINDOW,
                                                            gather_dtype=dtype),
                               dev, name=B11_NAME)
        row.update({f"b11_{tag}_ms": ms, f"b11_{tag}_device_ms": dev_ms})
    return row


def bench_path(n: int, dev) -> dict:
    _, _, u, v, idx, valid = path_data(n, dev)
    plan = ek.plan_windowed_gather(idx, valid, **WINDOW)
    row = {"case": "path", "n": n, "k": idx.shape[1], "d": u.shape[1],
           "valid_edges": int(valid.sum()), "in_window": int(plan.in_mask.sum()),
           "fallback": int(plan.fb_valid.sum()), "overflow": int(plan.overflow)}
    up, vpad, idxp = window_inputs(u, v, idx, plan)
    row["plan_ms"] = _times(lambda: ek.plan_windowed_gather(idx, valid, **WINDOW), dev, 3)[0]
    row["torch_gather_ms"] = _times(lambda: gather_sum(u, v, idx, valid), dev)[0]
    row["b11_alone_ms"], row["b11_alone_device_ms"], _ = _times(
        lambda: ek.windowed_tanh_sum(up, vpad, idxp, plan.in_mask, **WINDOW), dev,
        name=B11_NAME)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ms, dev_ms, kernels = _times(lambda: ek.edge_message_sum(u, v, idx, plan, **WINDOW,
                                                                 gather_dtype=dtype),
                                     dev)
        row.update({f"edge_message_sum_{tag}_ms": ms,
                    f"edge_message_sum_{tag}_device_ms": dev_ms,
                    f"edge_message_sum_{tag}_kernels": kernels})
    return row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-bodies", type=int, default=1_000_000)
    p.add_argument("--device", default=None, help="default cuda; cpu only when given")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    with torch.no_grad():
        for row in (bench_synthetic(args.n_bodies, dev), bench_path(args.n_bodies, dev)):
            row["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
