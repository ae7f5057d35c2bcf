"""Large-N demo and benchmark — the port of
``nbody_tpu/experiments/large_scale.py``: a direct-sum rollout against a
surrogate rollout at 100k bodies.

- ``direct``: the direct-sum leapfrog rollout on the B1 force kernel
  (``force_backend="kernel"``, no energies): exact physics at O(N^2).
- ``surrogate``: a force surrogate rolled out autoregressively, O(N k) per
  step once its neighbour graph is built: the EdgeConv ``GraphModel``
  (``--model gnn``, Morton kNN by default) or the reference-configuration
  ``ContinuousConvModel`` (``--model contconv``, Morton radius search).
- ``hybrid``: direct sum for ``--hybrid-warmup`` steps, then the surrogate.

Usage::

    python -m nbody_tpu_torch.experiments.large_scale --n-bodies 100000 \\
        --steps 20 --model contconv
    python -m nbody_tpu_torch.experiments.large_scale --n-bodies 600 \\
        --steps 3 --device cpu

The surrogates carry seeded random weights (a speed demo, as in the JAX
script without ``--weights``). Prints one JSON line per mode with the JAX
script's keys: wall seconds (synchronised host timer, after one warm-up
run), particle-steps per second and, for the surrogate when the direct
rollout ran too, the RMS final-position distance from the direct sum; and
``finite``, whether the timed run's final positions are all finite.
On a CUDA device ``--knn-impl`` and ``--conv-impl`` default to ``kernel``
(B7 + B8, B3), as the JAX script picks its Pallas search on a TPU;
``dense`` picks the plain-torch paths. ``--profile`` adds, per mode, the
busy seconds of one more run under ``torch.profiler`` (kernel rows only on
the card), the idle share ``1 - busy / seconds`` and the largest rows.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import ContinuousConvModel, GraphModel
from nbody_tpu_torch.train.rollout import autoregressive_rollout
from nbody_tpu_torch.utils.timing import device_time, profile_ms
from nbody_tpu_torch.utils import prng

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def build_model(args, key: torch.Tensor):
    """The surrogate of ``--model`` with the JAX package's ``model.init(key)``
    weights (``utils.prng`` key; drawn on the key's device)."""
    if args.model == "contconv":
        # reference ContConv recipe (configs/contconv_adopted.json widths)
        # with the Morton radius search for large N
        return ContinuousConvModel(
            in_channels=4, out_channels=3, filter_resolution=(6, 4),
            radius=1.0, agg="mean", self_loops=True,
            continuous_conv_layers=2, continuous_conv_dim=128,
            encoder_hiddens=(32, 64), decoder_hiddens=(64, 32),
            scale_factor=1e6, radius_method="morton",
            radius_impl=args.knn_impl, conv_impl=args.conv_impl, key=key)
    return GraphModel(
        input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
        neighbors=args.neighbors, scale_factor=1e6,
        knn_method=args.knn_method, knn_window=args.knn_window,
        knn_impl=args.knn_impl, key=key)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--hybrid-warmup", type=int, default=5)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--model", default="gnn", choices=["gnn", "contconv"],
                   help="surrogate family: gnn (GraphModel) or contconv "
                        "(reference-config ContinuousConvModel, Morton "
                        "radius search)")
    p.add_argument("--conv-impl", default=None, choices=["dense", "kernel"],
                   help="contconv collect: dense (plain torch) or kernel (the "
                        "B3 CUDA kernel); default kernel on a CUDA device, "
                        "dense otherwise")
    p.add_argument("--modes", nargs="+", default=["direct", "surrogate", "hybrid"])
    p.add_argument("--knn-method", default="morton",
                   choices=["exact", "approx", "morton"],
                   help="GNN neighbour search (approx: lax.approx_max_k as XLA "
                        "computes it off the TPU, the exact selection)")
    p.add_argument("--knn-window", type=int, default=64)
    p.add_argument("--knn-impl", default=None, choices=["dense", "kernel"],
                   help="Morton search implementation; default kernel on a "
                        "CUDA device, dense otherwise")
    p.add_argument("--graph-refresh", type=int, default=1,
                   help="rebuild the surrogate's neighbour graph every this "
                        "many steps (1 = every step, reference parity)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--out", default=None, help="JSON artifact path")
    p.add_argument("--profile", action="store_true",
                   help="profile one more run of each mode with torch.profiler "
                        "and add its busy seconds, idle share and largest rows "
                        "to the mode's line")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    n, steps = args.n_bodies, args.steps
    default_impl = "kernel" if dev.type == "cuda" else "dense"
    args.knn_impl = args.knn_impl or default_impl
    args.conv_impl = args.conv_impl or default_impl
    pos, vel, mass = generate_spiral(prng.PRNGKey(0), n, device=dev)
    # the JAX script's init key (nbody_tpu/experiments/large_scale.py:98)
    model = build_model(args, prng.PRNGKey(1, dev)).to(dev).eval()
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, integrator="leapfrog",
                           calc_energy=False, force_backend="kernel")

    def run_direct():
        return simulate(pos, vel, mass, steps, cfg).positions[-1]

    def run_surrogate():
        # steps + 1 rows = `steps` updates (row 0 is the seed state), as
        # simulate() makes `steps` updates
        return autoregressive_rollout(model, pos, vel, mass, steps + 1, DT,
                                      graph_refresh=args.graph_refresh)[0][-1]

    def run_hybrid():
        w = args.hybrid_warmup
        t = simulate(pos, vel, mass, w, cfg)
        return autoregressive_rollout(model, t.positions[-1], t.velocities[-1],
                                      mass, steps - w + 1, DT)[0][-1]

    runs = {"direct": run_direct, "surrogate": run_surrogate, "hybrid": run_hybrid}
    if args.hybrid_warmup >= steps:
        del runs["hybrid"]
    results, finals = {}, {}
    for mode in [m for m in runs if m in args.modes]:
        runs[mode]()  # warm-up
        finals[mode], el = device_time(runs[mode], dev)
        r = results[mode] = {"seconds": el, "psteps_per_s": n * steps / el,
                             "finite": bool(torch.isfinite(finals[mode]).all())}
        if mode == "surrogate":
            r["graph_refresh"] = args.graph_refresh
            if "direct" in finals:
                r["final_pos_rmse_vs_direct"] = float(
                    torch.sqrt(((finals[mode] - finals["direct"]) ** 2).mean()))
        if args.profile:
            busy_ms, top = profile_ms(runs[mode], dev)
            r.update(busy_seconds=busy_ms / 1e3, idle_share=1.0 - busy_ms / 1e3 / el,
                     top_ms=top)

    for mode, r in results.items():
        print(json.dumps({"mode": mode, "n_bodies": n, "steps": steps, **r}), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"n_bodies": n, "steps": steps, "model": args.model,
                       "knn_method": args.knn_method, "knn_window": args.knn_window,
                       "knn_impl": args.knn_impl, "conv_impl": args.conv_impl,
                       "device": dev.type, "results": results}, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
