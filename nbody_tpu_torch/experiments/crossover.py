"""Direct-sum vs treecode vs surrogate crossover sweep — the port of
``nbody_tpu/experiments/crossover.py``: per body count, the time of one step
of the direct-sum leapfrog rollout (B1), of the treecode rollouts (bh, bh2,
bh3) and of the GNN surrogate rollout (Morton kNN rebuilt on the device plus
the fused EdgeConv forward), each a multi-step run timed after a warm one.

Usage::

    python -m nbody_tpu_torch.experiments.crossover \\
        --n-bodies 10000 20000 50000 100000 \\
        --out results/large_scale/crossover.json
    python -m nbody_tpu_torch.experiments.crossover --n-bodies 1000000 \\
        --only direct bh3 surrogate --neighbors 8 \\
        --load-params results/large_scale/train_1m_params.pt

Flags and rows (``n``, ``mode``, ``ms_per_step``, ``psteps_per_s`` and, for
the surrogate, ``params``) are the JAX script's, and so is the rule for an
existing ``--out`` file: its rows are kept, rows of the same (n, mode) are
replaced, and a file measured at another ``--steps`` is refused under
``--only`` and started over otherwise. What differs in the port:

- ``--device`` (default cuda; the CPU only as ``--device cpu``), and
  ``device`` / ``device_kind`` in the artifact;
- each row's ``finite``: the timed run's final positions are all finite;
- ``--knn-impl`` takes ``dense`` or ``kernel`` (the JAX ``xla`` / ``pallas``)
  and defaults to ``kernel`` (B7 + B8) on a CUDA device;
- ``--load-params`` reads a ``state_dict`` written by ``torch.save`` (the
  port's ``train_large`` writes one), not a msgpack.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.train.rollout import autoregressive_rollout
from nbody_tpu_torch.utils.timing import device_time
from nbody_tpu_torch.utils import prng

G, EPS, DT = 4.5e-6, 0.05, 1e-4
MODES = ["direct", "surrogate", "bh", "bh2", "bh3"]


def _timed(fn, dev) -> tuple:
    """(seconds of a second run of ``fn``, whether that run's final positions
    are all finite); the first run warms the allocator, the library handles
    and any kernel build. ``fn`` returns its positions, steps first."""
    fn()
    pos, seconds = device_time(fn, dev)
    return seconds, bool(torch.isfinite(pos[-1]).all())


def _norm(mode: str) -> str:
    """A mode tag without its kNN impl, so that a rerun with another
    ``--knn-impl`` replaces the older rows instead of adding a series."""
    return mode.replace("kernel,", "").replace("dense,", "")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+",
                   default=[10_000, 20_000, 50_000, 100_000])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--graph-refresh", type=int, nargs="+", default=[1, 8])
    p.add_argument("--knn-impl", default=None, choices=["dense", "kernel"],
                   help="Morton search implementation; default kernel on a CUDA "
                        "device, dense otherwise")
    p.add_argument("--knn-copies", type=int, default=4,
                   help="Morton curve copies (speed/recall tradeoff)")
    p.add_argument("--knn-block", type=int, default=256,
                   help="Morton block rows (the kernel's window == block)")
    p.add_argument("--no-fused", action="store_true",
                   help="disable the restructured EdgeConv forward")
    p.add_argument("--bh", action="store_true",
                   help="also time a Barnes-Hut rollout (force_backend='bh', "
                        "bh_refresh=8)")
    p.add_argument("--bh2", action="store_true",
                   help="also time the two-level engine (1M recipe: B=128, C=16, "
                        "rc=48, refresh=8)")
    p.add_argument("--bh3", action="store_true",
                   help="also time the sub-refined (near-list) engine")
    p.add_argument("--bh-near", type=int, default=32)
    p.add_argument("--rc", type=int, default=48)
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: exact sub-blocks per receiver block")
    p.add_argument("--load-params", default=None,
                   help="time the GNN surrogate with these trained weights (a "
                        "state_dict file from train_large) instead of a seeded "
                        "random init; rows record which model was timed")
    p.add_argument("--only", nargs="+", default=None, choices=MODES,
                   help="restrict to these modes (e.g. --only bh to extend an "
                        "existing artifact one mode at a time)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--out", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    knn_impl = args.knn_impl or ("kernel" if dev.type == "cuda" else "dense")
    modes = set(args.only or ["direct", "surrogate"]
                + [m for m in ("bh", "bh2", "bh3") if getattr(args, m)])
    rows = []

    # An existing artifact is loaded once, up front, so that the rewrite
    # after every row merges against it: a sweep cut short never shrinks it.
    old_rows = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        if old.get("steps") != args.steps:
            if args.only:
                raise SystemExit(
                    f"{args.out} was measured with steps={old.get('steps')}; "
                    f"rerun with --steps {old.get('steps')} or a fresh --out "
                    "(mixing run lengths in one artifact is misleading)")
            # a full sweep at a new length starts the artifact over
        else:
            old_rows = old["rows"]

    def record(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not args.out:
            return
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        fresh = {(r["n"], _norm(r["mode"])) for r in rows}
        merged = [r for r in old_rows if (r["n"], _norm(r["mode"])) not in fresh] + rows
        merged.sort(key=lambda r: (r["n"], r["mode"]))
        with open(args.out, "w") as f:
            json.dump({"device": "gpu" if dev.type == "cuda" else dev.type,
                       "device_kind": (torch.cuda.get_device_name(dev)
                                       if dev.type == "cuda" else "cpu"),
                       "steps": args.steps, "rows": merged}, f, indent=1)

    two_level = dict(bh_near=args.bh_near, bh_block=128, bh_coarse=16, bh_rc=args.rc,
                     bh_refresh=8)
    engines = {
        "direct": ("direct", dict(force_backend="kernel")),
        "bh": (f"bh(M={args.bh_near},refresh=8)",
               dict(force_backend="bh", bh_near=args.bh_near, bh_refresh=8)),
        "bh2": (f"bh2(M={args.bh_near},B=128,rc={args.rc},refresh=8)",
                dict(force_backend="bh2", **two_level)),
        "bh3": (f"bh3(M={args.bh_near},B=128,rc={args.rc},K={args.n_sub},refresh=8)",
                dict(force_backend="bh3", bh_sub_block=32, bh_n_sub=args.n_sub, **two_level)),
    }
    for n in args.n_bodies:
        pos, vel, mass = generate_spiral(prng.PRNGKey(0), n, device=dev)
        for mode, (tag, knobs) in engines.items():
            if mode not in modes:
                continue
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, calc_energy=False, **knobs)
            el, finite = _timed(lambda: simulate(pos, vel, mass, args.steps, cfg).positions,
                                dev)
            record({"n": n, "mode": tag, "ms_per_step": el / args.steps * 1e3,
                    "psteps_per_s": n * args.steps / el, "finite": finite})

        if "surrogate" not in modes:
            continue
        model = GraphModel(
            input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
            neighbors=args.neighbors, scale_factor=1e6, knn_method="morton",
            knn_impl=knn_impl, knn_copies=args.knn_copies, knn_block=args.knn_block,
            fused_edgeconv=not args.no_fused,
            key=prng.PRNGKey(1))  # the JAX script's init key
        if args.load_params:
            model.load_state_dict(torch.load(args.load_params, map_location="cpu",
                                             weights_only=True))
            params_tag = args.load_params
        else:
            params_tag = "random-init (timing-only; params-independent)"
        model.to(dev).eval()
        impl_tag = f"{args.knn_impl}," if args.knn_impl else ""
        for r in args.graph_refresh:
            el, finite = _timed(lambda r=r: autoregressive_rollout(
                model, pos, vel, mass, args.steps + 1, DT, graph_refresh=r)[0], dev)
            record({"n": n, "mode": f"surrogate({impl_tag}refresh={r})",
                    "ms_per_step": el / args.steps * 1e3,
                    "psteps_per_s": n * args.steps / el, "finite": finite,
                    "params": params_tag})

    if args.out:
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
