"""Treecode against exact direct-sum force timing and accuracy — the port of
``nbody_tpu/experiments/treeforce_bench.py`` (``results/large_scale/bh*.json``).

For each N: the exact force (B1), the treecode force with a fresh partition
every call, the treecode force under a reused partition, the partition
build alone, and the treecode's force error against the exact force (all
receivers up to ``--error-cap``, ``--error-sample`` receivers above it).

Usage::

    python -m nbody_tpu_torch.experiments.treeforce_bench \\
        --n-bodies 20000 50000 100000 --out results/bh.json
    python -m nbody_tpu_torch.experiments.treeforce_bench --engine bh3 \\
        --n-bodies 100000 --block 128 --reps 5

The JAX script's flags and row keys, plus ``--device`` (default cuda; the
CPU only as ``--device cpu``). On the card every time is the mean over
``--reps`` back-to-back calls between CUDA events, after one warm-up call;
on the CPU a host timer over the same calls. On the card a row also holds
``peak_memory_gib`` (``torch.cuda.max_memory_allocated`` over that N's
timings and audit) and ``wall_s`` (a host timer over them).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from nbody_tpu_torch.core.simulate import SimulationConfig, treecode_fns
from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import pairwise
from nbody_tpu_torch.utils.timing import cuda_time_ms, synchronize
from nbody_tpu_torch.utils import prng

G, EPS = 4.5e-6, 0.05


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call of ``fn``: CUDA events on the card, a
    host timer on the CPU; one warm-up call first."""
    if torch.device(device).type == "cuda":
        return cuda_time_ms(fn, reps=reps, warmup=1)
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-bodies", type=int, nargs="+",
                   default=[20_000, 50_000, 100_000, 200_000])
    p.add_argument("--n-near", type=int, default=32)
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--i-chunk", type=int, default=8,
                   help="receiver blocks per step of the dense near pass (the "
                        "kernel near pass is one launch)")
    p.add_argument("--engine", default="bh", choices=["bh", "bh2", "bh3"],
                   help="bh2 = two-level coarse far field; bh3 = bh2 with the "
                        "sub-refined near pass")
    p.add_argument("--coarse", type=int, default=16,
                   help="bh2/bh3: fine blocks per superblock")
    p.add_argument("--rc", type=int, default=32,
                   help="bh2/bh3: refined superblocks per receiver group")
    p.add_argument("--sub-block", type=int, default=32,
                   help="bh3: rows per near-pass sub-block")
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: sub-blocks evaluated exactly per receiver block")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--exact-cap", type=int, default=100_000,
                   help="skip the exact timing above this N")
    p.add_argument("--error-cap", type=int, default=None,
                   help="grade every receiver against one exact evaluation up to "
                        "this N; default = exact-cap")
    p.add_argument("--error-sample", type=int, default=0,
                   help="above error-cap: grade this many sampled receivers "
                        "against an exact partial sum (O(S N))")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the spiral ICs (the JAX script's PRNGKey(0))")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from nbody_tpu_torch.ops.treeforce import load_kernels

        load_kernels()
    cfg = SimulationConfig(g_const=G, softening=EPS, force_backend=args.engine,
                           bh_near=args.n_near, bh_block=args.block, bh_coarse=args.coarse,
                           bh_rc=args.rc, bh_sub_block=args.sub_block, bh_n_sub=args.n_sub)
    keys = {**({"coarse": args.coarse, "rc": args.rc} if args.engine != "bh" else {}),
            **({"sub_block": args.sub_block, "n_sub": args.n_sub}
               if args.engine == "bh3" else {})}

    rows = []
    for n in args.n_bodies:
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        pos, _, mass = generate_spiral(prng.PRNGKey(args.seed), n,
                                       device=dev)
        build, acc = treecode_fns(mass, cfg, i_chunk=args.i_chunk)

        def force(p_, partition=None):
            return acc(p_, build(p_) if partition is None else partition)

        row = {"n": n, "n_near": args.n_near, "block": args.block, **keys, "seed": args.seed}
        error_cap = args.error_cap or args.exact_cap
        if n <= args.exact_cap:
            row["exact_ms"] = time_ms(
                lambda: pairwise.accelerations(pos, mass, G, EPS), args.reps, dev)
        part = build(pos)
        row["bh_fresh_ms"] = time_ms(lambda: force(pos), args.reps, dev)
        row["bh_reused_ms"] = time_ms(lambda: force(pos, part), args.reps, dev)
        row["partition_ms"] = time_ms(lambda: build(pos), args.reps, dev)

        exact = approx = None
        if n <= error_cap:
            exact, approx = pairwise.accelerations(pos, mass, G, EPS), force(pos)
        elif args.error_sample:
            idx = prng.choice(prng.PRNGKey(42), n, (args.error_sample,), device=dev)
            exact = pairwise.partial_accelerations(pos[idx].contiguous(), pos, mass, G, EPS)
            approx = force(pos)[idx]
            row["error_sample"] = int(idx.shape[0])
        if exact is not None:
            err = (approx - exact).norm(dim=-1).double()
            mag = exact.norm(dim=-1).double()
            rel = err / (mag + 1e-30)
            row["rel_err_median"] = float(rel.median())
            row["rel_err_p99"] = float(torch.quantile(rel, 0.99))
            row["err_over_rms_p99"] = float(
                torch.quantile(err / torch.sqrt((mag ** 2).mean()), 0.99))
            if "exact_ms" in row:
                row["speedup_fresh"] = row["exact_ms"] / row["bh_fresh_ms"]
                row["speedup_reused"] = row["exact_ms"] / row["bh_reused_ms"]
        if dev.type == "cuda":
            row["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            synchronize(dev)
            row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:  # rewritten after every row: a cut sweep keeps its rows
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": "gpu" if dev.type == "cuda" else dev.type,
                           "device_kind": (torch.cuda.get_device_name(dev)
                                           if dev.type == "cuda" else "cpu"),
                           "reps": args.reps, "rows": rows}, f, indent=1)
    if args.out:
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
