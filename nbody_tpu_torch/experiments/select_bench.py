"""Times B7 (the Morton select, ``ops.spatial.morton_select``) and B8 (the
merge) on spiral bodies, and the whole ``knn_morton(impl="kernel")`` search
around them:

    python -m nbody_tpu_torch.experiments.select_bench --n-bodies 100000 1000000 \\
        --cases 8 10 32:self

It is the tool for A/B runs of B7: run it from two checkouts on one card in
one session, in the order A, B, B, A. It uses only what every version of
the port has (``_curve_order``, ``_candidates``, ``_to_rows``, the two
wrappers and ``utils.timing.cuda_time_ms``), so a copy of this file placed
in an older checkout times that one. It checks nothing: the card tests and
``chip_smoke.py`` hold both kernels to their plain versions.

A case ``K`` is k = K without self edges (the GNN graphs: k = 8 at 1M, 10 in
the recipe); ``K:self`` with them (the radius search's k = 32). Per N and
case it prints one JSON row: B7's and B8's milliseconds (CUDA events, the
mean of ``--reps`` calls after a warm-up), B7's host microseconds a call
(the time ``--reps`` calls take to return, before the card has finished:
what a host-bound loop pays for the launch), their bounds
(``utils.timing``'s peaks: B7 9 operations a (query, candidate), B8 2 k a
candidate), and the whole search's milliseconds. ``--device cpu`` gives
the bounds and times nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import spatial as sp
from nbody_tpu_torch.utils import timing

BLOCK, COPIES = 256, 4  # knn_morton's defaults


def parse_case(text: str):
    """``"K"`` -> (K, False); ``"K:self"`` -> (K, True)."""
    k, _, flag = text.partition(":")
    if flag not in ("", "self"):
        raise ValueError(f"case {text!r}: K or K:self")
    return int(k), flag == "self"


def bench(n: int, k: int, include_self: bool, dev: torch.device, reps: int) -> dict:
    pos, _, _ = generate_spiral(torch.Generator().manual_seed(n + 5), n, device=dev)
    order = sp._curve_order(pos, None, COPIES)
    cand, qg = sp._candidates(pos, order, BLOCK)
    ids, d2 = sp.morton_select(cand, k, BLOCK, include_self)
    mc, md = sp._to_rows(qg, ids, d2, n)
    m_ids, _ = sp.morton_merge(mc, md, k)
    b7 = timing.bound_ms(9.0 * COPIES * ids.shape[1] * 3 * BLOCK,
                         16.0 * cand.shape[0] * cand.shape[1] + 8.0 * ids.numel())
    b8 = timing.bound_ms(2.0 * n * k * mc.shape[1], 8.0 * mc.numel() + 8.0 * m_ids.numel())
    row = {"n": n, "k": k, "include_self": include_self, "block": BLOCK, "device": str(dev),
           "b7_bound_ms": b7[0], "b7_bound_by": b7[1], "b8_bound_ms": b8[0],
           "b8_bound_by": b8[1]}
    if dev.type == "cuda":
        def select():
            return sp.morton_select(cand, k, BLOCK, include_self)

        row["b7_ms"] = timing.cuda_time_ms(select, reps=reps, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            select()
        row["b7_host_us"] = 1e6 * (time.perf_counter() - t0) / reps
        row["b8_ms"] = timing.cuda_time_ms(lambda: sp.morton_merge(mc, md, k), reps=reps,
                                           warmup=1)
        row["knn_morton_ms"] = timing.cuda_time_ms(
            lambda: sp.knn_morton(pos, k, include_self=include_self, block=BLOCK,
                                  n_copies=COPIES, impl="kernel"), reps=reps, warmup=1)
    return row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-bodies", type=int, nargs="+", default=[100_000, 1_000_000])
    p.add_argument("--cases", nargs="+", default=["8", "10", "32:self"],
                   help="K (k = K, no self edges) or K:self")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default=None, help="default cuda; cpu only when given")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for n in args.n_bodies:
        for text in args.cases:
            rows.append(bench(n, *parse_case(text), dev, args.reps))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
