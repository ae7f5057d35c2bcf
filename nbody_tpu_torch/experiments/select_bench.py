"""Times B7 (the Morton select, ``ops.spatial.morton_select``) and B8 (the
merge) on spiral bodies, and the whole ``knn_morton(impl="kernel")`` search
around them:

    python -m nbody_tpu_torch.experiments.select_bench --n-bodies 100000 1000000 \\
        --cases 8 10 32:self

It is the tool for A/B runs of B7 and B8: run it from two checkouts on one
card, one after the other, in the order A, B, B, A. It uses only what every
version of the port has (``_curve_order``, ``_candidates``, ``_to_rows``,
the two wrappers and ``utils.timing``'s ``cuda_time_ms`` and
``kernel_events``), so a copy of this file placed in an older checkout
times that one. It checks nothing: the card tests and ``chip_smoke.py``
hold both kernels to their plain versions, also on :func:`merge_edge_rows`.

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

import numpy as np
import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import spatial as sp
from nbody_tpu_torch.utils import timing

BLOCK, COPIES = 256, 4  # knn_morton's defaults
B8_NAME = "merge"  # a substring of B8's kernel name, as the profiler reports it
_FLT_MAX = float(np.finfo(np.float32).max)


def merge_edge_rows(n: int, w: int, k: int, seed: int, inf: bool = False):
    """(cand (n, w) int32, d2 (n, w) float32): B8 inputs made from ``seed``
    with numpy that reach every case of its definition, not only B7's
    output. Each row draws a pool of unique ids (1 to 2k of them, or w:
    rows with fewer than k unique ids run out) and fills its w slots from
    it, each pool id at least once and the rest as duplicates, which carry
    their id's distance (as the curve copies do) or, in a quarter of the
    rows, one of their own. Distances include zeros, negatives and exact
    ties; half the rows keep each copy's k slots in ascending order, the
    others any order. A fifth of the rows hold sentinels (id n, d2 = the
    largest float32, as B7 gives), always in the last column, which is the
    column mask when w is a power of two: its packed key is then the mask
    value itself. Ids reach 2^31 - 1, so exhausted rows wrap their int32
    sums. ``inf`` adds infinite distances to some rows (the JAX kernel,
    whose keys are floats, takes none)."""
    rng = np.random.default_rng(seed)
    cand = np.empty((n, w), np.int32)
    d2 = np.empty((n, w), np.float32)
    sizes = np.array([1, 2, max(k // 2, 1), max(k - 1, 1), k, 2 * k, w])
    for r in range(n):
        u = int(min(rng.choice(sizes), w))
        pool = rng.permutation(np.cumsum(rng.integers(1, 1 << 13, size=u))
                               + rng.integers(1 << 20))
        if rng.random() < 0.3:
            pool[rng.integers(u)] = 2 ** 31 - 1 - rng.integers(4)
        dist = rng.exponential(size=u).astype(np.float32)
        dist[rng.random(u) < 0.1] = 0.0
        dist[rng.random(u) < 0.05] = -1e-7
        if u > 1 and rng.random() < 0.5:
            dist[1] = dist[0]  # an exact tie: broken by column
        slot = np.concatenate([rng.permutation(u), rng.integers(u, size=w - u)])[:w]
        rng.shuffle(slot)
        cand[r], d2[r] = pool[slot], dist[slot]
        if rng.random() < 0.25:
            own = rng.random(w) < 0.3
            d2[r, own] = rng.exponential(size=int(own.sum()))
        if rng.random() < 0.5:  # each copy's k slots ascending, as B7 lists them
            for c0 in range(0, w, k):
                o = np.argsort(d2[r, c0:c0 + k], kind="stable")
                cand[r, c0:c0 + k], d2[r, c0:c0 + k] = cand[r, c0 + o], d2[r, c0 + o]
        if rng.random() < 0.2:
            sent = rng.random(w) < 0.2
            sent[-1] = True
            cand[r, sent], d2[r, sent] = n, _FLT_MAX
        if inf and rng.random() < 0.1:
            d2[r, rng.random(w) < 0.2] = np.inf
    return torch.from_numpy(cand), torch.from_numpy(d2)


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

        def merge():
            return sp.morton_merge(mc, md, k)

        row["b8_ms"] = timing.cuda_time_ms(merge, reps=reps, warmup=1)
        events = [t for name, t in timing.kernel_events(merge, reps) if B8_NAME in name]
        row["b8_device_ms"] = sum(events) / max(len(events), 1)
        row["b8_events"] = len(events)
        row["to_rows_ms"] = timing.cuda_time_ms(lambda: sp._to_rows(qg, ids, d2, n),
                                                reps=reps, warmup=1)
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
