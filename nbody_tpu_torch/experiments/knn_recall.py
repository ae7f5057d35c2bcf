"""Measured recall and time of the large-N neighbour searches — the port of
``nbody_tpu/experiments/knn_recall.py``, on the galaxy initial conditions:

- ``exact``: the streamed O(N^2) top-k (``ops/knn.py``), the ground truth
  and its cost;
- ``morton(W=w)``: the space-filling-curve search, ``impl="dense"``;
- ``morton-kernel(B=b)``: the same search on B7 + B8 (``impl="kernel"``;
  their plain versions on the CPU), the JAX rows ``morton-pallas``.

The JAX script's ``approx`` row times ``lax.approx_max_k``, a selection that
exists only on the TPU: the port has no such search and prints no such row.

Usage::

    python -m nbody_tpu_torch.experiments.knn_recall \\
        --n-bodies 20000 100000 --out results/large_scale/knn_recall.json

Each row: ``profile``, ``n``, ``k``, ``method``, ``seconds`` (a second call
after a warm one: CUDA events on the card, a host timer on the CPU) and
``recall`` against the exact search. ``--device`` defaults to cuda; the CPU
only as ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_disk, generate_spiral
from nbody_tpu_torch.ops.knn import knn_neighbors
from nbody_tpu_torch.ops.spatial import knn_morton
from nbody_tpu_torch.utils.timing import cuda_time_ms, device_time

_PROFILES = {"disk": generate_disk, "spiral": generate_spiral}


def recall_of(idx_a, valid_a, idx_e, valid_e) -> float:
    """Fraction of the exact neighbour slots that the other search found."""
    big = idx_e.shape[0] + 1  # never an id: marks invalid slots
    a = torch.where(valid_a, idx_a.long(), big)
    e = torch.where(valid_e, idx_e.long(), -1)
    hits = (a[:, :, None] == e[:, None, :]).any(1).sum()
    return float(hits) / max(float(valid_e.sum()), 1.0)


def _timed(fn, dev):
    """(result, seconds) of a call after a warm one."""
    out = fn()
    if dev.type == "cuda":
        return out, cuda_time_ms(fn, reps=1, warmup=0) / 1e3
    return device_time(fn, dev)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+", default=[20_000, 100_000])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--windows", type=int, nargs="+", default=[64, 96, 128],
                   help="half-windows of the dense Morton search")
    p.add_argument("--kernel-blocks", type=int, nargs="+", default=[128, 256],
                   help="block sizes of the kernel Morton search")
    p.add_argument("--kernel-copies", type=int, nargs="+", default=[4],
                   help="curve-copy counts of the kernel Morton search")
    p.add_argument("--profiles", nargs="+", default=["disk", "spiral"])
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--out", default=None, help="JSON artifact path")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []

    def record(profile, n, method, seconds, recall):
        rows.append({"profile": profile, "n": n, "k": args.k, "method": method,
                     "seconds": seconds, "recall": recall})
        print(json.dumps(rows[-1]), flush=True)

    for profile in args.profiles:
        for n in args.n_bodies:
            pos, _, _ = _PROFILES[profile](torch.Generator().manual_seed(7), n, device=dev)
            exact, t_exact = _timed(lambda: knn_neighbors(pos, args.k), dev)
            record(profile, n, "exact", t_exact, 1.0)
            for w in args.windows:
                got, t = _timed(lambda w=w: knn_morton(pos, args.k, window=w), dev)
                record(profile, n, f"morton(W={w})", t, recall_of(*got, *exact))
            for b in args.kernel_blocks:
                for nc in args.kernel_copies:
                    got, t = _timed(lambda b=b, nc=nc: knn_morton(
                        pos, args.k, block=b, n_copies=nc, impl="kernel"), dev)
                    tag = f"B={b}" if nc == 4 else f"B={b},C={nc}"
                    record(profile, n, f"morton-kernel({tag})", t, recall_of(*got, *exact))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "device": "gpu" if dev.type == "cuda" else dev.type,
                "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "methodology": "one call after a warm one; CUDA events on the card, "
                               "a synchronised host timer on the CPU",
                "rows": rows,
            }, f, indent=1)
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
