"""B9, B10 and B1's near list at the treecodes' path shapes: milliseconds
between CUDA events around the wrapper, and the kernel's own device
milliseconds from the profiler; then one force evaluation of each engine.

    python -m nbody_tpu_torch.experiments.tree_kernel_bench [--reps 10] [--out rows.json]

Shapes, on seeded spirals and their partitions as the engines build them:

- bh at 100,000 bodies (M = 32, B = 256): B9 over the 391 block rows, B10's
  near subtraction (391 groups x 256 receivers x 32 rows), B1's near list
  (391 x 256 x 32 blocks of 256);
- bh3 at 1,000,000 bodies (B = 128, C = 16, rc = 48, Bs = 32, K = 48): B9
  over the 489 superblocks, B10's refinement (489 x 2048 x 768), coarse
  subtraction (489 x 2048 x 48), near subtraction (7,813 x 128 x 32) and
  sub-block multipoles (7,813 x 128 x 80), B1's near list (7,813 x 128 x 48
  sub-blocks of 32).

A row holds ``ms`` (events around ``--reps`` wrapper calls, host work
included), ``device_ms`` (the kernel's events from
:func:`nbody_tpu_torch.utils.timing.kernel_events`, summed and divided by
their count), ``events``, ``pairs`` and ``bound_ms`` / ``bound_by``
(:func:`nbody_tpu_torch.utils.timing.bound_ms`: 45 flops a (receiver,
row) pair for B9 and B10, 20 a pair for the near list, and the bytes of
receivers, rows and ids read once and the forces written once, as
``chip_smoke.py`` phase 9a counts them). An engine row
holds the device ms of one force evaluation on a reused partition (every
kernel event of ``--reps`` evaluations, over ``--reps``) and each of the
three kernels' share of it. One JSON line a row. The card only. It uses
only the wrappers' names and the partitions, so it runs unchanged from an
older checkout, for an A/B in one call.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops import treeforce as tf
from nbody_tpu_torch.utils.timing import bound_ms, cuda_time_ms, kernel_events

G, EPS = 4.5e-6, 0.05
BH = dict(n_near=32, block=256)
BH3 = dict(n_near=32, block=128, coarse=16, rc=48, sub_block=32, n_sub=48)
# a substring of each kernel's name, as the profiler reports it
KERNEL_NAMES = {"B9": "multipole_far", "B10": "multipole_grouped", "B1n": "near_force"}


def _spiral(n: int, seed: int):
    pos, _, mass = generate_spiral(torch.Generator().manual_seed(seed), n,
                                   device=torch.device("cuda"))
    return pos, mass


def _table(spos, sm, rows):
    nb = spos.shape[0] // rows
    bp, _, msum, com, quad = tf._block_moments(spos, sm, nb, rows)
    return bp.contiguous(), tf._blk_rows(com, msum, quad)


def time_kernel(kernel: str, shape: str, fn, pairs: float, nbytes: float, reps: int) -> dict:
    """One row: ``fn`` (a wrapper call) timed between events and under the
    profiler; ``nbytes`` its inputs read once and its output written once."""
    ms = cuda_time_ms(fn, reps=reps, warmup=2)
    events = [t for _, t in kernel_events(fn, reps, name=KERNEL_NAMES[kernel])]
    flops = (45.0 if kernel in ("B9", "B10") else 20.0) * pairs
    bound, by = bound_ms(flops, nbytes)
    return {"kernel": kernel, "shape": shape, "ms": ms,
            "device_ms": sum(events) / max(len(events), 1), "events": len(events),
            "reps": reps, "pairs": pairs, "bound_ms": bound, "bound_by": by}


def engine_row(name: str, fn, reps: int) -> dict:
    """Device ms of one force evaluation and each kernel's part of it."""
    events = kernel_events(fn, reps)
    parts = {k: sum(t for n, t in events if sub in n) / reps for k, sub in KERNEL_NAMES.items()}
    return {"engine": name, "device_ms": sum(t for _, t in events) / reps,
            "events_per_call": len(events) / reps, "reps": reps,
            **{f"{k}_ms": v for k, v in parts.items()}}


def bh_rows(reps: int) -> list:
    pos, mass = _spiral(100_000, 100_009)
    part = tf.build_bh_partition(pos, mass, **BH)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b = BH["block"]
    q_blocks, table = _table(spos, sm, b)
    (nb, m), p, k = part.near.shape, spos.shape[0], table.shape[0]
    eps2 = EPS ** 2
    rows = [
        time_kernel("B9", f"100k bh far field: {p} x {k}",
                    lambda: tf.multipole_acc(spos, table, G, eps2), p * k,
                    24.0 * p + 40.0 * k, reps),
        time_kernel("B10", f"100k bh near subtraction: {nb} x {b} x {m}",
                    lambda: tf.grouped_multipole_acc(q_blocks, table, part.near, G, eps2),
                    p * m, 24.0 * p + 40.0 * k + 4.0 * nb * m, reps),
        time_kernel("B1n", f"100k bh near list: {nb} x {b} x {m} blocks of {b}",
                    lambda: pw.near_accelerations(q_blocks, spos, sm, part.near, b, G, EPS),
                    p * m * b, 40.0 * p + 4.0 * nb * m, reps),
        engine_row("bh 100k", lambda: tf.bh_accelerations(pos, mass, G, EPS, partition=part),
                   reps),
    ]
    return rows


def bh3_rows(reps: int) -> list:
    pos, mass = _spiral(1_000_000, 1_000_009)
    part = tf.build_bh3_partition(pos, mass, **BH3)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b, c, bs = BH3["block"], BH3["coarse"], BH3["sub_block"]
    q_blocks, table_f = _table(spos, sm, b)
    _, table_c = _table(spos, sm, b * c)
    _, table_s = _table(spos, sm, bs)
    p, (nbc, rc) = spos.shape[0], part.refined.shape
    nb, kk = part.sub_near.shape
    u = part.sub_far.shape[1]
    fine_ids = (part.refined[:, :, None] * c + torch.arange(
        c, dtype=torch.int32, device=spos.device)).reshape(nbc, rc * c).contiguous()
    qg = spos.reshape(nbc, c * b, 3)
    eps2 = EPS ** 2
    rows = [
        time_kernel("B9", f"1M bh3 far field: {p} x {nbc}",
                    lambda: tf.multipole_acc(spos, table_c, G, eps2), p * nbc,
                    24.0 * p + 40.0 * nbc, reps),
        time_kernel("B10", f"1M bh3 refinement: {nbc} x {c * b} x {rc * c}",
                    lambda: tf.grouped_multipole_acc(qg, table_f, fine_ids, G, eps2),
                    p * rc * c, 24.0 * p + 40.0 * nb + 4.0 * fine_ids.numel(), reps),
        time_kernel("B10", f"1M bh3 coarse subtraction: {nbc} x {c * b} x {rc}",
                    lambda: tf.grouped_multipole_acc(qg, table_c, part.refined, G, eps2),
                    p * rc, 24.0 * p + 40.0 * nbc + 4.0 * part.refined.numel(), reps),
        time_kernel("B10", f"1M bh3 near subtraction: {nb} x {b} x {part.near.shape[1]}",
                    lambda: tf.grouped_multipole_acc(q_blocks, table_f, part.near, G, eps2),
                    p * part.near.shape[1], 24.0 * p + 40.0 * nb + 4.0 * part.near.numel(), reps),
        time_kernel("B10", f"1M bh3 sub-block multipoles: {nb} x {b} x {u}",
                    lambda: tf.grouped_multipole_acc(q_blocks, table_s, part.sub_far, G, eps2),
                    p * u, 24.0 * p + 40.0 * table_s.shape[0] + 4.0 * nb * u, reps),
        time_kernel("B1n", f"1M bh3 near list: {nb} x {b} x {kk} sub-blocks of {bs}",
                    lambda: pw.near_accelerations(q_blocks, spos, sm, part.sub_near, bs, G,
                                                  EPS),
                    p * kk * bs, 40.0 * p + 4.0 * nb * kk, reps),
        engine_row("bh3 1M", lambda: tf.bh3_accelerations(pos, mass, G, EPS, partition=part),
                   reps),
    ]
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", choices=["bh", "bh3"], default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tree_kernel_bench times CUDA kernels; no CUDA device")
    tf.load_kernels()
    rows = []
    for name, fn in (("bh", bh_rows), ("bh3", bh3_rows)):
        if args.only in (None, name):
            for row in fn(args.reps):
                row["device_kind"] = torch.cuda.get_device_name(0)
                print(json.dumps(row), flush=True)
                rows.append(row)
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
