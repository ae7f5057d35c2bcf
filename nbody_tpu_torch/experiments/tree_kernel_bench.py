"""B9, B10 and B1's near list at the treecodes' path shapes: milliseconds
between CUDA events around the wrapper, and the kernel's own device
milliseconds from the profiler; then one force evaluation of each engine.

    python -m nbody_tpu_torch.experiments.tree_kernel_bench [--reps 10] [--out rows.json]
    python -m nbody_tpu_torch.experiments.tree_kernel_bench --only bh2_10m --reps 3

Shapes, on seeded spirals and their partitions as the engines build them:

- bh at 100,000 bodies (M = 32, B = 256): B9 over the 391 block rows, B10's
  near subtraction (391 groups x 256 receivers x 32 rows), B1's near list
  (391 x 256 x 32 blocks of 256);
- bh3 at 1,000,000 bodies (B = 128, C = 16, rc = 48, Bs = 32, K = 48): B9
  over the 489 superblocks, B10's refinement (489 x 2048 x 768), coarse
  subtraction (489 x 2048 x 48), near subtraction (7,813 x 128 x 32) and
  sub-block multipoles (7,813 x 128 x 80), B1's near list (7,813 x 128 x 48
  sub-blocks of 32).

- bh2 at 10,000,000 bodies (``results/large_scale/bh2_10m_b512.json``: M =
  16, B = 512, C = 16, rc = 48): B9 over the 1,221 superblocks, B10's
  refinement (1,221 x 8,192 x 768), coarse subtraction (1,221 x 8,192 x 48)
  and near subtraction (19,536 x 512 x 16), B1's near list (19,536 x 512 x
  16 blocks of 512);
- bh3 at 10,000,000 bodies (``bh3_10m_tier_rc96.json``: M = 48, B = 512, C
  = 16, rc = 96, Bs = 32, K = 64): the same five B10 and B9 shapes as at 1M
  and B1's near list (19,536 x 512 x 64 sub-blocks of 32).

The 10M shape sets (``--only bh2_10m`` or ``bh3_10m``; not run by default)
also time each kernel's plain version once (``twin_ms``, CUDA events) and
add a partition row: the ms of one ``build_*_partition`` (events, after one
warm-up build) and its peak bytes above the memory held before it
(``torch.cuda.max_memory_allocated``), the number that sets whether a 10M
rollout fits beside its trajectory chunks.

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
from nbody_tpu_torch.utils import prng

G, EPS = 4.5e-6, 0.05
BH = dict(n_near=32, block=256)
BH3 = dict(n_near=32, block=128, coarse=16, rc=48, sub_block=32, n_sub=48)
# the 10M artifacts' knobs (results/large_scale/bh2_10m_b512.json, bh3_10m_tier_rc96.json)
BH2_10M = dict(n_near=16, block=512, coarse=16, rc=48)
BH3_10M = dict(n_near=48, block=512, coarse=16, rc=96, sub_block=32, n_sub=64)
# a substring of each kernel's name, as the profiler reports it
KERNEL_NAMES = {"B9": "multipole_far", "B10": "multipole_grouped", "B1n": "near_force"}


def _spiral(n: int, seed: int):
    pos, _, mass = generate_spiral(prng.PRNGKey(seed), n,
                                   device=torch.device("cuda"))
    return pos, mass


def _table(spos, sm, rows):
    nb = spos.shape[0] // rows
    bp, _, msum, com, quad = tf._block_moments(spos, sm, nb, rows)
    return bp.contiguous(), tf._blk_rows(com, msum, quad)


def time_kernel(kernel: str, shape: str, fn, pairs: float, nbytes: float, reps: int,
                twin=None) -> dict:
    """One row: ``fn`` (a wrapper call) timed between events and under the
    profiler; ``nbytes`` its inputs read once and its output written once;
    ``twin``, the same call of the plain version, timed once."""
    ms = cuda_time_ms(fn, reps=reps, warmup=2)
    events = [t for _, t in kernel_events(fn, reps, name=KERNEL_NAMES[kernel])]
    flops = (45.0 if kernel in ("B9", "B10") else 20.0) * pairs
    bound, by = bound_ms(flops, nbytes)
    row = {"kernel": kernel, "shape": shape, "ms": ms,
           "device_ms": sum(events) / max(len(events), 1), "events": len(events),
           "reps": reps, "pairs": pairs, "bound_ms": bound, "bound_by": by}
    if twin is not None:
        row["twin_ms"] = cuda_time_ms(twin, reps=1, warmup=0)
    return row


def partition_row(label: str, build, reps: int) -> dict:
    """ms of one partition build (events, after one warm-up build) and its
    peak bytes above the memory allocated before it."""
    ms = cuda_time_ms(build, reps=reps, warmup=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"partition": label, "ms": ms, "reps": reps, "peak_bytes": peak,
            "peak_gib": peak / 2 ** 30}


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


def two_level_rows(label: str, engine: str, n: int, seed: int, knobs: dict, reps: int,
                   twins: bool = False) -> list:
    """B9 over the superblocks, B10's refinement, coarse and near
    subtraction (and bh3's sub-block multipoles), B1's near list, one force
    evaluation; with ``twins`` each kernel's plain version timed once and a
    partition row."""
    pos, mass = _spiral(n, seed)
    build = getattr(tf, f"build_{engine}_partition")
    part = build(pos, mass, **knobs)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b, c = knobs["block"], knobs["coarse"]
    q_blocks, table_f = _table(spos, sm, b)
    _, table_c = _table(spos, sm, b * c)
    p, (nbc, rc) = spos.shape[0], part.refined.shape
    nb = part.n_blocks
    fine_ids = (part.refined[:, :, None] * c + torch.arange(
        c, dtype=torch.int32, device=spos.device)).reshape(nbc, rc * c).contiguous()
    qg = spos.reshape(nbc, c * b, 3)
    eps2 = EPS ** 2

    def pair(fn, plain, *args):
        return (lambda: fn(*args, G, eps2)), (lambda: plain(*args, G, eps2)) if twins else None

    def b10(shape, q, table, ids):
        call, twin = pair(tf.grouped_multipole_acc, tf.grouped_multipole_acc_torch, q, table,
                          ids)
        return time_kernel("B10", f"{label} {engine} {shape}: {ids.shape[0]} x {q.shape[1]} x "
                           f"{ids.shape[1]}", call, p * ids.shape[1],
                           24.0 * p + 40.0 * table.shape[0] + 4.0 * ids.numel(), reps, twin)

    call, twin = pair(tf.multipole_acc, tf.multipole_acc_torch, spos, table_c)
    rows = [
        time_kernel("B9", f"{label} {engine} far field: {p} x {nbc}", call, p * nbc,
                    24.0 * p + 40.0 * nbc, reps, twin),
        b10("refinement", qg, table_f, fine_ids),
        b10("coarse subtraction", qg, table_c, part.refined),
        b10("near subtraction", q_blocks, table_f, part.near),
    ]
    if engine == "bh3":
        bs = knobs["sub_block"]
        _, table_s = _table(spos, sm, bs)
        rows.append(b10("sub-block multipoles", q_blocks, table_s, part.sub_far))
        near, src_block, what = part.sub_near, bs, "sub-blocks"
    else:
        near, src_block, what = part.near, b, "blocks"
    kk = near.shape[1]
    rows.append(time_kernel(
        "B1n", f"{label} {engine} near list: {nb} x {b} x {kk} {what} of {src_block}",
        lambda: pw.near_accelerations(q_blocks, spos, sm, near, src_block, G, EPS),
        p * kk * src_block, 40.0 * p + 4.0 * nb * kk, reps,
        (lambda: pw.near_accelerations_torch(q_blocks, spos, sm, near, src_block, G, EPS))
        if twins else None))
    accel = getattr(tf, f"{engine}_accelerations")
    rows.append(engine_row(f"{engine} {label}",
                           lambda: accel(pos, mass, G, EPS, partition=part), reps))
    if twins:
        del part, spos, sm, q_blocks, table_f, table_c, fine_ids, qg
        rows.append(partition_row(f"{engine} {label}", lambda: build(pos, mass, **knobs), reps))
    return rows


def bh3_rows(reps: int) -> list:
    return two_level_rows("1M", "bh3", 1_000_000, 1_000_009, BH3, reps)


def bh2_10m_rows(reps: int) -> list:
    return two_level_rows("10M", "bh2", 10_000_000, 10_000_009, BH2_10M, reps, twins=True)


def bh3_10m_rows(reps: int) -> list:
    return two_level_rows("10M", "bh3", 10_000_000, 10_000_019, BH3_10M, reps,
                          twins=True)


SHAPES = {"bh": bh_rows, "bh3": bh3_rows, "bh2_10m": bh2_10m_rows, "bh3_10m": bh3_10m_rows}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", choices=list(SHAPES), default=None,
                   help="one shape set; default: bh and bh3")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tree_kernel_bench times CUDA kernels; no CUDA device")
    tf.load_kernels()
    rows = []
    for name, fn in SHAPES.items():
        if args.only == name or (args.only is None and name in ("bh", "bh3")):
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
