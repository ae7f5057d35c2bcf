"""Particle-sharded treecode forces and rollouts — the port of
``nbody_tpu/parallel/bh.py``.

The dominant cost of the treecodes (``ops/treeforce.py``) is the exact near
pass, and it splits by receiver block. Each rank all-gathers the particle
state (16 bytes a particle), builds or takes the replicated Morton
partition, and computes its own range of receiver blocks with
``bh*_sorted_range_acc(..., blk0, nbl)``: ``nbp = ceil(nb / n)`` blocks a
rank (bh), or ``ceil(nbc / n)`` whole coarse groups (bh2 and bh3, whose
ranges must align with superblocks). The sorted per-range results are
all-gathered (12 bytes a particle), unsorted, and each rank keeps its
shard. Moments and partitions cost O(nb) and stay replicated; what is split
is the O(N M B) near pass and the O(N nb / n) far pass.

Where the blocks do not divide evenly, the last ranges are cut short at the
last block and only their results are padded for the gather. (The JAX
package pads the sorted inputs with massless blocks instead, so its far
pass sums over a longer block table and rounds differently.) So every row
is computed as the single-rank engine computes it, over the same block
tables: with the same kernels (``near_impl="kernel"``, or ``"auto"`` on
CUDA tensors: B1's near list, B9 and B10 on the rank's range) or plain
versions, a rank's rows have the single-rank engine's bits.

The JAX package caches one compiled program per shape (``_sharded_fn``'s
``lru_cache``); eager torch has nothing to cache. Every function takes the
global arrays (the same on every rank) and returns the global result on
every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from nbody_tpu_torch.core.integrators import leapfrog_step
from nbody_tpu_torch.ops.treeforce import (BH2Partition, BH3Partition, BHPartition,
                                           _gather_sorted, _unsort_acc,
                                           bh2_sorted_range_acc, bh3_sorted_range_acc,
                                           bh_sorted_range_acc, build_bh2_partition,
                                           build_bh3_partition, build_bh_partition)
from nbody_tpu_torch.parallel.mesh import (PARTICLE_AXIS, Mesh, all_gather,
                                           particle_sharding)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with ``rows`` zero rows appended."""
    if rows == 0:
        return x
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def _range_acc(pall, mall, part, mesh, axis, g_const, softening, i_chunk, near_impl):
    """This rank's (N/n, 3) rows, in original order, of the engine that
    ``part``'s kind names, on the replicated state ``(pall, mall)``: its
    receiver range of the sorted arrays, all-gathered and unsorted."""
    n_dev, me = mesh.size(axis), mesh.index(axis)
    n, nb = pall.shape[0], part.n_blocks
    block = part.sorted_gid.shape[0] // nb
    spos, sm = _gather_sorted(pall, mall, part)
    if isinstance(part, BHPartition):
        fn, unit, extra = bh_sorted_range_acc, 1, ()
    elif isinstance(part, BH2Partition):
        fn, unit, extra = bh2_sorted_range_acc, nb // part.refined.shape[0], (part.refined,)
    else:
        fn, unit = bh3_sorted_range_acc, nb // part.refined.shape[0]
        extra = (part.refined, part.sub_near, part.sub_far)
    per = -(-(nb // unit) // n_dev)  # blocks (bh) or coarse groups a rank
    lo = min(me * per, nb // unit)
    hi = min(lo + per, nb // unit)
    if hi > lo:
        acc_rng = fn(spos, sm, part.near, *extra, g_const, softening, lo * unit,
                     (hi - lo) * unit, i_chunk=i_chunk, near_impl=near_impl)
    else:
        acc_rng = spos.new_zeros((0, 3))
    # a range cut short at the last block is padded for the gather; the
    # real rows of every rank are then the first nb * block in order
    acc_rng = _pad_rows(acc_rng, (per - (hi - lo)) * unit * block)
    acc = _unsort_acc(all_gather(acc_rng, mesh, axis)[:nb * block], part)
    shard = n // n_dev
    return acc[me * shard:(me + 1) * shard]


def _sharded_accelerations(pos, mass, g_const, softening, mesh, axis, partition,
                           build, i_chunk, near_impl):
    sh = particle_sharding(mesh, axis)
    pall = all_gather(sh.local(pos), mesh, axis)
    mall = all_gather(sh.local(mass), mesh, axis)
    part = build(pall, mall) if partition is None else partition
    acc_l = _range_acc(pall, mall, part, mesh, axis, g_const, softening, i_chunk,
                       near_impl)
    return all_gather(acc_l, mesh, axis)


@torch.no_grad()
def sharded_bh_accelerations(pos, mass, g_const: float, softening: float, mesh: Mesh,
                             axis: str = PARTICLE_AXIS,
                             partition: Optional[BHPartition] = None, n_near: int = 16,
                             block: int = 256, i_chunk: int = 8,
                             near_impl: str = "auto") -> torch.Tensor:
    """(N, 3) bh accelerations with the receiver blocks split over ``axis``:
    :func:`ops.treeforce.bh_accelerations` on the same partition. N must be
    divisible by the axis size. The knobs of the partition come from a given
    ``partition``'s shapes."""
    return _sharded_accelerations(
        pos, mass, g_const, softening, mesh, axis, partition,
        lambda p, m: build_bh_partition(p, m, n_near=n_near, block=block),
        i_chunk, near_impl)


@torch.no_grad()
def sharded_bh2_accelerations(pos, mass, g_const: float, softening: float, mesh: Mesh,
                              axis: str = PARTICLE_AXIS,
                              partition: Optional[BH2Partition] = None, n_near: int = 16,
                              block: int = 256, coarse: int = 16, rc: int = 32,
                              i_chunk: int = 8, near_impl: str = "auto") -> torch.Tensor:
    """(N, 3) two-level accelerations with the receiver coarse groups split
    over ``axis``: :func:`ops.treeforce.bh2_accelerations`."""
    return _sharded_accelerations(
        pos, mass, g_const, softening, mesh, axis, partition,
        lambda p, m: build_bh2_partition(p, m, n_near=n_near, block=block,
                                         coarse=coarse, rc=rc),
        i_chunk, near_impl)


@torch.no_grad()
def sharded_bh3_accelerations(pos, mass, g_const: float, softening: float, mesh: Mesh,
                              axis: str = PARTICLE_AXIS,
                              partition: Optional[BH3Partition] = None, n_near: int = 16,
                              block: int = 256, coarse: int = 16, rc: int = 32,
                              sub_block: int = 32, n_sub: int = 24, i_chunk: int = 8,
                              near_impl: str = "auto") -> torch.Tensor:
    """(N, 3) sub-refined two-level accelerations with the receiver coarse
    groups split over ``axis``: :func:`ops.treeforce.bh3_accelerations`."""
    return _sharded_accelerations(
        pos, mass, g_const, softening, mesh, axis, partition,
        lambda p, m: build_bh3_partition(p, m, n_near=n_near, block=block,
                                         coarse=coarse, rc=rc, sub_block=sub_block,
                                         n_sub=n_sub),
        i_chunk, near_impl)


def _simulate(pos, vel, mass, steps, g_const, softening, dt, mesh, axis, refresh,
              build, i_chunk, near_impl):
    """Leapfrog over the sharded force; the partition is built from the
    gathered positions at the start and rebuilt before step i's force when
    ``i % refresh == 0 and i > 0`` (JAX ``_bh_simulate_fn``, and the
    single-rank ``simulate``'s schedule)."""
    sh = particle_sharding(mesh, axis)
    p, v, m = sh.local(pos), sh.local(vel), sh.local(mass)
    mall = all_gather(m, mesh, axis)

    def force(q, part):
        return _range_acc(all_gather(q, mesh, axis), mall, part, mesh, axis, g_const,
                          softening, i_chunk, near_impl)

    part = build(all_gather(p, mesh, axis), mall)
    a = force(p, part)
    for i in range(steps):
        if i % refresh == 0 and i > 0:
            part = build(all_gather(p, mesh, axis), mall)
        p, v, a = leapfrog_step(p, v, a, lambda q: force(q, part), dt)
    return tuple(all_gather(t, mesh, axis) for t in (p, v, a))


@torch.no_grad()
def bh_simulate(pos, vel, mass, steps: int, g_const: float, softening: float, dt: float,
                mesh: Mesh, axis: str = PARTICLE_AXIS, n_near: int = 32,
                block: int = 256, refresh: int = 8, i_chunk: int = 8,
                near_impl: str = "auto"):
    """Multi-rank bh leapfrog rollout (the treecode twin of
    :func:`parallel.ring.ring_simulate`), the partition refreshed every
    ``refresh`` steps. :return: the final (pos, vel, acc), each (N, 3)."""
    return _simulate(pos, vel, mass, steps, g_const, softening, dt, mesh, axis, refresh,
                     lambda p, m: build_bh_partition(p, m, n_near=n_near, block=block),
                     i_chunk, near_impl)


@torch.no_grad()
def bh2_simulate(pos, vel, mass, steps: int, g_const: float, softening: float, dt: float,
                 mesh: Mesh, axis: str = PARTICLE_AXIS, n_near: int = 32,
                 block: int = 128, coarse: int = 16, rc: int = 32, refresh: int = 8,
                 i_chunk: int = 8, near_impl: str = "auto"):
    """Multi-rank two-level rollout: :func:`bh_simulate` on the bh2
    engine. :return: the final (pos, vel, acc), each (N, 3)."""
    return _simulate(pos, vel, mass, steps, g_const, softening, dt, mesh, axis, refresh,
                     lambda p, m: build_bh2_partition(p, m, n_near=n_near, block=block,
                                                      coarse=coarse, rc=rc),
                     i_chunk, near_impl)


@torch.no_grad()
def bh3_simulate(pos, vel, mass, steps: int, g_const: float, softening: float, dt: float,
                 mesh: Mesh, axis: str = PARTICLE_AXIS, n_near: int = 32,
                 block: int = 128, coarse: int = 16, rc: int = 32, sub_block: int = 32,
                 n_sub: int = 24, refresh: int = 8, i_chunk: int = 8,
                 near_impl: str = "auto"):
    """Multi-rank sub-refined two-level rollout: :func:`bh_simulate` on the
    bh3 engine. :return: the final (pos, vel, acc), each (N, 3)."""
    return _simulate(pos, vel, mass, steps, g_const, softening, dt, mesh, axis, refresh,
                     lambda p, m: build_bh3_partition(p, m, n_near=n_near, block=block,
                                                      coarse=coarse, rc=rc,
                                                      sub_block=sub_block, n_sub=n_sub),
                     i_chunk, near_impl)
