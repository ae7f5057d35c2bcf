"""The port's treecodes (``nbody_tpu_torch/ops/treeforce.py``) against the JAX
package (``nbody_tpu/ops/treeforce.py``) on the same numpy inputs, on the CPU.

Bars, as ``max|d| / max|ref|`` unless a test of ``tests/test_treeforce.py``
is named:

- plain versions of the kernels against the JAX kernels in interpret mode:
  B9 and B10 1e-5 (float32 sums in another order), B1's near-list form
  2e-5 (B1's bar, ``tests/test_forces.py:56,65``);
- partitions: sorted ids and inverse ranks equal; near, refined and
  sub-block sets equal as sets on >= 99 % of rows, all-pad blocks left out
  (they tie at the ``_INF`` mask);
- engines on one partition carried from JAX: rtol 2e-3 with atol 5e-9 (bh,
  bh2) or 2e-8 (bh3), the JAX tests' bar between their two near paths
  (``tests/test_treeforce.py:136-137,241-242,401-402``): the terms cancel
  across the near/far seam;
- the port's own partitions against its exact dense sum: the JAX tests'
  bars, cited per test.
"""

import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from nbody_tpu.ics import generate_disk as jgenerate_disk
from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ops import treeforce as jtf
from nbody_tpu.ops.pairwise import pallas_partial_accelerations
from nbody_tpu_torch.core import forces as tforces
from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
from nbody_tpu_torch.ops import pairwise as tpw
from nbody_tpu_torch.ops import treeforce as ttf

G, EPS = 4.5e-6, 0.05
ENGINES = {"bh": (jtf.bh_accelerations, ttf.bh_accelerations),
           "bh2": (jtf.bh2_accelerations, ttf.bh2_accelerations),
           "bh3": (jtf.bh3_accelerations, ttf.bh3_accelerations)}
PARTITIONS = {"bh": (jtf.build_bh_partition, ttf.build_bh_partition),
            "bh2": (jtf.build_bh2_partition, ttf.build_bh2_partition),
            "bh3": (jtf.build_bh3_partition, ttf.build_bh3_partition)}
# partition knobs per engine at the JAX tests' small sizes (B = 128)
KNOBS = {"bh": dict(n_near=8, block=128),
         "bh2": dict(n_near=8, block=128, coarse=4, rc=4),
         "bh3": dict(n_near=8, block=128, coarse=4, rc=4, sub_block=32, n_sub=16)}
ATOL = {"bh": 5e-9, "bh2": 5e-9, "bh3": 2e-8}


def _galaxy(gen, n, seed):
    """(pos, mass) of a JAX-package galaxy as numpy, and as torch."""
    pos, _, mass = gen(jax.random.PRNGKey(seed), n)
    pn, mn = np.array(pos), np.array(mass)
    return pn, mn, torch.from_numpy(pn), torch.from_numpy(mn)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _med_mean(approx, exact):
    num = (approx - exact).norm(dim=-1)
    rel = num / (exact.norm(dim=-1) + 1e-30)
    return float(rel.median()), float(rel.mean())


def _random_table(rng, k, n_pad):
    """(com (K, 3), msum (K,), quad (K, 3, 3)) with the last ``n_pad``
    blocks zero-mass, zero-Q padding, as numpy float32."""
    com = rng.normal(size=(k, 3)).astype(np.float32)
    msum = rng.uniform(1e-4, 1e-3, size=k).astype(np.float32)
    d = rng.normal(scale=0.1, size=(k, 8, 3))
    w = rng.uniform(size=(k, 8)) * msum[:, None] / 8
    outer = np.einsum("kb,kba,kbc->kac", w, d, d)
    quad = (3 * outer - np.trace(outer, axis1=1, axis2=2)[:, None, None] * np.eye(3))
    quad = quad.astype(np.float32)
    msum[k - n_pad:] = 0.0
    quad[k - n_pad:] = 0.0
    return com, msum, quad


def _table(com, msum, quad):
    return ttf._blk_rows(torch.from_numpy(com), torch.from_numpy(msum),
                         torch.from_numpy(quad))


# ------------------------------------------- plain versions of the kernels

@pytest.mark.parametrize("p,k,eps", [(300, 37, 0.0), (129, 400, EPS)])
def test_b9_plain_matches_jax(p, k, eps):
    rng = np.random.default_rng(p + k)
    com, msum, quad = _random_table(rng, k, 5)
    q = rng.normal(size=(p, 3)).astype(np.float32)
    q[0] = com[0]  # a receiver on a COM: the floor keeps it finite at eps 0
    got = ttf.multipole_acc_torch(torch.from_numpy(q), _table(com, msum, quad), G, eps * eps)
    assert torch.isfinite(got).all()
    want_k = jtf.pallas_multipole_acc(q, com, msum, quad, G, eps * eps, interpret=True)
    want_x = jtf._multipole_acc(jnp.asarray(q), com, msum, quad, G, eps * eps)
    assert _rel(got, want_k) <= 1e-5
    assert _rel(got, want_x) <= 1e-5


def test_b10_plain_matches_jax():
    rng = np.random.default_rng(3)
    com, msum, quad = _random_table(rng, 40, 3)
    qg = rng.normal(size=(5, 70, 3)).astype(np.float32)
    ids = rng.integers(0, 40, size=(5, 9)).astype(np.int32)
    table = _table(com, msum, quad)
    got = ttf.grouped_multipole_acc_torch(torch.from_numpy(qg), table, torch.from_numpy(ids),
                                          G, EPS ** 2)
    blkTg = np.transpose(table.numpy()[ids], (0, 2, 1))  # JAX's gathered (G, 10, S)
    want = jtf.pallas_grouped_multipole_acc(qg, blkTg, G, EPS ** 2, interpret=True)
    assert _rel(got, want) <= 1e-5
    # the kernel wrapper takes the plain version for CPU tensors
    same = ttf.grouped_multipole_acc(torch.from_numpy(qg), table, torch.from_numpy(ids),
                                     G, EPS ** 2)
    assert torch.equal(same, got)


@pytest.mark.parametrize("groups,rows,lst,bs", [(4, 37, 3, 16), (3, 128, 5, 32)])
def test_b1_near_list_plain_matches_jax(groups, rows, lst, bs):
    rng = np.random.default_rng(rows)
    n_blocks = 9
    src = np.concatenate([rng.normal(size=(n_blocks * bs, 3)),
                          rng.uniform(1e-4, 1e-3, size=(n_blocks * bs, 1))], 1)
    src = src.astype(np.float32)
    src[-3:, 3] = 0.0  # zero-mass pads
    q = rng.normal(size=(groups, rows, 3)).astype(np.float32)
    q[0, 0] = src[0, :3]  # a coincident pair adds an exact zero
    near = rng.integers(0, n_blocks, size=(groups, lst)).astype(np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(src[:, :3].copy()),
            torch.from_numpy(src[:, 3].copy()), torch.from_numpy(near), bs, G, EPS)
    got = tpw.near_accelerations_torch(*args)
    cand = src.reshape(n_blocks, bs, 4)[near].reshape(groups, lst * bs, 4)
    want = jax.vmap(lambda qb, cb, mb: pallas_partial_accelerations(
        qb, cb, mb, G, EPS, interpret=True))(q, cand[..., :3], cand[..., 3])
    assert _rel(got, np.asarray(want)[:, :rows]) <= 2e-5
    assert torch.equal(tpw.near_accelerations(*args), got)


def test_b10_plain_matches_jax_at_bh3_sub_block_shape():
    """The bh3 near pass's sub-block multipoles: groups of 128 receivers
    against 80 sub-block rows each (1M recipe: 7,813 x 128 x 80)."""
    rng = np.random.default_rng(80)
    com, msum, quad = _random_table(rng, 300, 4)
    qg = rng.normal(size=(3, 128, 3)).astype(np.float32)
    ids = rng.integers(0, 300, size=(3, 80)).astype(np.int32)
    table = _table(com, msum, quad)
    got = ttf.grouped_multipole_acc(torch.from_numpy(qg), table, torch.from_numpy(ids),
                                    G, EPS ** 2)
    blkTg = np.transpose(table.numpy()[ids], (0, 2, 1))
    want = jtf.pallas_grouped_multipole_acc(qg, blkTg, G, EPS ** 2, interpret=True)
    assert _rel(got, want) <= 1e-5


def test_plain_versions_read_out_of_range_ids_as_zero_rows():
    """As the kernels do: a B10 id outside [0, K) pulls as a zero row, a
    near-list id outside [0, n_blocks) as a block of zero-mass sources."""
    rng = np.random.default_rng(5)
    com, msum, quad = _random_table(rng, 20, 0)
    table = _table(com, msum, quad)
    padded = torch.cat([table, torch.zeros(1, 10)])
    qg = torch.from_numpy(rng.normal(size=(2, 9, 3)).astype(np.float32))
    ids = torch.tensor([[0, -1, 5, 20, 19], [7, 1000, -7, 3, 3]], dtype=torch.int32)
    as_pad = torch.where((ids >= 0) & (ids < 20), ids, 20)
    torch.testing.assert_close(ttf.grouped_multipole_acc_torch(qg, table, ids, G, EPS ** 2),
                               ttf.grouped_multipole_acc_torch(qg, padded, as_pad, G, EPS ** 2),
                               rtol=0, atol=0)
    bs = 4
    pos = torch.from_numpy(rng.normal(size=(5 * bs, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(1e-4, 1e-3, size=5 * bs).astype(np.float32))
    near = torch.tensor([[0, -1, 4, 5], [9, 2, 2, -3]], dtype=torch.int32)
    got = tpw.near_accelerations_torch(qg, pos, mass, near, bs, G, EPS)
    pad_pos, pad_mass = torch.cat([pos, torch.zeros(bs, 3)]), torch.cat([mass, torch.zeros(bs)])
    as_pad = torch.where((near >= 0) & (near < 5), near, 5)
    want = tpw.near_accelerations_torch(qg, pad_pos, pad_mass, as_pad, bs, G, EPS)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, tpw.near_accelerations_torch(
        qg, pos, mass, near.clamp(0, 4), bs, G, EPS))


@pytest.mark.parametrize("p", [1, 5, 31, 32, 33, 63, 64, 100, 128, 129, 200, 255, 256, 257,
                               2048, 2049])
def test_b10_plan_covers_each_receiver_once(p):
    """B10's launch plan: every receiver of every group in exactly one
    block; the widest block no larger than the group (so a 128-receiver
    group of bh3's near pass is one block, a 2048-receiver refinement group
    eight); lanes a receiver group dividing a warp."""
    groups = 3
    plan = ttf.grouped_plan(groups, p)
    lanes, recv, tiles = plan["lanes"], plan["receivers"], plan["tiles"]
    assert 32 % lanes == 0 and recv == ttf._MP_THREADS // lanes * ttf._MP_RPT
    assert plan["blocks"] == groups * tiles and (tiles - 1) * recv < p <= tiles * recv
    assert recv <= p or lanes == ttf._MP_LANES[-1]
    wider = [n for n in ttf._MP_LANES if n < lanes]
    assert all(ttf._MP_THREADS // n * ttf._MP_RPT > p for n in wider)
    seen = np.zeros((groups, p), dtype=int)
    for b in range(plan["blocks"]):
        for slot in range(recv):  # thread slot // _MP_RPT, receiver slot % _MP_RPT
            r = (b % tiles) * recv + slot
            if r < p:
                seen[b // tiles, r] += 1
    assert (seen == 1).all()
    if p == 2048:
        assert (lanes, tiles) == (4, 8)
    if p == 128:
        assert (lanes, tiles) == (8, 1)


def test_b10_plan_uses_the_kernels_launch_shape():
    """``_MP_THREADS`` and ``_MP_RPT`` are MP_THREADS and MP_RPT of
    csrc/treeforce.cu, read from the source, and the lanes the plan picks
    are the ones the launch dispatches."""
    src = (Path(ttf.__file__).parents[1] / "csrc" / "treeforce.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    assert (consts["MP_THREADS"], consts["MP_RPT"]) == (ttf._MP_THREADS, ttf._MP_RPT)
    cases = re.findall(r"case (\d+): return \(int\)launch_grouped<(\d+)>", src)
    assert [(int(a), int(b)) for a, b in cases] == [(n, n) for n in ttf._MP_LANES]


@pytest.mark.parametrize("p,blocks", [(100_000, 391), (1_000_000, 3907)])
def test_b9_plan_at_the_path_shapes(p, blocks):
    """B9 launches as one group of all receivers: at the bh 100k and bh3 1M
    receiver counts 4 lanes, 256 receivers a block, 391 and 3,907 blocks."""
    assert ttf.grouped_plan(1, p) == {"lanes": 4, "receivers": 256, "tiles": blocks,
                                      "blocks": blocks}


def test_b9_and_b10_share_one_receiver_loop():
    """csrc/treeforce.cu has one receiver loop, one call of the pull:
    B9's kernel (its own name, which profilers tell from B10's) runs it
    without an id list, B10's with one, and B9's entry launches through the
    lanes B10's dispatch takes."""
    src = (Path(ttf.__file__).parents[1] / "csrc" / "treeforce.cu").read_text()
    assert len(re.findall(r"\bmultipole_pull\(b0", src)) == 1
    assert "pull_receivers<LANES, false>" in src and "pull_receivers<LANES, true>" in src
    assert re.findall(r"^(\w+_kernel)\(", src, re.M) == ["multipole_far_kernel",
                                                          "multipole_grouped_kernel"]
    far = src[src.index("int multipole_far("):src.index("int multipole_grouped(")]
    assert "launch_lanes(lanes, false, q, table, nullptr, 1, p, k, k" in far


# ------------------------------------------------------------- partitions

def _pad_blocks(n, rows):
    """Ids of blocks of ``rows`` sorted slots that hold no particle."""
    return lambda ids: ids >= -(-n // rows)


def _same_sets(got, want, is_pad):
    """Share of rows whose id sets agree once all-pad ids are left out."""
    got, want = np.asarray(got), np.asarray(want)
    same = [set(a[~is_pad(a)].tolist()) == set(b[~is_pad(b)].tolist())
            for a, b in zip(got, want)]
    return float(np.mean(same))


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_partitions_match_jax(engine):
    n = 2900  # 23 blocks of 128, padded to 24 for bh2/bh3: one all-pad block
    pn, mn, pt, mt = _galaxy(jgenerate_spiral, n, 30)
    jpart = PARTITIONS[engine][0](pn, mn, **KNOBS[engine])
    tpart = PARTITIONS[engine][1](pt, mt, **KNOBS[engine])
    assert type(tpart).__name__ == type(jpart).__name__
    assert tpart._fields == jpart._fields
    for f in ("sorted_gid", "inv_rank"):
        np.testing.assert_array_equal(getattr(tpart, f).numpy(), np.asarray(getattr(jpart, f)))
    block = KNOBS[engine]["block"]
    assert _same_sets(tpart.near, jpart.near, _pad_blocks(n, block)) >= 0.99
    if engine != "bh":
        coarse = KNOBS[engine]["coarse"]
        assert _same_sets(tpart.refined, jpart.refined, _pad_blocks(n, block * coarse)) >= 0.99
    if engine == "bh3":
        bs = KNOBS[engine]["sub_block"]
        for f in ("sub_near", "sub_far"):
            assert getattr(tpart, f).shape == np.asarray(getattr(jpart, f)).shape
            assert _same_sets(getattr(tpart, f), getattr(jpart, f), _pad_blocks(n, bs)) >= 0.99
    carried = ttf.partition_from_numpy({k: np.asarray(v) for k, v in jpart._asdict().items()})
    assert type(carried) is type(tpart) and carried.near.dtype == torch.int32


def test_bh2_partition_needs_rc_3():
    pn, mn, pt, mt = _galaxy(jgenerate_spiral, 2048, 31)
    for build in (jtf.build_bh2_partition, ttf.build_bh2_partition):
        p, m = (pn, mn) if build is jtf.build_bh2_partition else (pt, mt)
        with pytest.raises(ValueError, match="rc >= 3"):
            build(p, m, n_near=8, block=128, coarse=4, rc=2)


# ---------------------------------------------- engines on one partition

@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
@pytest.mark.parametrize("impl,jax_impl", [("dense", "xla"), ("kernel", "pallas_interpret")])
def test_engines_match_jax_on_carried_partition(engine, impl, jax_impl):
    n = 1200 if engine == "bh" else 2048
    pn, mn, pt, mt = _galaxy(jgenerate_spiral, n, 7 if engine == "bh" else 14)
    jpart = PARTITIONS[engine][0](pn, mn, **KNOBS[engine])
    part = ttf.partition_from_numpy({k: np.asarray(v) for k, v in jpart._asdict().items()})
    want = ENGINES[engine][0](pn, mn, G, EPS, partition=jpart, i_chunk=2, near_impl=jax_impl)
    got = ENGINES[engine][1](pt, mt, G, EPS, partition=part, i_chunk=2, near_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=ATOL[engine])


# ------------------------------- the port's own partitions, exact dense sum

@pytest.mark.parametrize("gen,med_tol,mean_tol", [
    (jgenerate_spiral, 1e-2, 5e-2), (jgenerate_disk, 5e-4, 5e-3)])  # test_treeforce.py:22-32
def test_bh_close_to_exact_on_galaxies(gen, med_tol, mean_tol):
    _, _, pt, mt = _galaxy(gen, 3000, 0)
    exact = tforces.pairwise_accelerations(pt, mt, G, EPS)
    med, mean = _med_mean(ttf.bh_accelerations(pt, mt, G, EPS, n_near=16, block=128), exact)
    assert med < med_tol and mean < mean_tol, (med, mean)


@pytest.mark.parametrize("engine,knob,values,n", [
    ("bh", "n_near", (9, 12, 16), 2000),  # test_treeforce.py:35-42
    ("bh2", "rc", (3, 5, 8), 4096),  # :187-197, its size: 3000 bodies give
    # only 6 superblocks, too few for the error to fall with rc in either package
    ("bh3", "n_sub", (16, 24, 48), 3000),  # :310-320
])
def test_error_monotone_in_knob(engine, knob, values, n):
    _, _, pt, mt = _galaxy(jgenerate_spiral, n, {"bh": 1, "bh2": 12, "bh3": 21}[engine])
    exact = tforces.pairwise_accelerations(pt, mt, G, EPS)
    base = {"bh": dict(block=128), "bh2": dict(n_near=8, block=128, coarse=4),
            "bh3": dict(n_near=16, block=128, coarse=4, rc=8, sub_block=32)}[engine]
    errs = [_med_mean(ENGINES[engine][1](pt, mt, G, EPS, **base, **{knob: v}), exact)[1]
            for v in values]
    if engine == "bh2":
        assert errs[0] >= errs[1] >= errs[2], errs
    else:
        assert errs[0] > errs[1] > errs[2], errs


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_bh_exact_when_all_blocks_near(impl):
    """M >= nb: the far set is empty and the result is the direct sum
    (test_treeforce.py:45-52)."""
    _, _, pt, mt = _galaxy(jgenerate_disk, 700, 2)
    exact = tforces.pairwise_accelerations(pt, mt, G, EPS)
    got = ttf.bh_accelerations(pt, mt, G, EPS, n_near=64, block=128, near_impl=impl)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2e-3, atol=1e-12)


def test_full_refinement_telescopes():
    """rc = nbc: bh2 is bh (median < 1e-4, test_treeforce.py:170-184); n_sub
    = M*S: bh3 is bh2 (median < 5e-4, mean < 5e-3, :290-307)."""
    _, _, pt, mt = _galaxy(jgenerate_spiral, 3000, 11)
    a1 = ttf.bh_accelerations(pt, mt, G, EPS, n_near=8, block=128)
    a2 = ttf.bh2_accelerations(pt, mt, G, EPS, n_near=8, block=128, coarse=4, rc=6)
    assert _med_mean(a2, a1)[0] < 1e-4
    b2 = ttf.bh2_accelerations(pt, mt, G, EPS, n_near=16, block=128, coarse=4, rc=4)
    b3 = ttf.bh3_accelerations(pt, mt, G, EPS, n_near=16, block=128, coarse=4, rc=4,
                               sub_block=32, n_sub=16 * 4)
    med, mean = _med_mean(b3, b2)
    assert med < 5e-4 and mean < 5e-3, (med, mean)


@pytest.mark.parametrize("engine,n,tol", [
    ("bh", 2000, 1e-2),  # test_treeforce.py:55-66
    ("bh2", 3000, 6e-2),  # :200-226
    ("bh3", 3000, 9e-2),  # :366-378
])
def test_stale_partition_stays_accurate(engine, n, tol):
    pos, vel, mass = jgenerate_spiral(jax.random.PRNGKey(3), n)
    pt, vt, mt = (torch.from_numpy(np.array(x)) for x in (pos, vel, mass))
    knobs = {"bh": dict(n_near=12, block=128), "bh2": dict(n_near=8, block=128, coarse=4, rc=6),
             "bh3": dict(n_near=8, block=128, coarse=4, rc=6, sub_block=32, n_sub=16)}[engine]
    part = PARTITIONS[engine][1](pt, mt, **knobs)
    drifted = pt + vt * 1e-2
    exact = tforces.pairwise_accelerations(drifted, mt, G, EPS)
    med, _ = _med_mean(ENGINES[engine][1](drifted, mt, G, EPS, partition=part), exact)
    assert med < tol, med


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_dense_path_differentiable_and_finite_at_zero_softening(engine):
    """Autograd through the dense near pass gives finite, nonzero gradients
    (test_treeforce.py:84-97); at softening 0 both near paths stay finite
    (:140-148)."""
    _, _, pt, mt = _galaxy(jgenerate_spiral, 1024, 5)
    knobs = KNOBS[engine]
    p = pt.clone().requires_grad_(True)
    (ENGINES[engine][1](p, mt, G, EPS, near_impl="dense", **knobs) ** 2).sum().backward()
    assert torch.isfinite(p.grad).all() and float((p.grad ** 2).sum()) > 0.0
    for impl in ("dense", "kernel"):
        a0 = ENGINES[engine][1](pt, mt, G, 0.0, near_impl=impl, **knobs)
        assert torch.isfinite(a0).all(), impl


# ---------------------------------------------------------------- simulate

SIM_KNOBS = {"bh": dict(bh_near=12, bh_block=128),
             "bh2": dict(bh_near=8, bh_block=64, bh_coarse=4, bh_rc=6),
             "bh3": dict(bh_near=8, bh_block=64, bh_coarse=4, bh_rc=6, bh_sub_block=16,
                         bh_n_sub=16)}


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_simulate_treecode_tracks_dense(engine, monkeypatch):
    """50 leapfrog steps of a 1500-body disk at refresh 8 stay within 1e-4 of
    the dense rollout's scale, with energy drift < 1e-3
    (test_treeforce.py:100-121,262-284,414-434); the partition is rebuilt
    exactly before the force evaluations of steps 8, 16, ..., 48."""
    pos, vel, mass = (torch.from_numpy(np.array(x))
                      for x in jgenerate_disk(jax.random.PRNGKey(6), 1500))
    base = dict(g_const=G, softening=EPS, dt=1e-4, integrator="leapfrog", calc_energy=True)
    events = []
    name = {"bh": "build_bh_partition", "bh2": "build_bh2_partition",
            "bh3": "build_bh3_partition"}[engine]
    build, engine_fn = getattr(ttf, name), ENGINES[engine][1]
    monkeypatch.setattr(ttf, name, lambda *a, **k: events.append("B") or build(*a, **k))
    monkeypatch.setattr(ttf, ENGINES[engine][1].__name__,
                        lambda *a, **k: events.append("A") or engine_fn(*a, **k))
    t_bh = simulate(pos, vel, mass, 50, SimulationConfig(
        force_backend=engine, bh_refresh=8, **SIM_KNOBS[engine], **base))
    assert "".join(events) == "BA" + "".join(
        ("B" if i % 8 == 0 and i > 0 else "") + "A" for i in range(50))
    t_ex = simulate(pos, vel, mass, 50, SimulationConfig(force_backend="dense", **base))
    d = (t_bh.positions[-1] - t_ex.positions[-1]).norm(dim=-1)
    scale = float(t_ex.positions[-1].norm(dim=-1).mean())
    assert 0 < float(d.max()) / scale < 1e-4
    e = (t_bh.u_energy + t_bh.k_energy).double()
    assert float((e - e[0]).abs().max()) < 1e-3 * abs(float(e[0]))
    with pytest.raises(ValueError):
        simulate(pos, vel, mass, 2, SimulationConfig(force_backend=engine, bh_refresh=8,
                                                     **base), mask=torch.ones(1500))


def test_simulate_refresh_1_builds_per_evaluation(monkeypatch):
    pos, vel, mass = (torch.from_numpy(np.array(x))
                      for x in jgenerate_spiral(jax.random.PRNGKey(9), 600))
    calls = []
    build = ttf.build_bh_partition
    monkeypatch.setattr(ttf, "build_bh_partition",
                        lambda *a, **k: calls.append(1) or build(*a, **k))
    t = simulate(pos, vel, mass, 3, SimulationConfig(
        g_const=G, softening=EPS, dt=1e-4, force_backend="bh", bh_block=128, bh_near=4))
    assert len(calls) == 4 and torch.isfinite(t.positions).all()
