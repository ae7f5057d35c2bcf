"""The port's treecode partitions and engines against the JAX package's at the
selection knobs of the 2M-10M artifacts (``results/large_scale/bh2_*.json``,
``bh3_10m*.json``), on the CPU.

Each artifact's ``n_near``, ``coarse``, ``rc``, ``n_sub`` and the ratio of
``block`` to ``sub_block`` stand as they are; the blocks shrink to 16
bodies, so that 16,000-28,000 bodies give more superblocks than ``rc`` (the
refined-superblock selection picks among them) and more candidate
sub-blocks than ``n_sub``. Bars, those of
``tests/test_torch_treeforce.py``:

- partitions: sorted ids and inverse ranks equal; near, refined and
  sub-block sets equal as sets on >= 99 % of rows, all-pad blocks left out;
- engines on a partition carried from JAX, JAX ``near_impl="xla"`` against
  the port's ``dense`` and ``kernel`` (the plain versions of B1's near list,
  B9 and B10 here): rtol 2e-3 with atol 5e-9 (bh2) or 2e-8 (bh3), the JAX
  tests' bar between their two near paths
  (``tests/test_treeforce.py:136-137,241-242,401-402``), on every element
  but those of one named body of the 16,000-body galaxy (``SEAM_BODY``). It
  sits in the float32 cancellation of the near/far seam: there JAX's
  float32 force stands 2.0-3.5e-8 from the float64 run of the same
  partition, the port's 0.05-1.4e-8, and there the port must stand at
  least as close to that float64 run as JAX, element by element.

And, at the artifacts' own knobs (blocks of 512) on 500,000 bodies of the
JAX script's ICs (``PRNGKey(0)``): the port's partitions are JAX's, every
set of every row equal.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ops import treeforce as jtf
from nbody_tpu_torch.ops import treeforce as ttf

G, EPS = 4.5e-6, 0.05
ATOL = {"bh2": 5e-9, "bh3": 2e-8}
SEAM_BODY = {16_000: 14969}  # bodies -> the one body let past the bar (see above)
# artifact -> (engine, bodies, knobs): its selection knobs with blocks of 16
# bodies (sub-blocks of 2 for the block / sub_block ratio 8 of bh3_10m and
# _speed, of 1 for ratio 16), enough bodies for about twice rc superblocks;
# _m8 and _tier_m32 take no knob value that these leave out
TIERS = {
    "bh2_10m_b512": ("bh2", 16_000, dict(n_near=16, block=16, coarse=16, rc=48)),
    "bh2_10m_b512_m32": ("bh2", 16_000, dict(n_near=32, block=16, coarse=16, rc=48)),
    "bh3_10m": ("bh3", 16_000, dict(n_near=48, block=16, coarse=16, rc=48, sub_block=2,
                                    n_sub=24)),
    "bh3_10m_speed": ("bh3", 16_000, dict(n_near=32, block=16, coarse=16, rc=24,
                                          sub_block=2, n_sub=16)),
    "bh3_10m_tier": ("bh3", 16_000, dict(n_near=48, block=16, coarse=16, rc=48, sub_block=1,
                                         n_sub=48)),
    "bh3_10m_tier_rc96": ("bh3", 28_000, dict(n_near=48, block=16, coarse=16, rc=96,
                                              sub_block=1, n_sub=64)),
}


@functools.lru_cache(maxsize=None)
def _galaxy(n):
    pos, _, mass = jgenerate_spiral(jax.random.PRNGKey(16), n)
    return np.array(pos), np.array(mass)


@functools.lru_cache(maxsize=None)
def _jax_partition(tier):
    engine, n, knobs = TIERS[tier]
    part = getattr(jtf, f"build_{engine}_partition")(*_galaxy(n), **knobs)
    return {k: np.asarray(v) for k, v in part._asdict().items()}


@functools.lru_cache(maxsize=None)
def _jax_forces(tier):
    engine, n, _ = TIERS[tier]
    fields = _jax_partition(tier)
    kind = jtf.BH3Partition if engine == "bh3" else jtf.BH2Partition
    return np.asarray(getattr(jtf, f"{engine}_accelerations")(
        *_galaxy(n), G, EPS, partition=kind(**fields), near_impl="xla"))


@functools.lru_cache(maxsize=None)
def _float64_forces(tier):
    """The port's engine in float64 on the JAX partition (the plain versions
    of its kernels)."""
    engine, n, _ = TIERS[tier]
    pos, mass = (x.double() for x in _torch_galaxy(n))
    return getattr(ttf, f"{engine}_accelerations")(
        pos, mass, G, EPS, partition=ttf.partition_from_numpy(_jax_partition(tier)),
        near_impl="kernel").numpy()


def _torch_galaxy(n):
    return tuple(torch.from_numpy(x) for x in _galaxy(n))


def _same_sets(got, want, is_pad):
    got, want = np.asarray(got), np.asarray(want)
    same = [set(a[~is_pad(a)].tolist()) == set(b[~is_pad(b)].tolist())
            for a, b in zip(got, want)]
    return float(np.mean(same))


def _pad(n, rows):
    return lambda ids: ids >= -(-n // rows)


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_partitions_match_jax(tier):
    engine, n, knobs = TIERS[tier]
    want = _jax_partition(tier)
    got = getattr(ttf, f"build_{engine}_partition")(*_torch_galaxy(n), **knobs)
    nbc, rc = got.refined.shape
    assert nbc > rc, "the refined-superblock selection must choose among superblocks"
    for f in ("sorted_gid", "inv_rank"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f])
    block = knobs["block"]
    assert _same_sets(got.near, want["near"], _pad(n, block)) >= 0.99
    assert _same_sets(got.refined, want["refined"], _pad(n, block * knobs["coarse"])) >= 0.99
    if engine == "bh3":
        assert got.sub_far.shape[1] > 0, "n_sub must leave candidates to the multipoles"
        for f in ("sub_near", "sub_far"):
            assert getattr(got, f).shape == want[f].shape
            assert _same_sets(getattr(got, f), want[f], _pad(n, knobs["sub_block"])) >= 0.99


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_tier_engines_match_jax_on_carried_partition(tier, impl):
    engine, n, _ = TIERS[tier]
    part = ttf.partition_from_numpy(_jax_partition(tier))
    got = getattr(ttf, f"{engine}_accelerations")(*_torch_galaxy(n), G, EPS, partition=part,
                                                  near_impl=impl)
    got, want = got.numpy(), _jax_forces(tier)
    over = np.abs(got - want) > ATOL[engine] + 2e-3 * np.abs(want)
    seam = SEAM_BODY.get(n)
    others = np.ones(n, bool)
    if seam is not None:
        others[seam] = False
        f64 = _float64_forces(tier)[seam]
        assert (np.abs(got[seam] - f64) <= np.abs(want[seam] - f64))[over[seam]].all()
    assert not over[others].any(), f"{over[others].sum()} elements over the bar"


@pytest.mark.parametrize("k,half,lead", [(1, 0, ()), (7, 1, ()), (12, 4, ()), (5, 4, ()),
                                         (9, 2, (3,))])
def test_forced_band_is_the_old_window_mask(k, half, lead):
    """The partitions' forced curve window, written on the diagonals in
    place, is the mask |i - j| <= half of an int64 (K, K) difference that it
    replaces, on every scene of a group too."""
    ii = torch.arange(k)
    old = (ii[:, None] - ii[None, :]).abs() <= half
    sep2 = torch.rand(lead + (k, k), generator=torch.Generator().manual_seed(k))
    want = torch.where(old, -1.0, sep2)
    got = ttf._force_band(sep2.clone(), half)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tier", ["bh2_10m_b512", "bh3_10m_tier_rc96"])
def test_partition_sorted_in_slabs_is_the_whole_sort(tier, monkeypatch):
    """The selections sorted a slab of rows at a time (lowered here to ~5
    rows a slab) give the partition of one whole sort, bit for bit."""
    engine, n, knobs = TIERS[tier]
    build = getattr(ttf, f"build_{engine}_partition")
    whole = build(*_torch_galaxy(n), **knobs)
    monkeypatch.setattr(ttf, "_SORT_ELEMS", 5 * whole.near.shape[0])
    slabs = build(*_torch_galaxy(n), **knobs)
    for f in whole._fields:
        assert torch.equal(getattr(whole, f), getattr(slabs, f)), f


# the JAX script's ICs cut to 500,000 bodies: with blocks of 512 and coarse
# 16 that is 62 superblocks, more than rc = 48
ART_500K = {
    "bh2_10m_b512": ("bh2", TIERS["bh2_10m_b512"][2] | dict(block=512)),
    "bh3_10m": ("bh3", dict(n_near=48, block=512, coarse=16, rc=48, sub_block=64, n_sub=24)),
    "bh3_10m_tier": ("bh3", dict(n_near=48, block=512, coarse=16, rc=48, sub_block=32,
                                 n_sub=48)),
}


@functools.lru_cache(maxsize=None)
def _jax_ics_500k():
    pos, _, mass = jgenerate_spiral(jax.random.PRNGKey(0), 500_000)
    return np.array(pos), np.array(mass)


@pytest.mark.parametrize("tier", list(ART_500K))
def test_partition_is_jaxs_at_the_artifacts_own_knobs(tier):
    engine, knobs = ART_500K[tier]
    pos, mass = _jax_ics_500k()
    want = getattr(jtf, f"build_{engine}_partition")(pos, mass, **knobs)._asdict()
    got = getattr(ttf, f"build_{engine}_partition")(torch.from_numpy(pos),
                                                    torch.from_numpy(mass), **knobs)
    assert got.refined.shape[0] > knobs["rc"]
    for f in ("sorted_gid", "inv_rank"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(want[f]))
    for f in ("near", "refined") + (("sub_near", "sub_far") if engine == "bh3" else ()):
        a, b = getattr(got, f).numpy(), np.asarray(want[f])
        assert a.shape == b.shape, f
        assert all(set(x.tolist()) == set(y.tolist()) for x, y in zip(a, b)), f
