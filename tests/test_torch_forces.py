"""Port forces and energies (``nbody_tpu_torch.core.forces`` and the B1/B2
kernel wrappers of ``nbody_tpu_torch.ops.pairwise``, which take their plain
torch twins on the CPU) against the JAX package on the same numpy inputs.

Bars come from the JAX package's own tests: forces atol 2e-5 on
max-scaled accelerations (tests/test_forces.py:56,65), potential energy
relative 1e-5 (tests/test_forces.py:114-154)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core import forces as jforces
from nbody_tpu.ops import pairwise as jpw
from nbody_tpu_torch.core import forces as tforces
from nbody_tpu_torch.ops import pairwise as tpw

G, EPS = 4.5e-6, 0.05


def _random_system(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return pos, vel, mass


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_scaled_close(got, want, atol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _assert_rel(got, want, rtol=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("n", [2, 3, 17, 100])
def test_dense_accelerations_match_jax(n):
    pos, _, mass = _random_system(n, seed=n)
    got = tforces.pairwise_accelerations(*_t(pos, mass), G, EPS)
    want = jforces.pairwise_accelerations(pos, mass, G, EPS)
    _assert_scaled_close(got, want)


@pytest.mark.parametrize("chunk", [None, 16])
def test_dense_energies_match_jax(chunk):
    pos, vel, mass = _random_system(50, seed=1)
    tp, tv, tm = _t(pos, vel, mass)
    _assert_rel(tforces.potential_energy(tp, tm, G, EPS, chunk_size=chunk),
                jforces.potential_energy(pos, mass, G, EPS, chunk_size=chunk))
    _assert_rel(tforces.kinetic_energy(tv, tm), jforces.kinetic_energy(vel, mass))
    u, k = tforces.energies(tp, tv, tm, G, EPS)
    _assert_rel(u, jforces.potential_energy(pos, mass, G, EPS))
    _assert_rel(k, jforces.kinetic_energy(vel, mass))


def test_dense_mask_matches_jax_and_smaller_system():
    pos, vel, mass = _random_system(40, seed=2)
    mask = np.arange(40) < 25
    tp, tv, tm, tmask = _t(pos, vel, mass, mask)
    acc = tforces.pairwise_accelerations(tp, tm, G, EPS, mask=tmask)
    _assert_scaled_close(acc, jforces.pairwise_accelerations(
        pos, mass, G, EPS, mask=jnp.asarray(mask)))
    assert torch.all(acc[25:] == 0)
    small = tforces.pairwise_accelerations(tp[:25], tm[:25], G, EPS)
    _assert_scaled_close(acc[:25], small, atol=1e-6)
    for chunk in (None, 8):
        _assert_rel(tforces.potential_energy(tp, tm, G, EPS, mask=tmask, chunk_size=chunk),
                    jforces.potential_energy(pos, mass, G, EPS, mask=jnp.asarray(mask)))
    _assert_rel(tforces.kinetic_energy(tv, tm, mask=tmask),
                jforces.kinetic_energy(vel, mass, mask=jnp.asarray(mask)))


@pytest.mark.parametrize("n", [3, 64, 300])
def test_b1_twin_matches_pallas(n):
    """Ragged N: 300 is no multiple of the Pallas tiles or of B1's rows."""
    pos, _, mass = _random_system(n, seed=n)
    got = tpw.accelerations(*_t(pos, mass), G, EPS)
    want = jpw.pallas_accelerations(pos, mass, G, EPS, interpret=True)
    _assert_scaled_close(got, want)
    _assert_scaled_close(got, jforces.pairwise_accelerations(pos, mass, G, EPS))


def test_b1_twin_mask_matches_pallas():
    pos, _, mass = _random_system(40, seed=7)
    mask = np.arange(40) < 30
    got = tpw.accelerations(*_t(pos, mass), G, EPS, mask=torch.from_numpy(mask))
    want = jpw.pallas_accelerations(pos, mass, G, EPS, mask=jnp.asarray(mask),
                                    interpret=True)
    _assert_scaled_close(got, want)
    assert torch.all(got[30:] == 0)


def test_b1_rectangular_twin_matches_pallas():
    """Targets and sources of different sizes (the ring and treecode shape),
    including a coincident pair that must add an exact zero."""
    pos, _, mass = _random_system(200, seed=3)
    tgt = pos[:40].copy()
    got = tpw.partial_accelerations(*_t(tgt, pos, mass), G, EPS)
    want = jpw.pallas_partial_accelerations(tgt, pos, mass, G, EPS, interpret=True)
    _assert_scaled_close(got, want)
    # softening 0: the self pairs still cancel exactly
    got0 = tpw.partial_accelerations(*_t(tgt, pos, mass), G, 0.0)
    assert torch.isfinite(got0).all()


def test_b2_twin_matches_pallas():
    pos, _, mass = _random_system(200, seed=9)
    tp, tm = _t(pos, mass)
    _assert_rel(tpw.potential_energy(tp, tm, G, EPS),
                jpw.pallas_potential_energy(pos, mass, G, EPS, interpret=True))
    mask = np.arange(200) < 150
    _assert_rel(
        tpw.potential_energy(tp, tm, G, EPS, mask=torch.from_numpy(mask)),
        jpw.pallas_potential_energy(pos, mass, G, EPS, mask=jnp.asarray(mask),
                                    interpret=True))
    _assert_rel(tpw.potential_energy(tp, tm, G, EPS),
                jforces.potential_energy(pos, mass, G, EPS))


def test_b2_cross_twin_matches_pallas():
    pos, _, mass = _random_system(300, seed=11)
    a, b, ma, mb = pos[:120], pos[120:], mass[:120], mass[120:]
    _assert_rel(tpw.cross_potential(*_t(a, ma, b, mb), G, EPS),
                jpw.pallas_cross_potential(a, ma, b, mb, G, EPS, interpret=True))


def test_chunked_potential_energy_matches_jax():
    """C diagonal + C(C-1)/2 cross terms count every unordered pair once."""
    pos, _, mass = _random_system(300, seed=12)
    got = tpw.chunked_potential_energy(*_t(pos, mass), G, EPS, chunk=110)
    _assert_rel(got, jpw.chunked_potential_energy(pos, mass, G, EPS, chunk=110,
                                                  interpret=True))
    _assert_rel(got, tpw.potential_energy(*_t(pos, mass), G, EPS))


@pytest.mark.parametrize("ni,nj,sms", [(3, 3, 132), (25, 25, 132), (500, 500, 132),
                                       (500, 500, 16), (1000, 1000, 132), (20_000, 20_000, 132),
                                       (50_000, 50_000, 132), (100_000, 100_000, 132),
                                       (4096, 1_000_000, 132), (4096, 1 << 20, 114),
                                       (1, 1_000_000, 132), (128, 0, 132)])
def test_b1_split_rule_covers_the_sources_once_in_order(ni, nj, sms):
    """B1's chunks of sources (one launch for one chunk, a second launch
    adds several in order): whole tiles, every source in exactly one chunk in
    ascending order, none empty; one chunk for every N <= 500 shape of the
    recipe datagen and wherever the target tiles alone fill the card."""
    chunk = tpw.force_chunk(ni, nj, sms)
    chunks = max(1, -(-nj // chunk))
    tiles = -(-ni // tpw._B1_ROWS)
    if chunks == 1:
        assert chunk >= nj and (nj <= 500 or tiles >= tpw._B1_FULL_BLOCKS * sms
                                or nj < 2 * tpw._B1_MIN_CHUNK)
        return
    assert chunk % tpw._B1_TILE == 0 and chunk >= tpw._B1_MIN_CHUNK - tpw._B1_TILE
    assert tiles < tpw._B1_FULL_BLOCKS * sms and chunks <= 65535
    bounds = [(c * chunk, min(nj, (c + 1) * chunk)) for c in range(chunks)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == nj
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # every SM gets several blocks, unless the chunks are at their least size
    assert tiles * chunks >= 4 * sms or chunk <= tpw._B1_MIN_CHUNK + tpw._B1_TILE


def test_b1_split_rule_uses_the_kernels_launch_shape():
    """The split rule's targets a block and sources a tile are FORCE_ROWS
    and TILE of csrc/pairwise.cu, read from the source, so a change of the
    kernel's launch shape cannot leave the rule counting other tiles."""
    src = (Path(tpw.__file__).parents[1] / "csrc" / "pairwise.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    assert (consts["FORCE_ROWS"], consts["TILE"]) == (tpw._B1_ROWS, tpw._B1_TILE)
    assert tpw._B1_MIN_CHUNK % consts["TILE"] == 0


def _kernel_consts(name):
    src = (Path(tpw.__file__).parents[1] / "csrc" / name).read_text()
    consts = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        consts[key] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


def _near_walk(n_ids, src_block, tile, seg_ids):
    """A replica of near_force_kernel's candidate walk: per tile, the global
    candidate index of its first slot and the (list position, row) that
    each thread stages there (-1 for none), from the kernel's counters."""
    tid = np.arange(tile)
    k0, r0 = tid // src_block, tid % src_block  # the one divide
    dk, dr = tile // src_block, tile % src_block
    tiles = []
    for seg in range(0, n_ids, seg_ids):
        nk = min(seg_ids, n_ids - seg)
        k, r = k0.copy(), r0.copy()
        for base in range(0, nk * src_block, tile):
            live = k < nk
            tiles.append((seg * src_block + base, np.where(live, seg + k, -1),
                          np.where(live, r, -1)))
            k, r = k + dk, r + dr
            carry = r >= src_block
            k, r = k + carry, r - carry * src_block
    return tiles


@pytest.mark.parametrize("n_ids,src_block", [(32, 256), (48, 32), (3, 17), (5, 300), (1, 1),
                                             (0, 7), (1500, 1), (2100, 3), (1030, 256)])
def test_near_list_walk_reads_each_candidate_once_in_order(n_ids, src_block):
    """B1's near list stages candidate c = k * src_block + r of a group at
    slot c % TILE of tile c // TILE, for any src_block and for id lists
    longer than one staged segment (NEAR_IDS): the tiles of B1 on the
    gathered candidates, so the same sums in the same order."""
    consts = _kernel_consts("pairwise.cu")
    tile, seg_ids = consts["TILE"], consts["NEAR_IDS"]
    assert consts["FORCE_ROWS"] == tpw._B1_ROWS and seg_ids % tile == 0
    walk = _near_walk(n_ids, src_block, tile, seg_ids)
    ncand = n_ids * src_block
    assert [start for start, _, _ in walk] == list(range(0, ncand, tile))
    for start, k, r in walk:
        c = start + np.arange(tile)
        want_k = np.where(c < ncand, c // src_block, -1)
        want_r = np.where(c < ncand, c % src_block, -1)
        assert (k == want_k).all() and (r == want_r).all()


def test_cpu_calls_use_the_twin_and_count_no_launch():
    pos, _, mass = _random_system(20, seed=4)
    tp, tm = _t(pos, mass)
    b1, b2 = tpw.partial_accelerations.launches, tpw.pair_potential.launches
    tpw.accelerations(tp, tm, G, EPS)
    tpw.potential_energy(tp, tm, G, EPS)
    tpw.cross_potential(tp[:10], tm[:10], tp[10:], tm[10:], G, EPS)
    assert (tpw.partial_accelerations.launches, tpw.pair_potential.launches) == (b1, b2)


def test_wrappers_reject_devices_without_kernel_or_twin():
    pos = torch.zeros((4, 3), device="meta")
    mass = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        tpw.partial_accelerations(pos, pos, mass, G, EPS)
    with pytest.raises(ValueError):
        tpw.pair_potential(pos, mass, pos, mass, G, EPS, masked=True)


def _items_before(t, ct, masked):
    """Items of the row tiles before ``t`` (masked, row s holds ct - s)."""
    return t * ct - t * (t - 1) // 2 if masked else t * ct


def _block_tiles(plan, block, masked):
    """The (row tile, column tile) items block ``block`` of a B2 launch
    walks, in its order, as ``energy_kernel`` finds them from its block
    index (csrc/pairwise.cu)."""
    rt, ct, items, blocks = (plan[k] for k in ("row_tiles", "col_tiles", "items", "blocks"))
    lo, hi = block * items // blocks, (block + 1) * items // blocks
    if masked:
        t = max(s for s in range(rt) if _items_before(s, ct, True) <= lo) if rt else 0
        c = t + lo - _items_before(t, ct, True)
    else:
        t, c = divmod(lo, ct)
    for _ in range(lo, hi):
        yield t, c
        c += 1
        if c == ct:
            t += 1
            c = t if masked else 0


def _b2_pairs(ni, nj, masked, sms):
    """Every (i, j) pair the B2 launch plan visits, with its count: each
    block's tile items as the kernel walks them, all pairs of a tile, the
    diagonal tiles of the masked form only j > i."""
    plan = tpw.energy_tiles(ni, nj, masked, sms)
    seen = np.zeros((ni, nj), np.int32)
    tile = tpw._B2_TILE
    for blk in range(plan["blocks"]):
        for t, c in _block_tiles(plan, blk, masked):
            rows = np.arange(t * tile, min((t + 1) * tile, ni))[:, None]
            cols = np.arange(c * tile, min((c + 1) * tile, nj))[None, :]
            keep = (cols > rows) if (masked and t == c) else np.ones_like(cols > rows)
            seen[rows, cols] += keep
    return plan, seen


@pytest.mark.parametrize("ni,nj,masked,sms", [(3, 3, True, 132), (25, 25, True, 132),
                                              (50, 50, True, 132), (100, 100, True, 132),
                                              (250, 250, True, 132), (500, 500, True, 132),
                                              (1000, 1000, True, 16), (1500, 1500, True, 3),
                                              (300, 700, False, 132), (129, 1, False, 2),
                                              (1000, 900, False, 5)])
def test_b2_tile_plan_covers_each_pair_once(ni, nj, masked, sms):
    """B2's one launch (``energy_tiles``) visits each unordered pair of one
    set exactly once (masked), or each (i, j) of two sets once; no block is
    empty, there are at most ``_B2_BLOCKS_PER_SM`` blocks an SM, and every
    recipe size (N <= 500) gives each tile its own block."""
    plan, seen = _b2_pairs(ni, nj, masked, sms)
    want = np.triu(np.ones((ni, nj), np.int32), 1) if masked else np.ones((ni, nj), np.int32)
    np.testing.assert_array_equal(seen, want)
    assert 1 <= plan["blocks"] <= min(plan["items"], tpw._B2_BLOCKS_PER_SM * sms)
    assert all(plan["items"] * (b + 1) // plan["blocks"] > plan["items"] * b // plan["blocks"]
               for b in range(plan["blocks"]))
    if masked and ni <= 500:
        assert plan["blocks"] == plan["items"]


@pytest.mark.parametrize("n,sms", [(20_000, 132), (100_000, 132), (1_000_000, 114)])
def test_b2_tile_plan_at_large_n(n, sms):
    """At the ground-truth and audit sizes the blocks' item ranges tile the
    upper triangle of tiles in row-major order, without gaps or overlaps,
    and differ by at most one item."""
    plan = tpw.energy_tiles(n, n, True, sms)
    rt = plan["row_tiles"]
    assert plan["items"] == rt * (rt + 1) // 2 and plan["blocks"] == tpw._B2_BLOCKS_PER_SM * sms
    sizes = {plan["items"] * (b + 1) // plan["blocks"] - plan["items"] * b // plan["blocks"]
             for b in range(plan["blocks"])}
    assert max(sizes) - min(sizes) <= 1
    for blk in (0, 1, plan["blocks"] // 2, plan["blocks"] - 1):
        tiles = list(_block_tiles(plan, blk, True))
        assert all(0 <= t <= c < rt for t, c in tiles)
        assert all((t2, c2) > (t1, c1) for (t1, c1), (t2, c2) in zip(tiles, tiles[1:]))


def test_b2_plan_uses_the_kernels_tiles():
    """``_B2_TILE`` is E_ROWS and E_TILE of csrc/pairwise.cu, read from the
    source: square tiles, so only diagonal tiles straddle the diagonal; and
    ``_B2_BLOCKS_PER_SM`` is the kernel's E_BLOCKS_PER_SM, its launch
    bound's blocks an SM."""
    src = (Path(tpw.__file__).parents[1] / "csrc" / "pairwise.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr.split("//")[0].replace("/", "//"), {}, dict(consts))
    assert consts["E_ROWS"] == consts["E_TILE"] == tpw._B2_TILE
    assert consts["E_BLOCKS_PER_SM"] == tpw._B2_BLOCKS_PER_SM
    assert "__launch_bounds__(E_THREADS, E_BLOCKS_PER_SM)\nenergy_kernel(" in src


@pytest.mark.parametrize("n", [3, 500])
def test_b2_energy_work_counts_upper_triangle(n):
    flops, nbytes = tpw.energy_work(n, n, True)
    assert flops == 13.0 * n * (n - 1) / 2 and nbytes == 16.0 * n + 4
    assert tpw.energy_work(n, 2 * n, False) == (13.0 * 2 * n * n, 48.0 * n + 4)
