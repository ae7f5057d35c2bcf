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
