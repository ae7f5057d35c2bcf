"""``nbody_tpu_torch.utils.prng`` against ``jax.random`` (JAX's default
threefry2x32, partitionable) on the same seeds.

Bars: keys, ``split``, ``random_bits``, ``uniform``, ``permutation`` and
``choice`` bit for bit; ``normal`` within 2 ulps on at most 1 draw in
10,000 (XLA's CPU ``log`` rounds a few inputs differently from the
Cephes ``logf`` the port writes out), every other draw bit for bit;
``gamma(2)`` within 1e-5 relative on every draw; the known answers of
``chip_smoke.KNOWN_ANSWERS`` equal to JAX's draws and to the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from chip_smoke import KNOWN_ANSWERS, known_answer_mismatches
from nbody_tpu_torch.utils import prng

SEEDS = [0, 42, 1042, 2 ** 31 - 1, -5]
SHAPES = [(), (7,), (3, 5), (100_000,)]


def _ulps(a, b):
    """Distance in float32 ulps (the integers of the sign-magnitude bits)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert key.tolist() == np.asarray(jkey).astype(np.int64).tolist()
    for num in (2, 3, 6, (2, 3)):
        assert np.array_equal(prng.split(key, num).numpy(),
                              np.asarray(jax.random.split(jkey, num)).astype(np.int64))
    # nested splits, the disk's and the spiral's orders
    inner = prng.split(prng.split(key, 3)[1], 6)
    jinner = jax.random.split(jax.random.split(jkey, 3)[1], 6)
    assert np.array_equal(inner.numpy(), np.asarray(jinner).astype(np.int64))


def test_key_words_of_a_negative_seed():
    assert prng.PRNGKey(-5).tolist() == [0, 4294967291]
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed, shape):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(key, shape).numpy(), want)
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (float(np.finfo(np.float32).eps), 1.0),
                   (0.0, 2 * np.pi)]:
        got = prng.uniform(key, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (lo, hi)


@pytest.mark.parametrize("seed", [0, 42, 1042, 7])
def test_normal_within_two_ulps_of_jax(seed):
    got = prng.normal(prng.PRNGKey(seed), (100_000,)).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (100_000,), jnp.float32))
    ulps = _ulps(got, want)
    assert ulps.max() <= 2 and int((ulps > 0).sum()) <= 10, (ulps.max(), (ulps > 0).sum())
    small = prng.normal(prng.PRNGKey(seed), (3, 5)).numpy()
    jsmall = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (3, 5), jnp.float32))
    assert _ulps(small, jsmall).max() <= 2


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    assert _ulps(got[2:], want[2:]).max() <= 2


@pytest.mark.parametrize("seed", [0, 42, 1042])
def test_gamma_matches_jax(seed):
    got = prng.gamma(prng.PRNGKey(seed), 2.0, (20_000,)).numpy()
    want = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), 2.0, (20_000,), jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    got = prng.gamma(prng.PRNGKey(seed), 3.5, (3, 5)).numpy()
    want = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), 3.5, (3, 5), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [1, 10, 1000, 100_000])
@pytest.mark.parametrize("seed", [0, 42, -5])
def test_permutation_and_choice_match_jax(seed, n):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert np.array_equal(prng.permutation(key, n).numpy(),
                          np.asarray(jax.random.permutation(jkey, n)))
    s = min(n, 4096)
    assert np.array_equal(prng.choice(key, n, (s,)).numpy(),
                          np.asarray(jax.random.choice(jkey, n, (s,), replace=False)))


def test_known_answers():
    """The table that the card checks without JAX: JAX's draws and the
    port's, both equal to it."""
    want = KNOWN_ANSWERS
    t0, t1 = jprng.threefry_2x32(jnp.uint32([0, 0]), jnp.uint32([0, 0]))
    assert [int(t0), int(t1)] == want["threefry_00"]
    k = jax.random.PRNGKey(42)
    jax_draws = {
        "split_42_6": np.asarray(jax.random.split(k, 6)).astype(np.int64),
        "bits_42_4": np.asarray(jax.random.bits(k, (4,), jnp.uint32)).astype(np.int64),
        "choice_42_1000_4": np.asarray(jax.random.choice(k, 1000, (4,), replace=False)),
        "uniform_42_4": np.asarray(jax.random.uniform(k, (4,))),
        "normal_42_4": np.asarray(jax.random.normal(k, (4,))),
        "gamma2_42_4": np.asarray(jax.random.gamma(k, 2.0, (4,))),
    }
    for name, draws in jax_draws.items():
        assert np.array_equal(draws, np.asarray(want[name], draws.dtype)), name
    assert known_answer_mismatches("cpu") == []
