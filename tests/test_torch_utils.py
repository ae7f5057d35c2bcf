"""The port's numerical guards against tests/test_utils.py's cases and
against the JAX package's own guard on the same inputs:
``checked_accelerations`` (checkify's contract: the wrapped call returns
``(err, acc)`` and ``err.throw()`` raises on a NaN or an Inf) and
``assert_finite_state``. Accelerations are held at the forces bar, atol
2e-5 on max-scaled values (tests/test_forces.py:56,65)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.simulate import SimulationConfig as JConfig
from nbody_tpu.core.simulate import make_acc_fn as j_make_acc_fn
from nbody_tpu.utils.debug import checked_accelerations as j_checked_accelerations
from nbody_tpu_torch.core.simulate import SimulationConfig, make_acc_fn
from nbody_tpu_torch.utils import assert_finite_state, checked_accelerations

G, EPS = 4.5e-6, 0.05


def _raises(err) -> bool:
    try:
        err.throw()
    except Exception:
        return True
    return False


def _both(t_fn, j_fn, pos: np.ndarray):
    """(raised, acc) of the port's and of the JAX package's checked call on
    the same positions."""
    t_err, t_acc = t_fn(torch.from_numpy(pos))
    j_err, j_acc = j_fn(jnp.asarray(pos))
    return (_raises(t_err), t_acc.numpy()), (_raises(j_err), np.asarray(j_acc))


def test_checked_accelerations_flags_nan():
    ok = _both(checked_accelerations(lambda p: p * 2.0),
               j_checked_accelerations(lambda p: p * 2.0), np.ones((4, 3), np.float32))
    assert ok[0][0] is ok[1][0] is False
    np.testing.assert_allclose(ok[0][1], 2.0)
    np.testing.assert_array_equal(ok[0][1], ok[1][1])

    bad_fn = checked_accelerations(lambda p: p / torch.zeros_like(p))
    err, _ = bad_fn(torch.ones(4, 3))
    with pytest.raises(FloatingPointError, match="non-finite acceleration"):
        err.throw()
    j_err, _ = j_checked_accelerations(lambda p: p / jnp.zeros_like(p))(jnp.ones((4, 3)))
    assert _raises(j_err)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_checked_accelerations_on_a_force_backend(bad, backend):
    """Wrapping the simulator's own ``pos -> acc``, one scene and a group of
    two (``jax.vmap`` on the JAX side): finite positions pass with the JAX
    package's accelerations, one bad coordinate raises in both packages."""
    rng = np.random.default_rng(3)
    pos = (rng.normal(size=(2, 5, 3)) * 2).astype(np.float32)
    mass = rng.uniform(0.1, 1.0, size=(2, 5)).astype(np.float32)
    cfg = SimulationConfig(g_const=G, softening=EPS, force_backend=backend)
    jcfg = JConfig(g_const=G, softening=EPS, force_backend="dense")
    jm = jnp.asarray(mass)
    cases = [
        (checked_accelerations(make_acc_fn(torch.from_numpy(mass[0]), cfg)),
         j_checked_accelerations(j_make_acc_fn(jm[0], jcfg)), lambda x: x[0]),
        (checked_accelerations(make_acc_fn(torch.from_numpy(mass), cfg)),
         j_checked_accelerations(lambda p: jax.vmap(
             lambda q, m: j_make_acc_fn(m, jcfg)(q))(p, jm)), lambda x: x),
    ]
    for t_fn, j_fn, pick in cases:
        p = pick(pos).copy()
        (t_bad, t_acc), (j_bad, j_acc) = _both(t_fn, j_fn, p)
        assert not t_bad and not j_bad
        assert t_acc.shape == p.shape
        scale = np.abs(j_acc).max()
        np.testing.assert_allclose(t_acc / scale, j_acc / scale, atol=2e-5)
        p[(0,) * (p.ndim - 1) + (1,)] = bad
        (t_bad, _), (j_bad, _) = _both(t_fn, j_fn, p)
        assert t_bad and j_bad


def test_assert_finite_state():
    assert_finite_state(torch.ones(2, 3), torch.zeros(2, 3))
    with pytest.raises(FloatingPointError):
        assert_finite_state(torch.tensor([[float("inf"), 0, 0]]), torch.zeros(1, 3))
