"""Port integrators and ``simulate`` against the JAX package on identical
initial conditions.

Bars: step order rtol 1e-6 (tests/test_integrators.py:71-83); whole
trajectories positions/velocities rtol 1e-5 atol 1e-7 and energies relative
1e-5. The slack over the JAX loop-vs-scan bar of 2e-6 covers the JAX dense
path's ``W @ pos - pos * rowsum(W)`` summation order, which the port's dense
path shares only up to the matmul's order and the twin does not share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core import forces as jforces
from nbody_tpu.core import integrators as jint
from nbody_tpu.core.simulate import SimulationConfig as JConfig, simulate as jsimulate
from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu_torch.core import forces as tforces
from nbody_tpu_torch.core import integrators as tint
from nbody_tpu_torch.core.simulate import (SimulationConfig, make_acc_fn,
                                           resolve_backend, simulate)

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def _hand_rolled(pos, vel, acc0, acc_fn, dt):
    v_half = vel + 0.5 * dt * acc0
    x1 = pos + dt * v_half
    a1 = acc_fn(x1)
    lf = (x1, v_half + 0.5 * dt * a1, a1)
    v_e = vel + dt * acc0
    eu = (pos + dt * v_e, v_e, acc0)
    return lf, eu


def test_step_functions_match_reference_order_and_jax():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    vel = rng.normal(size=(5, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1, 5).astype(np.float32)
    g, eps, dt = 1.0, 0.1, 0.01
    tm = torch.from_numpy(mass)

    def acc_fn(p):
        return tforces.pairwise_accelerations(torch.as_tensor(p), tm, g, eps).numpy()

    def tacc(p):
        return tforces.pairwise_accelerations(p, tm, g, eps)

    acc0 = acc_fn(pos)
    lf, eu = _hand_rolled(pos, vel, acc0, acc_fn, dt)
    tp, tv, ta = (torch.from_numpy(a) for a in (pos, vel, acc0))
    for got, want in zip(tint.leapfrog_step(tp, tv, ta, tacc, dt), lf):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for got, want in zip(tint.euler_step(tp, tv, torch.zeros_like(ta), tacc, dt), eu):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    jacc = lambda p: jforces.pairwise_accelerations(p, jnp.asarray(mass), g, eps)  # noqa: E731
    for tstep, jstep in ((tint.leapfrog_step, jint.leapfrog_step),
                         (tint.euler_step, jint.euler_step)):
        got = tstep(tp, tv, ta, tacc, dt)
        want = jstep(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc0), jacc, dt)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-7)


def _jax_ics(n, seed):
    pos, vel, mass = jgenerate_spiral(jax.random.PRNGKey(seed), n, g_const=G)
    return np.array(pos), np.array(vel), np.array(mass)


@pytest.mark.parametrize("integrator", ["leapfrog", "euler"])
@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_simulate_matches_jax(integrator, backend):
    pos, vel, mass = _jax_ics(128, seed=5)
    steps = 100
    want = jsimulate(pos, vel, mass, steps, JConfig(
        g_const=G, softening=EPS, dt=DT, integrator=integrator,
        calc_energy=True, force_backend="dense"))
    got = simulate(torch.from_numpy(pos), torch.from_numpy(vel),
                   torch.from_numpy(mass), steps, SimulationConfig(
                       g_const=G, softening=EPS, dt=DT, integrator=integrator,
                       calc_energy=True, force_backend=backend))
    assert got.positions.shape == (steps, 128, 3)
    for g_, w_ in ((got.positions, want.positions), (got.velocities, want.velocities)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-7)
    acc_w = np.asarray(want.accelerations)
    np.testing.assert_allclose(got.accelerations.numpy() / np.abs(acc_w).max(),
                               acc_w / np.abs(acc_w).max(), atol=1e-4)
    for g_, w_ in ((got.u_energy, want.u_energy), (got.k_energy, want.k_energy)):
        w_ = np.asarray(w_, np.float64)
        assert np.all(np.abs(g_.numpy() - w_) <= 1e-5 * np.abs(w_))


def test_simulate_mask_and_no_energy():
    pos, vel, mass = _jax_ics(24, seed=6)
    mask = np.arange(24) < 20
    want = jsimulate(pos, vel, mass, 10, JConfig(
        g_const=G, softening=EPS, dt=DT, calc_energy=False, force_backend="dense"),
        mask=jnp.asarray(mask))
    for backend in ("dense", "kernel"):
        got = simulate(pos, vel, mass, 10, SimulationConfig(
            g_const=G, softening=EPS, dt=DT, calc_energy=False,
            force_backend=backend), mask=torch.from_numpy(mask))
        assert got.u_energy is None and got.k_energy is None
        np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions),
                                   rtol=1e-5, atol=1e-7)
        assert torch.all(got.accelerations[:, 20:] == 0)


def test_backend_dispatch():
    cfg = SimulationConfig(force_backend="auto")
    assert resolve_backend(cfg, torch.device("cpu")) == "dense"
    assert resolve_backend(cfg, torch.device("cuda")) == "kernel"
    assert resolve_backend(SimulationConfig(force_backend="kernel"), "cpu") == "kernel"
    mass = torch.ones(3)
    acc = make_acc_fn(mass, SimulationConfig(force_backend="kernel", g_const=1.0))(
        torch.eye(3))
    assert acc.shape == (3, 3)
    bh = SimulationConfig(force_backend="bh")  # the treecodes, JAX's defaults
    assert (bh.bh_near, bh.bh_block, bh.bh_refresh, bh.bh_coarse, bh.bh_rc,
            bh.bh_sub_block, bh.bh_n_sub) == (32, 256, 1, 16, 32, 32, 24)
    with pytest.raises(ValueError):  # a treecode takes no mask
        make_acc_fn(mass, bh, mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        SimulationConfig(force_backend="pallas")
    with pytest.raises(ValueError):
        SimulationConfig(integrator="rk4")


def test_leapfrog_energy_conservation_two_body():
    v = np.sqrt(1.0 / 4.0)
    pos = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0]])
    vel = torch.tensor([[0, v, 0], [0, -v, 0]], dtype=torch.float32)
    mass = torch.ones(2)
    cfg = SimulationConfig(g_const=1.0, softening=0.0, dt=1e-3,
                           force_backend="kernel")
    traj = simulate(pos, vel, mass, 2000, cfg)
    e = (traj.u_energy + traj.k_energy).double()
    assert float((e - e[0]).abs().max()) < 1e-4 * abs(float(e[0]))
    radii = traj.positions[:, 0].norm(dim=-1)
    assert float((radii - 1.0).abs().max()) < 1e-3
