"""Scene groups in the port against the JAX package: the batched plain B1 and
B2 against ``jax.vmap`` of the Pallas kernels in interpret mode, the batched
``simulate`` against ``jax.vmap(simulate)`` on JAX-made initial conditions,
the grouping rule against JAX's ``_group_scenarios``, and grouped against
ungrouped port datasets.

Bars: accelerations atol 2e-5 on max-scaled values (tests/test_forces.py:
56,65), energies 1e-5 relative (tests/test_forces.py:120-127), trajectories
those of tests/test_torch_simulate.py (positions and velocities rtol 1e-5
atol 1e-7), datasets ``assert_frame_equal(rtol=1e-5, atol=1e-9)`` without
``step_time`` (tests/test_datagen.py:17-27). A group's scenes run the plain
versions scene by scene, and the treecodes' reductions scene by scene, so
those cases hold bit equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from nbody_tpu.core.simulate import SimulationConfig as JConfig
from nbody_tpu.core.simulate import simulate as jsimulate
from nbody_tpu.data.generate import _group_scenarios as j_group_scenarios
from nbody_tpu.data.generate import scenario_product as jscenario_product
from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ops import pairwise as jpw
from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.core.simulate import make_acc_fn
from nbody_tpu_torch.data import generate as tgen
from nbody_tpu_torch.ops import pairwise as tpw

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def _systems(s, n, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(s, n, 3)) * 3).astype(np.float32)
    vel = (rng.normal(size=(s, n, 3)) * 0.1).astype(np.float32)
    mass = rng.uniform(0.1, 1.0, size=(s, n)).astype(np.float32)
    return pos, vel, mass


def _scaled_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=2e-5)


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), (got, want)


@pytest.mark.parametrize("kw", [
    dict(n_bodies=[4, 8], steps=3, sim_type="disk", seed=[1, 2, 3]),
    dict(n_bodies=[6, 9], steps=4, sim_type="spiral", seed=[5, 6], force_backend="dense"),
    dict(n_bodies=[6], steps=4, sim_type=["disk", "spiral"], seed=[5, 6, 5]),
])
def test_grouping_matches_jax(kw):
    """The port's groups are JAX's on tests/test_datagen.py's scenario lists
    (test_grouping, test_mixed_groups_roundtrip) and on one with a seed
    repeated."""
    want = [[sid for sid, _ in g] for g in j_group_scenarios(jscenario_product(**kw))]
    got = [[sid for sid, _ in g] for g in tgen._group_scenarios(tgen.scenario_product(**kw))]
    assert got == want


@pytest.mark.parametrize("ni,nj", [(3, 3), (64, 64), (17, 40)])
def test_batched_plain_b1_matches_vmapped_pallas(ni, nj):
    pos, _, mass = _systems(3, nj, seed=ni)
    tgt = pos[:, :ni].copy()
    want = jax.vmap(lambda q, p, m: jpw.pallas_partial_accelerations(
        q, p, m, G, EPS, interpret=True))(tgt, pos, mass)
    got = tpw.partial_accelerations(torch.from_numpy(tgt), torch.from_numpy(pos),
                                    torch.from_numpy(mass), G, EPS)
    assert got.shape == (3, ni, 3)
    _scaled_close(got.numpy(), want)
    for s in range(3):  # scene s of the group is scene s alone
        one = tpw.partial_accelerations(torch.from_numpy(tgt[s]), torch.from_numpy(pos[s]),
                                        torch.from_numpy(mass[s]), G, EPS)
        assert torch.equal(got[s], one)


@pytest.mark.parametrize("n", [3, 64, 200])
def test_batched_plain_b2_matches_vmapped_pallas(n):
    pos, _, mass = _systems(3, n, seed=n)
    want = jax.vmap(lambda p, m: jpw.pallas_potential_energy(
        p, m, G, EPS, interpret=True))(pos, mass)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = tpw.potential_energy(tp, tm, G, EPS)
    assert got.shape == (3,) and got.dtype == torch.float32
    _rel_close(got.numpy(), want)
    for s in range(3):
        assert torch.equal(got[s], tpw.potential_energy(tp[s], tm[s], G, EPS))
    a = n // 3 + 1  # the cross form, two disjoint sets a scene
    want_x = jax.vmap(lambda p, m: jpw.pallas_cross_potential(
        p[:a], m[:a], p[a:], m[a:], G, EPS, interpret=True))(pos, mass)
    got_x = tpw.cross_potential(tp[:, :a], tm[:, :a], tp[:, a:], tm[:, a:], G, EPS)
    _rel_close(got_x.numpy(), want_x)


def test_batched_entry_points_share_the_mask():
    """A mask (N,) is shared by a group's scenes: masses folded, masked
    rows zero, as ``jax.vmap`` of the masked JAX entry points gives."""
    pos, _, mass = _systems(2, 40, seed=4)
    mask = np.arange(40) < 33
    want_a = jax.vmap(lambda p, m: jpw.pallas_accelerations(
        p, m, G, EPS, mask=jnp.asarray(mask), interpret=True))(pos, mass)
    want_u = jax.vmap(lambda p, m: jpw.pallas_potential_energy(
        p, m, G, EPS, mask=jnp.asarray(mask), interpret=True))(pos, mass)
    tp, tm, tmask = torch.from_numpy(pos), torch.from_numpy(mass), torch.from_numpy(mask)
    got_a = tpw.accelerations(tp, tm, G, EPS, mask=tmask)
    assert torch.all(got_a[:, 33:] == 0)
    _scaled_close(got_a.numpy(), want_a)
    _rel_close(tpw.potential_energy(tp, tm, G, EPS, mask=tmask).numpy(), want_u)


def _jax_group(s, n, seed):
    ics = [jgenerate_spiral(jax.random.PRNGKey(seed + i), n, g_const=G) for i in range(s)]
    return tuple(np.stack([np.array(x[f]) for x in ics]) for f in range(3))


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_batched_simulate_matches_vmapped_jax(backend):
    pos, vel, mass = _jax_group(3, 48, seed=7)
    steps = 30
    cfg = JConfig(g_const=G, softening=EPS, dt=DT, calc_energy=True, force_backend="dense")
    want = jax.vmap(lambda p, v, m: jsimulate(p, v, m, steps, cfg))(pos, vel, mass)
    got = simulate(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(mass),
                   steps, SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                           calc_energy=True, force_backend=backend))
    # jax.vmap puts the scene axis first; the port's trajectory is step-major
    assert got.positions.shape == (steps, 3, 48, 3) and got.u_energy.shape == (steps, 3)
    for g_, w_ in ((got.positions, want.positions), (got.velocities, want.velocities)):
        np.testing.assert_allclose(g_.numpy(), np.swapaxes(np.asarray(w_), 0, 1),
                                   rtol=1e-5, atol=1e-7)
    _scaled_close(got.accelerations.numpy(), np.swapaxes(np.asarray(want.accelerations), 0, 1))
    for g_, w_ in ((got.u_energy, want.u_energy), (got.k_energy, want.k_energy)):
        _rel_close(g_.numpy(), np.asarray(w_).T)


@pytest.mark.parametrize("backend", ["dense", "kernel", "bh"])
def test_batched_simulate_is_each_scene_alone(backend):
    """Scene s of a group's trajectory (and, for the direct-sum backends, of
    ``make_acc_fn`` on the group) equals a run of scene s alone: bit for bit
    through the plain B1/B2 and the treecode (one group partition), at the
    trajectory bars through the batched dense path."""
    pos, vel, mass = (torch.from_numpy(x) for x in _jax_group(3, 40, seed=2))
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, force_backend=backend,
                           bh_block=8, bh_near=2, bh_refresh=2)
    group = simulate(pos, vel, mass, 6, cfg)
    acc = make_acc_fn(mass, cfg)(pos) if backend != "bh" else None
    for s in range(3):
        pairs = list(zip(group, simulate(pos[s], vel[s], mass[s], 6, cfg)))
        if acc is not None:
            pairs.append((acc[None], make_acc_fn(mass[s], cfg)(pos[s])[None]))
        for g_, a_ in pairs:
            if backend == "dense":
                np.testing.assert_allclose(g_[:, s].numpy(), a_.numpy(), rtol=1e-5, atol=1e-7)
            else:
                assert torch.equal(g_[:, s], a_)


def _scenes(backend, **kw):
    return [tgen.ScenarioConfig(n_bodies=10, sim_type="spiral", steps=5, seed=s,
                                force_backend=backend, **kw) for s in (1, 2, 3)]


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_grouped_dataset_matches_ungrouped(tmp_path, backend):
    """tests/test_datagen.py::test_vmapped_matches_sequential on the port."""
    cfgs = _scenes(backend)
    tgen.generate_dataset(cfgs, str(tmp_path / "v.csv"), verbose=False, vmap_scenes=True,
                          device="cpu")
    tgen.generate_dataset(cfgs, str(tmp_path / "s.csv"), verbose=False, vmap_scenes=False,
                          device="cpu")
    dv = pd.read_csv(tmp_path / "v.csv").drop(columns=["step_time"])
    ds = pd.read_csv(tmp_path / "s.csv").drop(columns=["step_time"])
    pd.testing.assert_frame_equal(dv, ds, check_exact=False, rtol=1e-5, atol=1e-9)
    zv, zs = np.load(tmp_path / "v.npz"), np.load(tmp_path / "s.npz")
    assert sorted(zv.files) == sorted(zs.files)
    for key in zv.files:
        if not key.endswith(("_meta", "_type")):
            np.testing.assert_allclose(zv[key], zs[key], rtol=1e-5, atol=1e-9)


def test_group_runs_once_and_splits_per_scene():
    """``run_scenario_group`` gives each scene ``run_scenario``'s ICs and
    rollout, one shared step time (the group's over steps x scenes), and
    refuses a group whose scenes differ by more than the seed."""
    cfgs = _scenes("kernel")
    res = tgen.run_scenario_group(cfgs, device="cpu")
    assert len(res) == 3 and len({r[2] for r in res}) == 1 and res[0][2] > 0
    for cfg, (traj, mass, _) in zip(cfgs, res):
        alone, mass1, _ = tgen.run_scenario(cfg, device="cpu")
        np.testing.assert_array_equal(mass, mass1)
        for g_, a_ in zip(traj, alone):
            assert torch.equal(g_, a_)
    with pytest.raises(AssertionError, match="only by seed"):
        tgen.run_scenario_group(cfgs[:2] + [tgen.ScenarioConfig(n_bodies=10, steps=5, seed=9)],
                                device="cpu")


def test_grouping_rules(tmp_path, monkeypatch):
    """As in JAX: ``time_chunks > 1`` turns grouping off, and a group of one
    runs through ``run_scenario``."""
    calls = []
    real = tgen.run_scenario_group
    monkeypatch.setattr(tgen, "run_scenario_group",
                        lambda cfgs, **kw: calls.append(len(cfgs)) or real(cfgs, **kw))
    out = str(tmp_path / "c.csv")
    tgen.generate_dataset(_scenes("dense"), out, verbose=False, time_chunks=2, device="cpu")
    assert calls == [] and np.load(out[:-4] + ".npz")["scene2_step_time"].shape == (5,)
    mixed = _scenes("dense")[:2] + [tgen.ScenarioConfig(n_bodies=7, steps=5, seed=1)]
    tgen.generate_dataset(mixed, out, verbose=False, device="cpu")
    assert calls == [2]
