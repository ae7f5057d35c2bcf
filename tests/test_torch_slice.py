"""The port's whole slice against the JAX package: JAX initial conditions ->
both ``simulate`` -> both ``autoregressive_rollout`` with converted weights,
and both ``Trainer.test_from_dir`` on one dataset (and the port's from a
checkpoint). Also proves that the port
imports and runs its CPU path with JAX blocked.

Bars: positions and velocities rtol 1e-5, accelerations atol 1e-4 on
max-scaled values, identical step-0 graph."""

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.simulate import SimulationConfig as JConfig, simulate as jsimulate
from nbody_tpu.data.generate import ScenarioConfig as JScenario
from nbody_tpu.data.generate import generate_dataset as jgenerate_dataset
from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.ops.knn import batched_knn_neighbors as jknn
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu.train import autoregressive_rollout as jrollout
from nbody_tpu.train.trainer import TrainState
from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.models import GraphModel, graph_model_state_dict
from nbody_tpu_torch.ops.knn import batched_knn_neighbors as tknn
from nbody_tpu_torch.train import CheckpointManager, Trainer, autoregressive_rollout

REPO = Path(__file__).resolve().parents[1]
G, EPS, DT = 4.5e-6, 0.05, 1e-4
MODEL = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
             neighbors=10, scale_factor=1e6)


def _models(x, seed=0):
    jmodel = JGraphModel(**MODEL)
    idx, valid = jknn(jnp.asarray(x[None, :, :3]), MODEL["neighbors"])
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[None]), idx, valid)
    model = GraphModel(**MODEL).eval()
    model.load_state_dict(graph_model_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, model


def _close_traj(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    a_w = np.asarray(want[2])
    scale = np.abs(a_w).max()
    np.testing.assert_allclose(got[2].numpy() / scale, a_w / scale, atol=1e-4)


@pytest.mark.parametrize("graph_refresh", [1, 4])
def test_slice_matches_jax(graph_refresh):
    n, steps = 64, 30
    pos, vel, mass = (np.array(a) for a in jgenerate_spiral(jax.random.PRNGKey(0), n))
    want = jsimulate(pos, vel, mass, steps, JConfig(
        g_const=G, softening=EPS, dt=DT, force_backend="dense"))
    got = simulate(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(mass),
                   steps, SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                           force_backend="kernel"))
    _close_traj((got.positions, got.velocities, got.accelerations),
                (want.positions, want.velocities, want.accelerations))

    p0, v0 = got.positions[0], got.velocities[0]
    x0 = np.concatenate([p0.numpy(), v0.numpy(), mass[:, None]], axis=-1)
    jmodel, variables, model = _models(x0)
    j_idx, j_valid = jknn(jnp.asarray(p0.numpy()[None]), MODEL["neighbors"])
    t_idx, t_valid = tknn(p0[None], MODEL["neighbors"])
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(np.sort(t_idx.numpy(), -1), np.sort(np.asarray(j_idx), -1))

    r_steps = 20
    want_r = jrollout(jmodel, variables, jnp.asarray(p0.numpy()), jnp.asarray(v0.numpy()),
                      jnp.asarray(mass), r_steps, DT, graph_refresh=graph_refresh)
    got_r = autoregressive_rollout(model, p0, v0, torch.from_numpy(mass), r_steps, DT,
                                   graph_refresh=graph_refresh)
    assert got_r[0].shape == (r_steps, n, 3)
    _close_traj(got_r, want_r)


def test_test_from_dir_matches_jax(tmp_path):
    data = tmp_path / "test"
    data.mkdir()
    scenarios = [JScenario(n_bodies=nb, sim_type="spiral", steps=6, seed=4,
                           force_backend="dense") for nb in (5, 12)]
    jgenerate_dataset(scenarios, str(data / "t.csv"), verbose=False, vmap_scenes=False)
    x = np.random.default_rng(0).normal(size=(12, 7)).astype(np.float32)
    jmodel, variables, model = _models(x)

    jt = JTrainer(jmodel, dt=DT)
    jt.state = TrainState(params=variables["params"], batch_stats={},
                          opt_state=jt.tx.init(variables["params"]))
    j_step, j_roll = jt.test_from_dir(str(data), sim_steps=6)
    t_step, t_roll = Trainer(model, dt=DT).test_from_dir(str(data), sim_steps=6)

    assert list(t_step.columns) == list(j_step.columns) == ["loss", "step_time"]
    assert list(t_step.index) == list(j_step.index)
    np.testing.assert_allclose(t_step["loss"].to_numpy(), j_step["loss"].to_numpy(),
                               rtol=1e-4)
    assert list(t_roll.columns) == list(j_roll.columns)
    assert list(t_roll.index) == list(j_roll.index)
    for col in ("pos_rmse", "vel_rmse", "acc_rmse"):
        t_c, j_c = t_roll[col].to_numpy(), j_roll[col].to_numpy()
        np.testing.assert_allclose(t_c, j_c, rtol=1e-4, atol=1e-6 * np.abs(j_c).max())
    assert (t_step["step_time"] > 0).all() and (t_roll["step_time"] > 0).all()
    # model_path: the latest checkpoint's weights replace the model's own
    saver = Trainer(model, dt=DT)
    saver._ensure_state()
    CheckpointManager(str(tmp_path / "ckpt")).save(1, saver._ckpt_tree())
    other = copy.deepcopy(model)
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    c_step, _ = Trainer(other, dt=DT).test_from_dir(str(data), model_path=str(tmp_path / "ckpt"),
                                                   sim_steps=6, rollout=False)
    np.testing.assert_array_equal(c_step["loss"].to_numpy(), t_step["loss"].to_numpy())


_JAX_FREE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "nbody_tpu"):
    sys.modules[name] = None
import tempfile, os
import torch
import nbody_tpu_torch
from nbody_tpu_torch import core, data, ics, models, ops, train, utils
from nbody_tpu_torch.cli import datagen
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.train import Trainer
d = tempfile.mkdtemp()
datagen.main(["--n-bodies", "5", "9", "--sim-type", "spiral", "--steps", "4",
              "--seed", "1", "--force-backend", "kernel", "--device", "cpu",
              "--output", os.path.join(d, "t.csv")])
m = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=2, aggr="mean",
               neighbors=3, generator=torch.Generator().manual_seed(0))
s, r = Trainer(m, dt=1e-4).test_from_dir(d, sim_steps=4)
assert len(s) == 2 and len(r) == 8
from nbody_tpu_torch.experiments import large_scale
from nbody_tpu_torch.ops import contconv_kernel, interpolate, radius, spatial
res = large_scale.main(["--model", "contconv", "--n-bodies", "600", "--steps", "2",
                        "--hybrid-warmup", "1", "--device", "cpu",
                        "--conv-impl", "kernel", "--knn-impl", "kernel"])
assert set(res) == {"direct", "surrogate", "hybrid"}
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "nbody_tpu")
            and sys.modules[k] is not None]
print("JAX-FREE-OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _JAX_FREE], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE-OK" in out.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|nbody_tpu)\b", re.M)
    files = list((REPO / "nbody_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
