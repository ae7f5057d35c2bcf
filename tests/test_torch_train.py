"""The port's training path against the JAX package: the plateau scheduler's
LR traces, one Adam step against optax, and per-epoch losses of
``Trainer.train_from_dir`` from the same initial weights on one JAX-written
dataset (GNN bucketed and reference, a narrow ContConv with batch norm in
mixed mode); then, in the port alone, bit-exact resume with dropout, the
early stop's checkpoint, ``test_from_dir(model_path=...)``, the eval-mode
forward of the rollout functions and the rollout evaluation's untimed
warm-up.

Bars: losses and batch-norm statistics rtol 2e-4, the JAX package's own bar
for a data-parallel run against a single-device one (tests/test_trainer.py
205-219); Adam 1e-6 relative (torch and optax round the update in another
order); resume exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbody_tpu.data.dataset import BatchIterator as JBatchIterator
from nbody_tpu.data.dataset import SnapshotDataset as JSnapshotDataset
from nbody_tpu.data.generate import ScenarioConfig as JScenario
from nbody_tpu.data.generate import generate_dataset as jgenerate_dataset
from nbody_tpu.models import ContinuousConvModel as JContConv
from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.train import PlateauScheduler as JPlateau
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu.train.optim import make_optimizer as jmake_optimizer
from nbody_tpu_torch.models import (ContinuousConvModel, GraphModel, MaskedBatchNorm,
                                    contconv_model_state_dict, graph_model_state_dict)
from nbody_tpu_torch.train import CheckpointManager, PlateauScheduler, Trainer, make_optimizer
from nbody_tpu_torch.train.graphs import build_graph

DT = 1e-4
GNN = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
           neighbors=4, scale_factor=1e6)
CONTCONV = dict(in_channels=4, out_channels=3, filter_resolution=(3, 2), radius=1.0,
                agg="mean", self_loops=True, continuous_conv_layers=2,
                continuous_conv_dim=8, encoder_hiddens=(8, 12), decoder_hiddens=(8,),
                scale_factor=1e6)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    train_dir, test_dir = root / "train", root / "test"
    train_dir.mkdir(), test_dir.mkdir()
    jgenerate_dataset([
        JScenario(n_bodies=8, sim_type="spiral", steps=20, seed=1, force_backend="dense"),
        JScenario(n_bodies=12, sim_type="disk", steps=20, seed=2, force_backend="dense"),
    ], str(train_dir / "f1.csv"), verbose=False)
    jgenerate_dataset([JScenario(n_bodies=8, sim_type="spiral", steps=10, seed=3,
                                 force_backend="dense")],
                      str(test_dir / "t1.csv"), verbose=False)
    return str(train_dir), str(test_dir)


@pytest.mark.parametrize("kw,metrics", [
    (dict(lr=1.0, factor=0.5, patience=2), [10.0, 9.0, 9.0, 9.0, 9.0, 8.0, 8.0]),
    (dict(lr=1.0, factor=0.5, patience=1, cooldown=2),
     [10.0, 10.0, 10.0, 5.0, 10.0, 10.0, 10.0]),
])
def test_plateau_scheduler_traces_match_jax(kw, metrics):
    js, ts = JPlateau(**kw), PlateauScheduler(**kw)
    assert [ts.step(m) for m in metrics] == [js.step(m) for m in metrics]
    assert ts.state_dict() == js.state_dict()


def test_adam_steps_match_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    tx = jmake_optimizer(3e-3)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([p], 3e-3)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def _pair(kind, train_dir, batch_size):
    """A JAX trainer with its initial state and the port's trainer on a
    model holding the same weights."""
    jmodel = (JGraphModel if kind == "gnn" else JContConv)(**(GNN if kind == "gnn" else CONTCONV))
    jt = JTrainer(jmodel, learning_rate=0.01, dt=DT, seed=0)
    ds = JSnapshotDataset.from_file(os.path.join(train_dir, "f1.csv"))
    jt._ensure_state(next(iter(JBatchIterator(ds, batch_size, shuffle=False))))
    if kind == "gnn":
        model = GraphModel(**GNN)
        model.load_state_dict(graph_model_state_dict(jax.tree_util.tree_map(
            np.asarray, jt.state.params)))
    else:
        model = ContinuousConvModel(**CONTCONV)
        model.load_state_dict(contconv_model_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": jt.state.params, "batch_stats": jt.state.batch_stats})))
    return jt, Trainer(model, learning_rate=0.01, dt=DT, seed=0)


@pytest.mark.parametrize("kind,mode", [("gnn", "bucketed"), ("gnn", "reference"),
                                       ("contconv", "mixed")])
def test_train_losses_match_jax(tiny_data, kind, mode):
    train_dir, _ = tiny_data
    jt, tt = _pair(kind, train_dir, 8)
    want, want_mse = jt.train_from_dir(train_dir, epochs=3, batch_size=8,
                                       batch_mode=mode, verbose=False)
    got, got_mse = tt.train_from_dir(train_dir, epochs=3, batch_size=8,
                                     batch_mode=mode, verbose=False)
    assert tt.epoch == 3
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(got_mse, want_mse, rtol=4e-4)  # mse = (loss/s)^2
    if kind == "contconv":
        _assert_state_matches(jt, tt, noisy=_pre_norm_biases(tt.model))


def _pre_norm_biases(model):
    """The biases of the Linear layers that feed a batch norm, and the
    running means that follow them. A batch norm in train mode subtracts
    the batch mean, so such a bias has a zero gradient up to rounding, and
    Adam moves it by about +-lr on the sign of that rounding noise, in
    either package; the loss does not see it."""
    enc = model.encoder
    return ({f"encoder.layers.{i}.bias" for i in range(len(enc.norms))}
            | {f"encoder.norms.{i}.running_mean" for i in range(len(enc.norms))})


def _assert_state_matches(jt, tt, noisy=()):
    want = contconv_model_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        if name not in noisy:
            np.testing.assert_allclose(t.numpy(), np.asarray(want[name]), rtol=2e-4,
                                       atol=1e-6, err_msg=name)


def test_batch_norm_statistics_of_a_step_match_jax(tiny_data):
    """One mixed batch of every snapshot: the step's forward runs on the
    converted initial weights, so the running means (which later follow
    the noise-driven pre-norm biases) agree too."""
    train_dir, _ = tiny_data
    jt, tt = _pair("contconv", train_dir, 64)
    want, _ = jt.train_from_dir(train_dir, epochs=1, batch_size=64, batch_mode="mixed",
                                verbose=False)
    got, _ = tt.train_from_dir(train_dir, epochs=1, batch_size=64, batch_mode="mixed",
                               verbose=False)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _assert_state_matches(jt, tt, noisy={n for n in _pre_norm_biases(tt.model)
                                         if n.endswith(".bias")})


def _dropout_trainer():
    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1, aggr="mean",
                       neighbors=4, scale_factor=1e6, node_encoder_dims=(8,),
                       encoder_dropout=0.3, generator=torch.Generator().manual_seed(0))
    return Trainer(model, learning_rate=0.01, dt=DT, seed=0,
                   scheduler=PlateauScheduler(lr=0.01, factor=0.5, patience=1))


def test_resume_is_bit_exact_with_dropout(tiny_data, tmp_path):
    train_dir, _ = tiny_data
    full = _dropout_trainer()
    full_losses, _ = full.train_from_dir(train_dir, epochs=4, batch_size=8, verbose=False)
    save = str(tmp_path / "ckpt")
    first = _dropout_trainer()
    first.train_from_dir(train_dir, epochs=2, batch_size=8, save_every=2, save_path=save,
                         verbose=False)
    resumed = _dropout_trainer()
    resumed_losses, _ = resumed.train_from_dir(train_dir, epochs=2, batch_size=8,
                                               save_path=save, verbose=False)
    assert resumed.epoch == 4 and resumed_losses == full_losses[2:]
    for a, b in zip(full.model.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    assert resumed.scheduler.state_dict() == full.scheduler.state_dict()


def test_early_stop_checkpoints_the_stop_epoch(tiny_data, tmp_path):
    train_dir, _ = tiny_data
    save = str(tmp_path / "ckpt")
    trainer = Trainer(GraphModel(**GNN), dt=DT)
    losses, _ = trainer.train_from_dir(train_dir, epochs=10, batch_size=8, verbose=False,
                                       save_every=5, save_path=save,
                                       on_epoch_end=lambda e, l, m: e >= 3)
    assert len(losses) == 3 and trainer.epoch == 3
    assert CheckpointManager(save).latest_step() == 3
    again = Trainer(GraphModel(**GNN), dt=DT)
    losses2, _ = again.train_from_dir(train_dir, epochs=2, batch_size=8, verbose=False,
                                      save_every=5, save_path=save)
    assert again.epoch == 5 and len(losses2) == 2


def test_test_from_dir_loads_the_checkpoint(tiny_data, tmp_path):
    train_dir, test_dir = tiny_data
    save = str(tmp_path / "ckpt")
    trained = Trainer(GraphModel(**GNN), dt=DT)
    trained.train_from_dir(train_dir, epochs=1, batch_size=8, save_every=1, save_path=save,
                           verbose=False)
    fresh = Trainer(GraphModel(**GNN, generator=torch.Generator().manual_seed(5)), dt=DT)
    df_step, df_roll = fresh.test_from_dir(test_dir, model_path=save, sim_steps=10)
    for a, b in zip(trained.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    want_step, want_roll = trained.test_from_dir(test_dir, sim_steps=10)
    assert list(df_step.columns) == ["loss", "step_time"]
    assert df_step.index.names == ["filename", "scene"]
    assert list(df_roll.columns) == ["pos_rmse", "vel_rmse", "acc_rmse", "step_time"]
    assert df_roll.index.names == ["filename", "scene", "step"]
    np.testing.assert_array_equal(df_step["loss"].to_numpy(), want_step["loss"].to_numpy())
    np.testing.assert_array_equal(df_roll["pos_rmse"].to_numpy(),
                                  want_roll["pos_rmse"].to_numpy())


def test_checkpoint_manager_latest_by_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.restore_latest() == (None, None)
    for step in (2, 10, 9):
        mgr.save(step, {"step": step, "w": torch.full((2,), float(step))})
    (tmp_path / "c" / "notes.txt").write_text("not a checkpoint")
    step, tree = mgr.restore_latest()
    assert step == 10 and tree["step"] == 10 and torch.equal(tree["w"], torch.full((2,), 10.0))
    mgr.delete(10)
    assert mgr.latest_step() == 9
    assert not [f for f in os.listdir(tmp_path / "c") if f.endswith(".tmp")]


def _norm_state(model):
    return {name: buf.clone() for name, buf in model.named_buffers()}


def test_rollout_and_predict_run_in_eval_mode_and_restore_the_mode(tiny_data):
    """``predict_accelerations`` and ``autoregressive_rollout`` apply the
    model as the JAX functions do (``train=False``), whatever mode the module
    was left in: after ``train_from_dir`` it is in ``train()``, and the
    result equals the one after ``.eval()``, the batch norms' running
    statistics stay as they were, and the module's mode comes back."""
    from nbody_tpu_torch.train import autoregressive_rollout, predict_accelerations

    train_dir, _ = tiny_data
    trainer = Trainer(ContinuousConvModel(**CONTCONV, generator=torch.Generator().manual_seed(2)),
                      learning_rate=0.01, dt=DT)
    trainer.train_from_dir(train_dir, epochs=1, batch_size=8, verbose=False)
    model = trainer.model
    assert model.training and any(isinstance(m, MaskedBatchNorm) for m in model.modules())
    rng = np.random.default_rng(4)
    pos, vel = (torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32)) for _ in range(2))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 20).astype(np.float32))
    before = _norm_state(model)
    got = predict_accelerations(model, pos, vel, mass)
    got_roll = autoregressive_rollout(model, pos, vel, mass, 4, DT, graph_refresh=2)
    assert model.training and all(m.training for m in model.modules())
    for name, buf in _norm_state(model).items():
        assert torch.equal(buf, before[name]), name
    model.eval()
    assert torch.equal(got, predict_accelerations(model, pos, vel, mass))
    want_roll = autoregressive_rollout(model, pos, vel, mass, 4, DT, graph_refresh=2)
    assert all(torch.equal(g, w) for g, w in zip(got_roll, want_roll))
    assert not model.training
    model.train()  # a batch of 20 in train mode is another function: the test has teeth
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, pos[None])
    with torch.no_grad():
        assert not torch.allclose(model(x, idx, valid)[0], got)


def test_evaluate_rollout_warms_each_shape_once_untimed(tiny_data, monkeypatch):
    """The rollout evaluation runs each (N, steps, graph spec) once untimed
    before the timed run, as the JAX trainer keeps compilation out of
    ``step_time``; a shape that was warmed is not warmed again."""
    from nbody_tpu_torch.train import trainer as trainer_module

    _, test_dir = tiny_data
    events = []
    real_rollout, real_time = trainer_module.autoregressive_rollout, trainer_module.device_time

    def rollout(model, pos0, *args, **kwargs):
        events.append(("rollout", pos0.shape[0], args[2]))
        return real_rollout(model, pos0, *args, **kwargs)

    def timed(fn, dev):
        events.append(("timed",))
        return real_time(fn, dev)

    monkeypatch.setattr(trainer_module, "autoregressive_rollout", rollout)
    monkeypatch.setattr(trainer_module, "device_time", timed)
    trainer = Trainer(GraphModel(**GNN), dt=DT)
    _, first = trainer.test_from_dir(test_dir, sim_steps=10, stepwise=False)
    assert events == [("rollout", 8, 10), ("timed",), ("rollout", 8, 10)]
    events.clear()
    _, again = trainer.test_from_dir(test_dir, sim_steps=10, stepwise=False)
    assert events == [("timed",), ("rollout", 8, 10)]
    events.clear()
    trainer.test_from_dir(test_dir, sim_steps=6, stepwise=False)  # another shape
    trainer.test_from_dir(test_dir, sim_steps=10, stepwise=False,
                          rollout_graph_spec=("knn", {"k": 3}))  # another graph
    assert [e for e in events if e[0] == "rollout"] == [
        ("rollout", 8, 6)] * 2 + [("rollout", 8, 10)] * 2
    np.testing.assert_array_equal(first["pos_rmse"].to_numpy(), again["pos_rmse"].to_numpy())
    assert (first["step_time"] > 0).all()
