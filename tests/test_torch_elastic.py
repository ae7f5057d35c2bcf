"""Failure detection and elastic restart on the port's ``Trainer``: the eight
cases of tests/test_elastic.py (fault injection into a real training run,
rollback to the last healthy checkpoint, LR backoff, corrupt-checkpoint
skipping, restart-budget exhaustion, scratch restarts, an already finished
run), the argument checks, and fault schedules run through both packages'
``elastic_train`` on the same dataset, held against each other."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu.train import TrainingFault as JTrainingFault
from nbody_tpu.train import elastic_train as j_elastic_train
from nbody_tpu.train.optim import PlateauScheduler as JPlateauScheduler
from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.train import (CheckpointManager, PlateauScheduler, Trainer,
                                   TrainingFault, all_finite, elastic_train)
from nbody_tpu_torch.utils import prng

DT = 1e-4


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    train_dir = tmp_path_factory.mktemp("data") / "train"
    train_dir.mkdir()
    generate_dataset([ScenarioConfig(n_bodies=8, sim_type="spiral", steps=16, seed=1,
                                     force_backend="dense")],
                     str(train_dir / "f1.csv"), verbose=False, device="cpu")
    return str(train_dir)


def _trainer(seed=0, lr=0.01, **kw):
    model = GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
                       neighbors=4, scale_factor=1e6, key=prng.PRNGKey(seed))
    return Trainer(model, learning_rate=lr, dt=DT, seed=0, **kw)


def _nan_params(trainer):
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.fill_(float("nan"))


def _inject_once(trainer, at):
    state = {"armed": True}

    def inject(epoch, losses, mses):
        if epoch == at and state["armed"]:
            state["armed"] = False
            _nan_params(trainer)

    return inject


def test_all_finite():
    assert all_finite({"a": torch.ones(3), "n": torch.arange(4)})
    assert not all_finite({"a": torch.tensor([1.0, float("nan")])})
    assert not all_finite({"a": torch.ones(2), "b": {"c": torch.tensor(float("inf"))}})
    assert all_finite(torch.nn.Linear(2, 2)) and all_finite({})


def test_elastic_recovers_from_injected_fault(tiny_data, tmp_path):
    """Weights corrupted at epoch 3 (after its health check): the check fires
    at epoch 4 before that epoch is saved, the corrupt epoch-3 checkpoint is
    deleted, the run rolls back to epoch 2 and completes every epoch with
    finite losses."""
    trainer = _trainer()
    res = elastic_train(trainer, tiny_data, epochs=6, batch_size=8,
                        save_path=str(tmp_path / "ckpt"), save_every=1, max_restarts=2,
                        verbose=False, on_epoch_end=_inject_once(trainer, 3))
    assert res.restarts == 1
    assert [e for e, _ in res.faults] == [4]
    assert len(res.epoch_losses) == 6
    assert np.isfinite(res.epoch_losses).all()
    assert trainer.epoch == 6
    assert all_finite(trainer.model)


def test_elastic_lr_backoff_applied(tiny_data, tmp_path):
    trainer = _trainer()
    elastic_train(trainer, tiny_data, epochs=4, batch_size=8,
                  save_path=str(tmp_path / "ckpt"), save_every=1, max_restarts=1,
                  lr_backoff=0.5, verbose=False, on_epoch_end=_inject_once(trainer, 2))
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)


def test_elastic_exhausts_restart_budget(tiny_data, tmp_path):
    """A fault that recurs on every attempt re-raises once the budget is
    spent (the callback corrupts the weights after every epoch 2)."""
    trainer = _trainer()

    def always_inject(epoch, losses, mses):
        if epoch == 2:
            _nan_params(trainer)

    with pytest.raises(TrainingFault):
        elastic_train(trainer, tiny_data, epochs=4, batch_size=8,
                      save_path=str(tmp_path / "ckpt"), save_every=1, max_restarts=2,
                      verbose=False, on_epoch_end=always_inject)


def test_elastic_skips_corrupt_checkpoint(tiny_data, tmp_path):
    """A checkpoint holding non-finite weights (a crashed writer) is deleted
    at resume and the next-older healthy one is used instead."""
    save = str(tmp_path / "ckpt")
    trainer = _trainer()
    trainer.train_from_dir(tiny_data, epochs=2, batch_size=8, save_every=1,
                           save_path=save, verbose=False)
    _nan_params(trainer)  # hand-write a corrupt epoch-3 checkpoint
    trainer.epoch = 3
    CheckpointManager(save).save(3, trainer._ckpt_tree())

    trainer2 = _trainer()
    res = elastic_train(trainer2, tiny_data, epochs=4, batch_size=8, save_path=save,
                        save_every=1, max_restarts=0, verbose=False)
    assert res.restarts == 0
    assert trainer2.epoch == 4
    assert all_finite(trainer2.model)
    # resumed from the healthy epoch-2 checkpoint -> re-ran epochs 3 and 4
    assert len(res.epoch_losses) == 2
    assert CheckpointManager(save).latest_step() == 4


def test_elastic_scratch_restart_without_checkpoint(tiny_data, tmp_path):
    """A fault at epoch 1 (before any save) falls back to a scratch restart
    from the weights the run began with, not to the corrupted ones."""
    trainer = _trainer()
    res = elastic_train(trainer, tiny_data, epochs=3, batch_size=8,
                        save_path=str(tmp_path / "ckpt"), save_every=1, max_restarts=1,
                        verbose=False, on_epoch_end=_inject_once(trainer, 1))
    assert res.restarts == 1
    assert trainer.epoch == 3
    assert np.isfinite(res.epoch_losses).all()
    # the restart's first epoch is a fresh run's at the backed-off LR
    fresh = _trainer(lr=0.005)
    losses, _ = fresh.train_from_dir(tiny_data, epochs=1, batch_size=8, verbose=False)
    assert res.epoch_losses[0] == pytest.approx(losses[0], rel=1e-6)


def test_elastic_rerun_already_complete_restores_checkpoint(tiny_data, tmp_path):
    """Running elastic_train again when the target epochs are already
    checkpointed leaves the trainer holding the checkpointed weights, not
    its own fresh ones."""
    ckpt = str(tmp_path / "ckpt")
    t1 = _trainer()
    elastic_train(t1, tiny_data, epochs=3, batch_size=8, save_path=ckpt, save_every=1,
                  verbose=False)
    t2 = _trainer(seed=99)
    res = elastic_train(t2, tiny_data, epochs=3, batch_size=8, save_path=ckpt,
                        save_every=1, verbose=False)
    assert res.restarts == 0 and res.epoch_losses == []
    assert t2.epoch == 3
    for a, b in zip(t1.model.state_dict().values(), t2.model.state_dict().values()):
        assert torch.equal(a, b)


def test_elastic_scratch_restart_resets_scheduler(tiny_data, tmp_path):
    """A fault before the first checkpoint restarts from scratch, the
    PlateauScheduler's state included, which the faulted attempt changed."""
    sched = PlateauScheduler(lr=0.01, factor=0.5, patience=0)
    trainer = _trainer(scheduler=sched)
    state = {"armed": True, "lr_at_restart": None}

    def inject(epoch, losses, mses):
        sched.best = 0.0  # every epoch is a bad one: the plateau fires
        if epoch == 2 and state["armed"]:
            state["armed"] = False
            _nan_params(trainer)
        elif epoch == 1 and not state["armed"]:
            state["lr_at_restart"] = trainer.optimizer.param_groups[0]["lr"]

    elastic_train(trainer, tiny_data, epochs=3, batch_size=8,
                  save_path=str(tmp_path / "ckpt"), save_every=10,  # no save before the fault
                  max_restarts=2, verbose=False, on_epoch_end=inject)
    assert trainer.epoch == 3
    # the restarted run began from the scheduler's first LR times the backoff
    # (0.01 * 0.5), not from the faulted run's decayed LR
    assert state["lr_at_restart"] == pytest.approx(0.005)


def test_elastic_argument_checks(tiny_data, tmp_path):
    with pytest.raises(ValueError):
        elastic_train(_trainer(), tiny_data, epochs=1, batch_size=8,
                      save_path=str(tmp_path / "c"), save_every=0)
    with pytest.raises(FileNotFoundError):
        elastic_train(_trainer(), str(tmp_path), epochs=1, batch_size=8,
                      save_path=str(tmp_path / "c"))


# (epochs, fault epoch, save_every, max_restarts, plateau scheduler, the
# injection recurs on every attempt, epochs trained before elastic_train)
SCHEDULES = {
    "rollback": (6, 3, 1, 2, False, False, 0),
    "scratch": (3, 1, 1, 1, False, False, 0),
    "scheduler_no_save": (3, 2, 10, 2, True, False, 0),
    "budget_spent": (4, 2, 1, 2, False, True, 0),
    # a scratch restart of a trainer that trained (and decayed its LR)
    # before: the optimiser starts afresh at the trainer's learning rate
    "pretrained_scratch": (3, 2, 10, 1, True, False, 1),
}


def _elastic_outcome(make, poison, ckpt_steps, lr_of, tiny_data, save, schedule):
    """Run one fault schedule through an ``elastic_train``: ``make(sched)``
    builds (trainer, elastic_train, fault class), ``poison(trainer)`` turns
    its weights to NaN. The injecting callback returns a truthy value, which
    ``elastic_train`` does not pass on: the run does not stop early."""
    epochs, at, save_every, max_restarts, plateau, always, pretrain = schedule
    trainer, run, fault_cls, sched = make(plateau)
    if pretrain:
        if sched is not None:
            sched.best = 0.0  # the pretraining epochs decay the LR
        trainer.train_from_dir(tiny_data, epochs=pretrain, batch_size=8, verbose=False)
    armed = {"on": True}

    def inject(epoch, losses, mses):
        if sched is not None:
            sched.best = 0.0  # every epoch is a bad one: the plateau fires
        if epoch == at and (always or armed["on"]):
            armed["on"] = False
            poison(trainer)
        return True

    try:
        res = run(trainer, tiny_data, epochs=epochs, batch_size=8, save_path=save,
                  save_every=save_every, max_restarts=max_restarts, verbose=False,
                  on_epoch_end=inject)
        got = dict(restarts=res.restarts, faults=res.faults,
                   n_losses=len(res.epoch_losses),
                   finite=bool(np.isfinite(res.epoch_losses).all()))
    except fault_cls as f:
        got = dict(raised=(f.epoch, f.reason))
    got.update(epoch=trainer.epoch, ckpts=ckpt_steps(save), lr=lr_of(trainer))
    return got


def _jax_make(plateau):
    sched = JPlateauScheduler(lr=0.01, factor=0.5, patience=0) if plateau else None
    model = JGraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
                        neighbors=4, scale_factor=1e6)
    return JTrainer(model, learning_rate=0.01, dt=DT, seed=0, scheduler=sched), \
        j_elastic_train, JTrainingFault, sched


def _port_make(plateau):
    sched = PlateauScheduler(lr=0.01, factor=0.5, patience=0) if plateau else None
    return _trainer(scheduler=sched), elastic_train, TrainingFault, sched


def _jax_poison(trainer):
    trainer.state = trainer.state.replace(params=jax.tree_util.tree_map(
        lambda x: jnp.full_like(x, jnp.nan), trainer.state.params))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_elastic_matches_jax(tiny_data, tmp_path, name):
    """The same fault schedule on the same port-written dataset through both
    packages: the same restarts, fault epochs and reasons, surviving
    epochs, final epoch, checkpoint steps left on disk and final LR (or the
    same fault re-raised once the budget is spent)."""
    want = _elastic_outcome(
        _jax_make, _jax_poison,
        lambda d: sorted(int(f) for f in os.listdir(d) if f.isdigit()),
        lambda t: float(t.state.opt_state.hyperparams["learning_rate"]),
        tiny_data, str(tmp_path / "jax"), SCHEDULES[name])
    got = _elastic_outcome(
        _port_make, _nan_params,
        lambda d: sorted(int(m.group(1)) for f in os.listdir(d)
                         if (m := re.fullmatch(r"ckpt_(\d+)\.pt", f))),
        lambda t: t.optimizer.param_groups[0]["lr"],
        tiny_data, str(tmp_path / "port"), SCHEDULES[name])
    assert got.pop("lr") == pytest.approx(want.pop("lr"), rel=1e-6)
    assert got == want
