"""Failure detection and elastic restart for training runs — the port of
``nbody_tpu/train/elastic.py``.

* **detection**: after every epoch the mean loss and every floating tensor
  of the model's state are checked for finiteness (``all_finite``, from
  ``utils.debug``: one reduction a tensor on the device, one readback). A
  violation raises :class:`TrainingFault` before the epoch is checkpointed
  (``Trainer.train_from_dir`` runs its ``on_epoch_end`` ahead of the save),
  so the latest checkpoint is always a known-good rollback point.
* **recovery**: :func:`elastic_train` catches the fault, restores the latest
  *healthy* checkpoint (one whose weights fail the check is deleted and the
  next-older one tried), backs the learning rate off by ``lr_backoff`` per
  restart, and continues until the target epoch count or the restart budget
  is spent. Without a healthy checkpoint it starts over from scratch: the
  weights the model had when :func:`elastic_train` was called (the port's
  models are initialised when they are built, not by the ``Trainer``), a
  fresh optimiser, and the dropout stream and scheduler state of that call.
* **process-level faults** (preemption, an OOM kill): running the same
  command again resumes from the latest healthy checkpoint the same way.

"Elastic" means surviving and resuming on a fixed set of devices, as in the
JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from nbody_tpu_torch.train.checkpoint import CheckpointManager
from nbody_tpu_torch.utils.debug import all_finite


class TrainingFault(RuntimeError):
    """A detected training-health violation (non-finite loss or params)."""

    def __init__(self, epoch: int, reason: str):
        super().__init__(f"training fault at epoch {epoch}: {reason}")
        self.epoch = epoch
        self.reason = reason


@dataclasses.dataclass
class ElasticResult:
    """Outcome of an :func:`elastic_train` run.

    ``epoch_losses``/``epoch_mses`` hold the *surviving* value per epoch in
    epoch order (a faulted epoch's numbers are replaced by its re-run's;
    epochs completed by an earlier process are not re-reported).
    """

    epoch_losses: List[float]
    epoch_mses: List[float]
    restarts: int
    faults: List[Tuple[int, str]]


def _latest_healthy_epoch(trainer, save_path: str) -> int:
    """Put the trainer in the state of the newest checkpoint whose weights
    pass the health check, deleting unhealthy ones. Returns the resumed
    epoch (0: none)."""
    trainer._ensure_state()
    mgr = CheckpointManager(save_path)
    try:
        while True:
            step, tree = mgr.restore_latest()
            if step is None:
                return 0
            if all_finite(tree["model"]):
                # the trainer holds the checkpointed state even when no
                # further training runs (the target epochs already reached)
                trainer._restore(tree)
                return trainer.epoch
            print(f"Elastic: checkpoint at epoch {step} is unhealthy "
                  "(non-finite weights) — deleting it")
            mgr.delete(step)
    finally:
        mgr.close()


def elastic_train(
    trainer,
    data_path: str,
    epochs: int,
    batch_size: int,
    save_path: str,
    save_every: int = 1,
    max_restarts: int = 2,
    lr_backoff: float = 0.5,
    verbose: bool = True,
    on_epoch_end: Optional[Callable] = None,
    **train_kwargs,
) -> ElasticResult:
    """Run ``trainer.train_from_dir`` to ``epochs`` total epochs with fault
    detection and checkpoint-rollback restarts.

    :param trainer: a :class:`nbody_tpu_torch.train.Trainer`.
    :param save_path: checkpoint directory (required: it is the rollback
        store; ``save_every`` must be >= 1).
    :param max_restarts: fault budget; the fault that exhausts it re-raises.
    :param lr_backoff: multiplicative LR factor applied per restart
        (cumulative), on top of the restored checkpoint's LR.
    :param on_epoch_end: optional user callback, invoked after the health
        check passes (``train_from_dir``'s signature; its return value is
        not used, so it cannot stop the run early).
    :param train_kwargs: forwarded to ``train_from_dir`` (batch_mode, ...).
    """
    if save_every < 1:
        raise ValueError("elastic_train requires save_every >= 1")

    from nbody_tpu_torch.train.trainer import _list_dataset_files

    if not _list_dataset_files(data_path):
        raise FileNotFoundError(f"no datasets under {data_path}")

    # the scratch-restart state (a fault before the first save rolls back to
    # it, not to the corrupted weights), with the scheduler's plateau
    # counters and LR, which the faulted run changed; a model that waits
    # for its weights waits again, and draws them from the same key
    model0 = copy.deepcopy(trainer.model.state_dict())
    pending0 = getattr(trainer.model, "draw_pending", False)
    rng0 = trainer.rng.clone()
    sched0 = trainer.scheduler.state_dict() if trainer.scheduler else None

    loss_by_epoch: dict = {}
    mse_by_epoch: dict = {}

    def checked(epoch, losses, mses):
        if not np.isfinite(losses[-1]):
            raise TrainingFault(epoch, f"non-finite epoch loss {losses[-1]}")
        if not all_finite(trainer.model):
            raise TrainingFault(epoch, "non-finite parameters")
        loss_by_epoch[epoch] = losses[-1]
        mse_by_epoch[epoch] = mses[-1]
        if on_epoch_end is not None:
            on_epoch_end(epoch, losses, mses)

    restarts = 0
    faults: List[Tuple[int, str]] = []
    while True:
        resumed = _latest_healthy_epoch(trainer, save_path)
        if resumed == 0 and restarts:
            # no healthy checkpoint: a full scratch restart
            trainer.model.load_state_dict(model0)
            trainer.model.draw_pending = pending0
            trainer.optimizer = None
            trainer.rng = rng0.clone()
            trainer._ensure_state()
            trainer.epoch = 0
            if sched0 is not None:
                trainer.scheduler.load_state_dict(sched0)
        remaining = epochs - resumed
        if remaining <= 0:
            break
        try:
            trainer.train_from_dir(
                data_path, epochs=remaining, batch_size=batch_size,
                save_every=save_every, save_path=save_path, verbose=verbose,
                on_epoch_end=checked,
                lr_scale=(lr_backoff ** restarts if restarts else None),
                **train_kwargs,
            )
            break
        except TrainingFault as f:
            faults.append((f.epoch, f.reason))
            restarts += 1
            if verbose:
                print(f"Elastic: {f} — restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise

    seen = sorted(loss_by_epoch)
    return ElasticResult(
        epoch_losses=[loss_by_epoch[e] for e in seen],
        epoch_mses=[mse_by_epoch[e] for e in seen],
        restarts=restarts,
        faults=faults,
    )
