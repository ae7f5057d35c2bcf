"""Training and evaluation engine — the port of ``nbody_tpu/train/trainer.py``
(reference ``trainer.py:11-344``).

- ``train_from_dir``: per-epoch loop over every dataset in a directory,
  scaled-RMSE objective, Adam, plateau LR scheduling on the mean epoch loss,
  a checkpoint every ``save_every`` epochs and latest-by-step resume that
  continues the epoch numbering. Batches are composed as the JAX package
  composes them (``batch_mode`` bucketed, mixed or reference), in the order
  drawn from the same numpy seed, and live on the model's device.
- ``test_from_dir``: the timed one-snapshot (stepwise) evaluation and the
  ``sim_steps``-long autoregressive rollouts of every dataset under a
  directory, on the model's weights or a checkpoint's, aggregated into the
  reference's result-table schemas.

With ``mesh`` (a ``parallel.mesh.Mesh`` with a ``"data"`` axis, built on
every rank, e.g. under ``parallel.launch.run_ranks``) training is data
parallel: every rank holds the whole model, data and batch order (the
batch-order generator is seeded from the file paths), and takes its
contiguous share of every batch, padded to a multiple of the axis size with
``valid=False`` rows. The loss is the scaled RMSE of the whole batch, the
gradients are all-reduced, so every rank takes the same optimiser step, and
the encoder's batch norms take their statistics over every rank's valid
rows. Only global rank 0 writes checkpoints; every rank resumes from the
same file.

Random keys follow the JAX trainer's chain (``utils/prng.py``):
``rng = PRNGKey(seed)``; at first use ``rng, init_key = split(rng)``, and a
model that waits for its weights (built without ``key``) draws flax's
``init(init_key)``; a model handed weights (built with a key, loaded or
resumed) keeps them. Every bucket of an epoch then takes ``rng, sub =
split(rng)`` and its optimiser steps the keys ``split(sub, steps)``,
whether or not the model has dropout; a step's key is the ``dropout`` key
of each forward in it (the same for every bucket of a ``reference`` step),
and with a mesh each rank draws its rows of the batch's mask. Checkpoints
hold the key.

Not taken from the JAX trainer: ``scan_chunk`` (a cap on batches per TPU
dispatch, which does not change the math; the port dispatches each step
from Python).
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
import zlib
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nbody_tpu_torch.data.dataset import BatchIterator, SnapshotDataset
from nbody_tpu_torch.models.common import masked_mse, scaled_rmse_and_mse
from nbody_tpu_torch.models.mlp import MaskedBatchNorm, has_dropout, set_dropout_key
from nbody_tpu_torch.parallel.mesh import DATA_AXIS, psum, psum_all
from nbody_tpu_torch.train.checkpoint import CheckpointManager
from nbody_tpu_torch.train.graphs import build_graph
from nbody_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from nbody_tpu_torch.train.rollout import autoregressive_rollout
from nbody_tpu_torch.utils import prng
from nbody_tpu_torch.utils.timing import device_time


def _list_dataset_files(data_path: str):
    """Dataset files under a directory: CSVs plus npz-only datasets without
    a CSV sibling; structurally corrupt npz-only files are skipped with a
    warning. ``SnapshotDataset.from_file`` resolves either form."""
    from nbody_tpu_torch.data.generate import valid_npz

    files = sorted(glob(os.path.join(data_path, "*.csv")))
    stems = {f[:-4] for f in files}
    for f in sorted(glob(os.path.join(data_path, "*.npz"))):
        if f[:-4] in stems:
            continue
        if valid_npz(f):
            files.append(f)
        else:
            warnings.warn(f"skipping corrupt dataset file {f} (incomplete zip)",
                          stacklevel=2)
    return sorted(files)


def _group_rng(epoch: int, group) -> np.random.Generator:
    """The batch-order generator of one file group in one epoch: the JAX
    trainer's formula, so both packages draw the same batches."""
    return np.random.default_rng(epoch * 7919 + zlib.crc32("|".join(group).encode()) % 1000)


class Trainer:
    """:param model: a surrogate ``nn.Module`` exposing ``graph_spec`` and
        ``scale_factor`` (``GraphModel``, ``ContinuousConvModel``); it is
        trained and evaluated where its parameters live.
    :param learning_rate: Adam LR (the GNN experiment uses 0.01).
    :param scheduler: optional :class:`PlateauScheduler` stepped once per
        epoch on the mean loss.
    :param dt: rollout timestep.
    :param seed: the trainer's key is ``prng.PRNGKey(seed)``: the init key
        and the dropout keys come from it (see the module notes).
    :param mesh: optional ``parallel.mesh.Mesh`` with a ``"data"`` axis:
        data-parallel training over its ranks (see the module notes).
    """

    # Forwards per timed stepwise snapshot. The host timer closes with a
    # device synchronise, so one forward is already an honest time; a few
    # average out the host's launch jitter.
    STEPWISE_TIMING_REPS = 4

    def __init__(self, model, learning_rate: float = 0.01,
                 scheduler: Optional[PlateauScheduler] = None, dt: float = 0.01,
                 seed: int = 0, mesh=None):
        if mesh is not None and DATA_AXIS not in mesh.axis_names:
            raise ValueError(f"Trainer(mesh=) needs a {DATA_AXIS!r} axis, "
                             f"not {mesh.axis_names}")
        self.model = model
        self.mesh = mesh
        self.dt = dt
        self.learning_rate = learning_rate
        self.scheduler = scheduler
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.rng = prng.PRNGKey(seed)
        self.epoch = 0  # resume-aware epoch counter
        self._ds_cache: Dict[str, SnapshotDataset] = {}
        self._dev_cache: Dict[tuple, dict] = {}
        self._rollout_warmed: set = set()  # (N, steps, graph spec) run once untimed
        self.step_losses: List[float] = []  # every optimiser step's loss, last epoch

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints and reports: always
        without a mesh, on global rank 0 with one."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _my_rows(self, width: int) -> slice:
        """This rank's columns of a (steps, width) batch plan, ``width`` a
        multiple of the data axis (all of them without a mesh)."""
        if self.mesh is None:
            return slice(0, width)
        q = width // self.mesh.size(DATA_AXIS)
        me = self.mesh.index(DATA_AXIS)
        return slice(me * q, (me + 1) * q)

    def _padded(self, width: int) -> int:
        """``width`` rounded up to a multiple of the data axis (the JAX
        trainer pads each bucket's quota so)."""
        n = 1 if self.mesh is None else self.mesh.size(DATA_AXIS)
        return -(-width // n) * n

    @contextlib.contextmanager
    def _batch_norms_over_ranks(self):
        """With a mesh, every batch norm takes its training statistics over
        every rank's rows for the block."""
        norms = ([m for m in self.model.modules() if isinstance(m, MaskedBatchNorm)]
                 if self.mesh is not None else [])
        for m in norms:
            m.sum_over = functools.partial(psum, mesh=self.mesh, axis=DATA_AXIS)
        try:
            yield
        finally:
            for m in norms:
                m.sum_over = None

    def _global_rmse(self, sse, cnt):
        """(scaled RMSE, MSE) of the whole batch from this rank's sum of
        squares ``sse`` and count ``cnt``. The other ranks' share enters as
        a constant, so this rank's backward is the gradient through its own
        rows, and the all-reduce in :meth:`_apply_step` adds them up."""
        tot = psum(torch.stack([sse.detach(), cnt.detach()]), self.mesh, DATA_AXIS)
        mse = (sse + (tot[0] - sse.detach())) / torch.clamp(tot[1], min=1.0)
        return self.model.scale_factor * torch.sqrt(mse), mse

    def _dataset(self, path: str) -> SnapshotDataset:
        if path not in self._ds_cache:
            self._ds_cache[path] = SnapshotDataset.from_file(path)
        return self._ds_cache[path]

    def free_caches(self) -> None:
        """Drop the cached datasets and their device copies (a large-N run
        frees the training snapshots before its evaluation)."""
        self._dev_cache.clear()
        self._ds_cache.clear()

    # ----------------------------------------------------------- state mgmt
    def _ensure_state(self) -> None:
        """At first use (after the model has moved to its device): the init
        key split off the trainer's key, the weights of a model that waits
        for them drawn from it on the model's device, and the optimiser."""
        if self.optimizer is not None:
            return
        self.rng, init_key = prng.split(self.rng)
        if getattr(self.model, "draw_pending", False):
            self.model.draw_weights(init_key.to(self.device))
        self.optimizer = make_optimizer(self.model.parameters(), self.learning_rate)

    def _step_keys(self, steps: int) -> Optional[torch.Tensor]:
        """The next ``steps`` optimiser steps' dropout keys, on the model's
        device: ``rng, sub = split(rng)``, then ``split(sub, steps)``. The
        split is made for every bucket; the keys only where dropout draws
        masks."""
        self.rng, sub = prng.split(self.rng)
        return prng.split(sub, steps).to(self.device) if has_dropout(self.model) else None

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _ckpt_tree(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
            "epoch": self.epoch,
            "rng": self.rng,
        }

    def _try_resume(self, save_path: str) -> None:
        """Latest-by-step resume: weights, optimiser, scheduler, epoch and
        the trainer's key."""
        self._ensure_state()
        mgr = CheckpointManager(save_path)
        step, tree = mgr.restore_latest()
        mgr.close()
        if step is None:
            print("No checkpoint found")
            return
        self._restore(tree)
        print(f"Loaded checkpoint at epoch {self.epoch}")

    def _restore(self, tree: dict) -> None:
        """Take a checkpoint's state (``_ckpt_tree``); the optimiser must
        exist (``_ensure_state``). A checkpoint whose ``rng`` is not a key (a
        torch generator state, from before the trainer drew JAX's keys) is
        refused: its run cannot go on with JAX's dropout keys."""
        rng = tree.get("rng")
        if ("rng_device" in tree or not isinstance(rng, torch.Tensor)
                or tuple(rng.shape) != (2,) or rng.dtype != torch.int64):
            raise ValueError(
                "this checkpoint holds a torch generator state, not a prng key: it was "
                "written before the trainer followed the JAX trainer's keys, and cannot "
                "be resumed; train again from the start")
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.epoch = int(tree["epoch"])
        self.rng = rng.clone()
        if self.scheduler and tree["scheduler"] is not None:
            self.scheduler.load_state_dict(tree["scheduler"])
            self._set_lr(self.scheduler.lr)

    # -------------------------------------------------------------- buckets
    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _device_buckets(self, paths) -> dict:
        """Buckets pooled across ``paths`` on the model's device:
        {n_bodies: (x, y, n_valid)}."""
        key = ("merged",) + tuple(paths)
        if key not in self._dev_cache:
            pooled: Dict[int, list] = {}
            for p in paths:
                for n, b in self._dataset(p).buckets.items():
                    pooled.setdefault(n, []).append((b.x, b.y))
            self._dev_cache[key] = {
                n: (self._to_dev(np.concatenate([x for x, _ in parts])),
                    self._to_dev(np.concatenate([y for _, y in parts])),
                    torch.full((sum(x.shape[0] for x, _ in parts),), n,
                               dtype=torch.int64, device=self.device))
                for n, parts in pooled.items()}
        return self._dev_cache[key]

    def _device_buckets_mixed(self, paths) -> dict:
        """One pool of all snapshots padded to the shared max body count,
        {max_n: (x, y, n_valid)}: batches mix scene sizes like the
        reference's DataLoader, and ``n_valid`` gives exact node masks."""
        key = ("mixed",) + tuple(paths)
        if key not in self._dev_cache:
            max_n = max(n for p in paths for n in self._dataset(p).buckets)
            xs, ys, nvs = [], [], []
            for p in paths:
                for n, b in self._dataset(p).buckets.items():
                    xs.append(np.pad(b.x, ((0, 0), (0, max_n - n), (0, 0))))
                    ys.append(np.pad(b.y, ((0, 0), (0, max_n - n), (0, 0))))
                    nvs.append(np.full(b.x.shape[0], n, np.int64))
            self._dev_cache[key] = {max_n: (self._to_dev(np.concatenate(xs)),
                                            self._to_dev(np.concatenate(ys)),
                                            self._to_dev(np.concatenate(nvs)))}
        return self._dev_cache[key]

    # ---------------------------------------------------------------- steps
    def _gather(self, bucket, sel, valid):
        """A batch by index from a device bucket; rows with valid=False
        (tail padding) and padded bodies are masked out."""
        x_full, y_full, nv_full = bucket
        mask = ((torch.arange(x_full.shape[1], device=x_full.device)[None, :]
                 < nv_full[sel][:, None]) & valid[:, None])
        return x_full[sel], y_full[sel], mask

    def _forward(self, x, mask):
        idx, nbr_valid = build_graph(self.model.graph_spec, x[..., :3], mask)
        return self.model(x, idx, nbr_valid, node_mask=mask)

    def _apply_step(self, loss) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            params = [p for p in self.model.parameters() if p.requires_grad]
            grads = psum_all([torch.zeros_like(p) if p.grad is None else p.grad
                              for p in params], self.mesh, DATA_AXIS)
            for p, g in zip(params, grads):
                p.grad = g.view_as(p)
        self.optimizer.step()

    def _train_bucketed(self, dev: dict, group, batch_size: int, losses, mses) -> None:
        """Single-size (or mixed, padded) batches per bucket, buckets and
        batches in the order of the group's numpy generator; a tail batch
        keeps ``batch_size`` rows with valid=False padding (and a batch
        ``_padded(batch_size)`` rows with a mesh)."""
        rng_np = _group_rng(self.epoch, group)
        bucket_keys = list(dev.keys())
        rng_np.shuffle(bucket_keys)
        scale = self.model.scale_factor
        width = self._padded(batch_size)
        mine = self._my_rows(width)
        rows = None if self.mesh is None else (mine.start, width)
        for n in bucket_keys:
            s = dev[n][0].shape[0]
            nb = -(-s // batch_size)
            order = rng_np.permutation(s)
            sels = np.zeros((nb, self._padded(batch_size)), np.int64)
            valids = np.zeros((nb, self._padded(batch_size)), bool)
            for b, start in enumerate(range(0, s, batch_size)):
                sel = order[start:start + batch_size]
                sels[b, :len(sel)] = sel
                valids[b, :len(sel)] = True
            sels_d, valids_d = self._to_dev(sels[:, mine]), self._to_dev(valids[:, mine])
            keys = self._step_keys(nb)
            for b in range(nb):
                set_dropout_key(self.model, None if keys is None else keys[b], rows)
                x, y, mask = self._gather(dev[n], sels_d[b], valids_d[b])
                pred = self._forward(x, mask)
                if self.mesh is None:
                    loss, mse = scaled_rmse_and_mse(pred, y, scale, node_mask=mask)
                else:
                    w = mask.to(pred.dtype)[..., None]
                    loss, mse = self._global_rmse(((pred - y) ** 2 * w).sum(),
                                                  w.sum() * pred.shape[-1])
                self._apply_step(loss)
                losses.append(loss.detach())
                mses.append(mse.detach())

    def _train_group_reference(self, group, batch_size: int, losses, mses) -> None:
        """One epoch over a file group in ``batch_mode="reference"``: every
        optimiser step takes a proportional quota of snapshots from each
        body-size bucket (each snapshot once per epoch) and minimises one
        node-weighted loss over their union,
        ``scale * sqrt(sum_b SSE_b / sum_b 3 * n_valid_b)``. As in the JAX
        trainer, each bucket's batch norm starts from the step's running
        statistics and the last bucket's update is kept."""
        dev = self._device_buckets(group)
        ns = sorted(dev.keys())
        sizes = [dev[n][0].shape[0] for n in ns]
        steps = -(-sum(sizes) // batch_size)
        rng_np = _group_rng(self.epoch, group)
        sels, valids, rows = [], [], []
        for s in sizes:
            # with a mesh the quota is padded to the data axis (valid=False)
            q = self._padded(-(-s // steps))
            sel = np.zeros((steps, q), np.int64)
            val = np.zeros((steps, q), bool)
            order = rng_np.permutation(s)
            sel[np.arange(s) % steps, np.arange(s) // steps] = order
            val[np.arange(s) % steps, np.arange(s) // steps] = True
            mine = self._my_rows(q)
            sels.append(self._to_dev(sel[:, mine]))
            valids.append(self._to_dev(val[:, mine]))
            rows.append(None if self.mesh is None else (mine.start, q))
        norms = [m for m in self.model.modules() if isinstance(m, MaskedBatchNorm)]
        scale = self.model.scale_factor
        keys = self._step_keys(steps)
        for step in range(steps):
            start = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
            sse, cnt = 0.0, 0.0
            for n, sel, val, rows_n in zip(ns, sels, valids, rows):
                for m, (mean, var) in zip(norms, start):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)
                # every bucket's forward of a step takes the step's key
                set_dropout_key(self.model, None if keys is None else keys[step], rows_n)
                x, y, mask = self._gather(dev[n], sel[step], val[step])
                pred = self._forward(x, mask)
                w = mask.to(pred.dtype)[..., None]
                sse = sse + ((pred - y) ** 2 * w).sum()
                cnt = cnt + w.sum() * pred.shape[-1]
            if self.mesh is None:
                mse = sse / torch.clamp(cnt, min=1.0)
                loss = scale * torch.sqrt(mse)
            else:
                loss, mse = self._global_rmse(sse, cnt)
            self._apply_step(loss)
            losses.append(loss.detach())
            mses.append(mse.detach())

    # -------------------------------------------------------------- training
    def train_from_dir(
        self,
        data_path: str,
        epochs: int,
        batch_size: int,
        save_every: int = 0,
        save_path: Optional[str] = None,
        verbose: bool = True,
        on_epoch_end=None,
        merge_files: bool = False,
        mixed_batches: bool = False,
        batch_mode: Optional[str] = None,
        lr_scale: Optional[float] = None,
    ) -> Tuple[List[float], List[float]]:
        """Reference ``train_from_dir``. Returns (epoch_losses,
        epoch_mse_losses), means over all batches of each epoch.

        :param on_epoch_end: optional ``(epoch, epoch_losses,
            epoch_mse_losses) -> stop`` callback, run before the scheduler
            and the checkpoint; a truthy return checkpoints the epoch and
            stops.
        :param merge_files: pool every file's snapshots into shared buckets.
        :param mixed_batches: legacy alias for ``batch_mode="mixed"``.
        :param batch_mode: ``"bucketed"`` (default; single-size batches per
            body-count bucket), ``"mixed"`` (every batch drawn from all of a
            group's snapshots, padded to the shared max N with exact node
            masks) or ``"reference"`` (a quota from every bucket per step,
            one node-weighted loss over their union).
        :param lr_scale: multiply the (resumed) LR by this before training.
        """
        files = _list_dataset_files(data_path)
        if not files:
            raise FileNotFoundError(f"no datasets under {data_path}")
        mode = batch_mode or ("mixed" if mixed_batches else "bucketed")
        if mode not in ("bucketed", "mixed", "reference"):
            raise ValueError(f"unknown batch_mode {mode!r}")
        if save_path:
            self._try_resume(save_path)
        else:
            self._ensure_state()
        if lr_scale is not None:
            lr = self.optimizer.param_groups[0]["lr"] * lr_scale
            if self.scheduler:
                self.scheduler.lr = lr
            self._set_lr(lr)

        mgr = (CheckpointManager(save_path)
               if (save_path and save_every > 0 and self.writes) else None)
        verbose = verbose and self.writes
        epoch_losses: List[float] = []
        epoch_mse_losses: List[float] = []
        groups = [files] if merge_files else [[f] for f in files]
        self.model.train()
        for e in range(epochs):
            losses: list = []
            mses: list = []
            with self._batch_norms_over_ranks():
                for group in groups:
                    if mode == "reference":
                        self._train_group_reference(group, batch_size, losses, mses)
                    else:
                        dev = (self._device_buckets_mixed(group) if mode == "mixed"
                               else self._device_buckets(group))
                        self._train_bucketed(dev, group, batch_size, losses, mses)
            self.step_losses = torch.stack(losses).cpu().numpy().tolist()
            mean_loss = float(np.mean(self.step_losses))
            mean_mse = float(np.mean(torch.stack(mses).cpu().numpy()))
            epoch_losses.append(mean_loss)
            epoch_mse_losses.append(mean_mse)
            self.epoch += 1
            if verbose:
                print(f"Epoch {self.epoch}: loss {mean_loss:.6g}, mse {mean_mse:.6g}")
            # on_epoch_end runs before the checkpoint: a health check that
            # raises keeps a bad epoch out of the latest checkpoint
            stop = on_epoch_end(self.epoch, epoch_losses, epoch_mse_losses) \
                if on_epoch_end is not None else None
            if self.scheduler:
                self._set_lr(self.scheduler.step(mean_loss))
            if mgr and ((e + 1) % save_every == 0 or stop):
                mgr.save(self.epoch, self._ckpt_tree())
                if verbose:
                    print(f"Saved checkpoint at epoch {self.epoch}")
            if stop:
                if verbose:
                    print(f"Early stop requested at epoch {self.epoch}")
                break
        if mgr:
            mgr.close()
        return epoch_losses, epoch_mse_losses

    # ------------------------------------------------------------------ eval
    def test_from_dir(
        self,
        data_path: str,
        model_path: Optional[str] = None,
        sim_steps: int = 1000,
        stepwise: bool = True,
        rollout: bool = True,
        rollout_graph_spec=None,
    ):
        """Reference ``test_from_dir``, on the model's current weights or,
        with ``model_path``, the latest checkpoint's there. Returns
        (df_stepwise grouped by (filename, scene) with mean loss and
        step_time, df_rollout indexed by (filename, scene, step) with
        pos/vel/acc RMSE and step_time)."""
        import pandas as pd

        files = _list_dataset_files(data_path)
        if not files:
            raise FileNotFoundError(f"no datasets under {data_path}")
        if model_path:
            self._try_resume(model_path)

        self.model.eval()
        stepwise_rows, rollout_frames = [], []
        for f in files:
            filename = os.path.basename(f)
            ds = self._dataset(f)
            if stepwise:
                stepwise_rows.extend(self._evaluate_stepwise(filename, ds))
            if rollout:
                for scene in ds.scene_ids():
                    rollout_frames.append(self._evaluate_rollout(
                        filename, ds, scene, sim_steps, rollout_graph_spec))

        df_stepwise = pd.DataFrame(
            stepwise_rows,
            columns=["filename", "scene", "step", "loss", "mse_loss", "step_time"],
        )
        df_stepwise_grouped = (
            df_stepwise.groupby(["filename", "scene"]).mean()[["loss", "step_time"]]
            if len(df_stepwise) else df_stepwise
        )
        df_rollout = (
            pd.concat(rollout_frames).set_index(["filename", "scene", "step"])
            if rollout_frames else pd.DataFrame()
        )
        return df_stepwise_grouped, df_rollout

    @torch.no_grad()
    def _eval_step(self, x, y, mask):
        idx, valid = build_graph(self.model.graph_spec, x[..., :3], mask)
        pred = self.model(x, idx, valid, node_mask=mask)
        # stepwise eval reports the RAW rmse, not the scaled one
        mse = masked_mse(pred, y, mask)
        return torch.sqrt(mse), mse

    def _evaluate_stepwise(self, filename: str, ds: SnapshotDataset):
        """Timed one-snapshot forwards; the first snapshot of each shape runs
        once untimed (allocator and library warm-up)."""
        dev = self.device
        rows, warmed = [], set()
        reps = self.STEPWISE_TIMING_REPS
        for batch in BatchIterator(ds, 1, shuffle=False):
            x = torch.from_numpy(batch.x).to(dev)
            y = torch.from_numpy(batch.y).to(dev)
            m = torch.from_numpy(batch.node_mask).to(dev)
            if x.shape not in warmed:
                self._eval_step(x, y, m)
                warmed.add(x.shape)

            def run():
                for _ in range(reps):
                    out = self._eval_step(x, y, m)
                return out

            (loss, mse), elapsed = device_time(run, dev)
            rows.append((filename, int(batch.scene[0]), int(batch.step[0]),
                         float(loss), float(mse), elapsed / reps))
        return rows

    def _evaluate_rollout(self, filename: str, ds: SnapshotDataset, scene: int,
                          sim_steps: int, rollout_graph_spec=None):
        """Rollout against ground truth, aggregated like the reference: per
        step, the mean of the *signed* errors over particles, then the RMSE
        of those means across x, y, z."""
        import pandas as pd

        dev = self.device
        gt = ds.scene_trajectory(scene)
        steps = min(sim_steps, gt.pos.shape[0])
        pos0 = torch.from_numpy(np.ascontiguousarray(gt.pos[0])).to(dev)
        vel0 = torch.from_numpy(np.ascontiguousarray(gt.vel[0])).to(dev)
        mass = torch.from_numpy(np.ascontiguousarray(gt.mass)).to(dev)

        def run():
            return autoregressive_rollout(self.model, pos0, vel0, mass, steps, self.dt,
                                          graph_spec=rollout_graph_spec)

        # the first rollout of a shape runs once untimed (kernel builds,
        # allocator and library warm-up), as the reference's step_time
        # excludes compilation
        key = (gt.pos.shape[1], steps, repr(rollout_graph_spec))
        if key not in self._rollout_warmed:
            run()
            self._rollout_warmed.add(key)
        (ps, vs, accs), elapsed = device_time(run, dev)
        step_time = elapsed / steps

        def rmse_of_mean(err):
            mean_err = err.mean(axis=1)  # mean over particles
            return np.sqrt((mean_err ** 2).mean(axis=-1))  # over x, y, z

        return pd.DataFrame({
            "filename": filename,
            "scene": scene,
            "step": np.arange(steps),
            "pos_rmse": rmse_of_mean(gt.pos[:steps] - ps.cpu().numpy()),
            "vel_rmse": rmse_of_mean(gt.vel[:steps] - vs.cpu().numpy()),
            "acc_rmse": rmse_of_mean(gt.acc[:steps] - accs.cpu().numpy()),
            "step_time": step_time,
        })
