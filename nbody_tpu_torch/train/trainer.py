"""Evaluation half of the training engine — the port of the eval methods of
``nbody_tpu/train/trainer.py`` (reference ``trainer.py:94-344``).

``test_from_dir`` runs the timed one-snapshot (stepwise) evaluation and the
``sim_steps``-long autoregressive rollouts of every dataset under a
directory, on the model's current weights, and aggregates them into the
reference's result-table schemas. Training (``train_from_dir``) and
checkpoints are not ported yet (ROADMAP.md, queue A item 6).
"""

from __future__ import annotations

import os
import warnings
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from nbody_tpu_torch.data.dataset import BatchIterator, SnapshotDataset
from nbody_tpu_torch.models.common import masked_mse
from nbody_tpu_torch.train.graphs import build_graph
from nbody_tpu_torch.train.rollout import autoregressive_rollout
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


class Trainer:
    """:param model: a surrogate ``nn.Module`` exposing ``graph_spec``
        (``GraphModel``); it is evaluated where its parameters live.
    :param dt: rollout timestep.
    """

    # Forwards per timed stepwise snapshot. The host timer closes with a
    # device synchronise, so one forward is already an honest time; a few
    # average out the host's launch jitter.
    STEPWISE_TIMING_REPS = 4

    def __init__(self, model, dt: float = 0.01):
        self.model = model
        self.dt = dt
        self._ds_cache: Dict[str, SnapshotDataset] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _dataset(self, path: str) -> SnapshotDataset:
        if path not in self._ds_cache:
            self._ds_cache[path] = SnapshotDataset.from_file(path)
        return self._ds_cache[path]

    def test_from_dir(
        self,
        data_path: str,
        model_path: Optional[str] = None,
        sim_steps: int = 1000,
        stepwise: bool = True,
        rollout: bool = True,
        rollout_graph_spec=None,
    ):
        """Reference ``test_from_dir``. Returns (df_stepwise grouped by
        (filename, scene) with mean loss and step_time, df_rollout indexed by
        (filename, scene, step) with pos/vel/acc RMSE and step_time)."""
        import pandas as pd

        if model_path:
            raise NotImplementedError(
                "loading weights from a checkpoint comes with "
                "train/checkpoint.py (ROADMAP.md, queue A item 6); "
                "evaluate the model's current weights with model_path=None")
        files = _list_dataset_files(data_path)
        if not files:
            raise FileNotFoundError(f"no datasets under {data_path}")

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
        (ps, vs, accs), elapsed = device_time(
            lambda: autoregressive_rollout(self.model, pos0, vel0, mass, steps,
                                           self.dt, graph_spec=rollout_graph_spec),
            dev)
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
