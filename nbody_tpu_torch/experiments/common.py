"""Shared plumbing of the experiment entry points — the port of
``nbody_tpu/experiments/common.py``: directory setup and train/test dataset
generation with the reference's scenario recipe."""

from __future__ import annotations

import os
import random
from typing import Optional

from nbody_tpu_torch.data.generate import generate_dataset, scenario_product
from nbody_tpu_torch.utils.device import default_device, resolve_device  # noqa: F401

# The reference's datagen recipe: 6 spiral scenes per file at these body
# counts, 1000 leapfrog steps each.
REFERENCE_N_BODIES = [3, 25, 50, 100, 250, 500]


def generate_data(
    output_dir: str,
    num_files: int = 10,
    n_bodies=None,
    steps: int = 1000,
    seed: Optional[int] = None,
    device=None,
) -> None:
    """Populate ``output_dir`` with ``num_files`` trajectory CSVs, each a
    random-seeded spiral-galaxy sweep, rolled out on ``device`` (default:
    :func:`default_device`). Skips generation when the directory already
    has files."""
    os.makedirs(output_dir, exist_ok=True)
    if os.listdir(output_dir):
        return
    rng = random.Random(seed)
    for i in range(1, num_files + 1):
        scenarios = scenario_product(
            n_bodies=list(n_bodies or REFERENCE_N_BODIES),
            integrator="leapfrog",
            sim_type="spiral",
            steps=steps,
            n_arms=2,
            seed=rng.randint(0, 1000),
        )
        generate_dataset(scenarios, os.path.join(output_dir, f"output_file_{i}.csv"),
                         device=device or default_device())


def setup_dirs(name: str, base: str = ".") -> dict:
    paths = {
        "train": os.path.join(base, "data", "train"),
        "test": os.path.join(base, "data", "test"),
        "weights": os.path.join(base, f"{name}_weights"),
        "results": os.path.join(base, "results", name),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def write_results(paths: dict, df_stepwise, df_rollout) -> None:
    """The evaluation's two CSVs in the reference schemas."""
    df_stepwise.to_csv(os.path.join(paths["results"], "test_results_stepwise.csv"),
                       index=True)
    df_rollout[["pos_rmse", "vel_rmse", "acc_rmse"]].to_csv(
        os.path.join(paths["results"], "test_results_rollout.csv"), index=True)


def loss_writer(paths: dict):
    """An ``on_epoch_end`` callback that rewrites ``epoch_loss.csv`` with
    the losses so far."""
    import pandas as pd

    loss_csv = os.path.join(paths["results"], "epoch_loss.csv")

    def persist(epoch, losses, mses):
        pd.DataFrame(losses, columns=["loss"]).to_csv(loss_csv, index=False)

    return persist
