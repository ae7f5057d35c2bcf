"""Config-driven experiment runner — the port of ``nbody_tpu/experiments/run.py``:

    python -m nbody_tpu_torch.experiments.run --config configs/contconv_adopted.json \
        --set train.epochs=20 --set model.kwargs.conv_impl=kernel

The whole flow from one :class:`nbody_tpu_torch.config.ExperimentConfig`:
datagen (skipped when the data directories hold files), training with a
checkpoint every ``train.save_every`` epochs and latest-by-step resume,
stepwise and rollout evaluation from the latest checkpoint, and the result
CSVs in the reference schemas under ``<base>/results/<name>/``. The JAX
config files drive it unchanged: their implementation names are mapped to
the port's (``config.IMPL_NAMES``). Everything runs on ``--device``, the
card when there is one; a Morton neighbour search whose impl the config
leaves unset takes the kernels there and the plain search on the CPU, and
the resolved graph spec is printed.
"""

from __future__ import annotations

import argparse
import os
import random

import torch

from nbody_tpu_torch.config import ExperimentConfig
from nbody_tpu_torch.data.generate import generate_dataset
from nbody_tpu_torch.experiments.common import (loss_writer, resolve_device, setup_dirs,
                                                write_results)
from nbody_tpu_torch.train import PlateauScheduler, Trainer


def run(cfg: ExperimentConfig, device=None) -> dict:
    """Run the flow; returns the trainer, this call's epoch losses and the
    two evaluation frames."""
    dev = resolve_device(device)
    paths = setup_dirs(cfg.name, cfg.base)
    cfg.save(os.path.join(paths["results"], "config.json"))

    rng = random.Random(cfg.datagen.seed)
    for split, count in (("train", cfg.datagen.train_files),
                         ("test", cfg.datagen.test_files)):
        out_dir = paths[split]
        if os.listdir(out_dir):
            continue
        for i in range(1, count + 1):
            generate_dataset(cfg.scenarios(seed=rng.randint(0, 1000)),
                             os.path.join(out_dir, f"output_file_{i}.csv"), device=dev)

    model = cfg.build_model(generator=torch.Generator().manual_seed(cfg.train.seed),
                            device=dev).to(dev)
    print(f"model {cfg.model.type} on {dev}: graph spec {model.graph_spec}")
    scheduler = PlateauScheduler(lr=cfg.train.learning_rate,
                                 factor=cfg.train.scheduler_factor,
                                 patience=cfg.train.scheduler_patience)
    trainer = Trainer(model, learning_rate=cfg.train.learning_rate, scheduler=scheduler,
                      dt=cfg.train.dt, seed=cfg.train.seed)
    epoch_loss, _ = trainer.train_from_dir(
        data_path=paths["train"],
        epochs=cfg.train.epochs,
        batch_size=cfg.train.batch_size,
        save_every=cfg.train.save_every,
        save_path=paths["weights"],
        on_epoch_end=loss_writer(paths),
        merge_files=cfg.train.merge_files,
        batch_mode=cfg.train.batch_mode,
    )
    df_stepwise, df_rollout = trainer.test_from_dir(
        data_path=paths["test"], model_path=paths["weights"], sim_steps=cfg.train.sim_steps)
    write_results(paths, df_stepwise, df_rollout)
    print(f"results saved under {paths['results']}")
    return {"trainer": trainer, "epoch_loss": epoch_loss, "stepwise": df_stepwise,
            "rollout": df_rollout}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="JSON ExperimentConfig")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE", help="dotted-path override")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    args = p.parse_args(argv)
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    cfg = cfg.apply_overrides(args.overrides)
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
