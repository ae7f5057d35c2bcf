"""GNN experiment — the port of ``nbody_tpu/experiments/gnn_experiment.py``
(reference ``gnn_experiment.py``): datagen -> GraphModel (4-dim input, width
64, 2 message-passing steps, mean aggregation, k = 10, scale 1e6) ->
Adam(0.01) with plateau(0.25, 5) -> 100 epochs -> stepwise and rollout
evaluation from the latest checkpoint -> ``results/gnn/*.csv``.

    python -m nbody_tpu_torch.experiments.gnn_experiment [--quick] [--device cuda]

The JAX script's flags, plus ``--device`` (default: the card when there is
one). ``--quick`` shrinks everything for a smoke run; ``--check`` raises on
non-finite trained weights or evaluation metrics; ``--profile DIR`` writes a
``torch.profiler`` trace of the evaluation.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from nbody_tpu_torch.experiments.common import (generate_data, loss_writer, resolve_device,
                                                setup_dirs, write_results)
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.train import PlateauScheduler, Trainer


def parser(name: str, batch_size: int) -> argparse.ArgumentParser:
    """The flags both reference experiments share."""
    p = argparse.ArgumentParser(prog=f"python -m nbody_tpu_torch.experiments.{name}")
    p.add_argument("--base", default=".")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--sim-steps", type=int, default=1000)
    p.add_argument("--train-files", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--quick", action="store_true", help="tiny smoke config")
    p.add_argument("--merge-files", action="store_true")
    p.add_argument("--batch-mode", default="bucketed",
                   choices=["bucketed", "mixed", "reference"],
                   help="batch composition (see Trainer.train_from_dir)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--train-seed", type=int, default=0,
                   help="seeds the initial weights and the dropout stream")
    p.add_argument("--check", action="store_true",
                   help="raise on non-finite trained weights or evaluation metrics")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the evaluation into DIR")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    return p


def run_experiment(name: str, args, model, **plateau) -> dict:
    """The shared flow of both experiments, after the model is built: datagen,
    training with checkpoints (``plateau`` sets the scheduler's factor and
    patience), evaluation from the latest checkpoint, CSVs."""
    if args.quick:
        args.epochs = min(args.epochs, 3)
        args.sim_steps = min(args.sim_steps, 50)
        args.train_files = min(args.train_files, 2)
        args.save_every = 1
    dev = resolve_device(args.device)
    paths = setup_dirs(name, args.base)
    n_bodies = [3, 25] if args.quick else None
    generate_data(paths["train"], num_files=args.train_files, n_bodies=n_bodies,
                  steps=args.sim_steps, seed=args.seed, device=dev)
    generate_data(paths["test"], num_files=1, n_bodies=n_bodies, steps=args.sim_steps,
                  seed=None if args.seed is None else args.seed + 1, device=dev)
    print("Data generated.")

    model = model.to(dev)
    trainer = Trainer(model, learning_rate=args.lr,
                      scheduler=PlateauScheduler(lr=args.lr, **plateau), dt=1e-4,
                      seed=args.train_seed)
    print("Model and trainer initialized.")
    epoch_loss, _ = trainer.train_from_dir(
        data_path=paths["train"], epochs=args.epochs, batch_size=args.batch_size,
        save_every=args.save_every, save_path=paths["weights"],
        on_epoch_end=loss_writer(paths), merge_files=args.merge_files,
        batch_mode=args.batch_mode)
    print("Training completed, evaluating model.")
    if args.check:
        from nbody_tpu_torch.utils.debug import throw_if_nonfinite

        throw_if_nonfinite(trainer.model, what="trained parameters")

    profile = contextlib.nullcontext()
    if args.profile:
        from nbody_tpu_torch.utils.profiling import trace_profile

        profile = trace_profile(args.profile)
    with profile:
        df_stepwise, df_rollout = trainer.test_from_dir(
            data_path=paths["test"], model_path=paths["weights"], sim_steps=args.sim_steps,
            stepwise=True, rollout=True)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    if args.check and not np.isfinite(df_rollout.to_numpy(dtype=float)).all():
        raise FloatingPointError("non-finite rollout metrics")
    print("Evaluation completed.")
    write_results(paths, df_stepwise, df_rollout)
    print("Training and testing completed. Results saved.")
    return {"trainer": trainer, "epoch_loss": epoch_loss, "paths": paths}


def main(argv=None):
    p = parser("gnn_experiment", batch_size=64)
    p.add_argument("--zero-init", action="store_true",
                   help="zero-init the decoder head (see models/mlp.py)")
    args = p.parse_args(argv)
    model = GraphModel(
        input_dim=4,
        node_encoder_dims=None,
        encoder_dropout=0.0,
        gnn_dim=64,
        message_passing_steps=2,
        aggr="mean",
        output_hiddens=None,
        neighbors=10,
        scale_factor=1e6,
        zero_init_output=args.zero_init,
        generator=torch.Generator().manual_seed(args.train_seed),
    )
    return run_experiment("gnn", args, model, factor=0.25, patience=5)


if __name__ == "__main__":
    main()
