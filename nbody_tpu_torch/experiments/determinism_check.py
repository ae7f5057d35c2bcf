"""Does a training epoch repeat its loss on this device, and which torch ops
stand in the way?

    python -m nbody_tpu_torch.experiments.determinism_check \
        --config configs/contconv_adopted.json \
        --set datagen.train_files=2 --set datagen.steps=200 --runs 2

Generates the config's training files once, then trains the config's model
for one epoch ``--runs`` times from the same seed, first as the port runs by
default and then under ``torch.use_deterministic_algorithms(True,
warn_only=True)``. It prints one JSON row per mode: the epoch losses of the
runs (``repr`` of the float, so that one differing bit shows), whether they
are all equal, the seconds of the last run (the first one warms up), and,
for the deterministic mode, the ops that torch names as having no
deterministic implementation (they run as before and are only warned
about; an op that has one is switched silently). The hand-written kernels
are not torch ops: they keep one writer per element and a fixed order in
either mode.

The trainer seeds an epoch's batch order from the epoch and the crc32 of the
files' paths (the JAX trainer's formula), so the same files under another
directory give another order and another loss. ``--data-dir DIR`` keeps the
files in DIR (made there when it is empty or missing): a second process
given the same DIR trains on the same paths, and its losses can be held
against the first one's. Without it the files live in a fresh temporary
directory, and only the runs of one process compare.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import tempfile
import time
import warnings

import torch

from nbody_tpu_torch.config import ExperimentConfig
from nbody_tpu_torch.data.generate import generate_dataset
from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.train import PlateauScheduler, Trainer
from nbody_tpu_torch.utils.timing import device_time


def _epoch(cfg: ExperimentConfig, train_dir: str, dev: torch.device):
    """One epoch of the config's model from its seed (the trainer draws
    its initial weights from ``split(PRNGKey(train.seed))[1]``): (loss,
    seconds)."""
    model = cfg.build_model(device=dev).to(dev)
    trainer = Trainer(model, learning_rate=cfg.train.learning_rate, dt=cfg.train.dt,
                      seed=cfg.train.seed,
                      scheduler=PlateauScheduler(lr=cfg.train.learning_rate,
                                                 factor=cfg.train.scheduler_factor,
                                                 patience=cfg.train.scheduler_patience))
    (losses, _), sec = device_time(
        lambda: trainer.train_from_dir(train_dir, epochs=1, batch_size=cfg.train.batch_size,
                                       merge_files=cfg.train.merge_files,
                                       batch_mode=cfg.train.batch_mode, verbose=False), dev)
    return losses[0], sec


def check(cfg: ExperimentConfig, dev: torch.device, runs: int, data_dir=None) -> list:
    rows = []
    if data_dir is None:
        scope = tempfile.TemporaryDirectory(prefix="determinism_")
    else:
        os.makedirs(data_dir, exist_ok=True)
        scope = contextlib.nullcontext(os.path.abspath(data_dir))
    with scope as tmp:
        if not os.listdir(tmp):
            for i in range(1, cfg.datagen.train_files + 1):
                generate_dataset(cfg.scenarios(seed=i),
                                 os.path.join(tmp, f"output_file_{i}.csv"), device=dev,
                                 write_csv_file=False, verbose=False)
        for deterministic in (False, True):
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                results = [_epoch(cfg, tmp, dev) for _ in range(runs)]
            torch.use_deterministic_algorithms(False)
            named = sorted({m.group(1) for w in caught if (m := re.match(
                r"(\S+) does not have a deterministic implementation", str(w.message)))})
            losses = [loss for loss, _ in results]
            rows.append({"deterministic_algorithms": deterministic, "device": str(dev),
                         "data_dir": tmp,
                         "runs": runs, "epoch_loss": [repr(v) for v in losses],
                         "all_equal": len(set(losses)) == 1,
                         "last_run_seconds": results[-1][1],
                         "ops_without_a_deterministic_implementation": named})
    return rows


def main(argv=None):
    # cuBLAS is deterministic only with a fixed workspace, read when its
    # handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="JSON ExperimentConfig")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE", help="dotted-path override")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--data-dir", default=None,
                   help="keep the training files here (default: a temporary directory)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    args = p.parse_args(argv)
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    cfg = cfg.apply_overrides(args.overrides)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rows = check(cfg, dev, args.runs, args.data_dir)
    for row in rows:
        print(json.dumps(row))
    print(f"determinism_check: {time.perf_counter() - t0:.1f} s in all")
    return rows


if __name__ == "__main__":
    main()
