"""The predict-zero loss of the reference recipe's training set, as made by
either package: the floor that the GNN reference experiment's converged
loss is read against.

The GNN experiment's scaled loss is 1e6 x the RMS error over a step's
bodies; a model that predicts zero scores 1e6 x the RMS of the targets.
Both packages draw the recipe's galaxies from ``jax.random``'s keyed
streams (the port through ``utils.prng``), so the two training sets hold
the same galaxies, and at 3-500 bodies a scene the targets' RMS moves with
the sample: the two floors agree where the realisations do. This script makes the
training set of ``run_experiments.sh`` (10 files, seed 42, 1000 steps) with
one package on the CPU, unless DIR already holds it, and prints the RMS of
its targets by body count and the mean over an epoch of a zero predictor's
loss under ``batch_mode="reference"`` (a quota of every body-count bucket a
step, 64 snapshots a step)::

    JAX_PLATFORMS=cpu python scripts/recipe_zero_loss.py --package jax --dir DIR_J
    python scripts/recipe_zero_loss.py --package port --dir DIR_P

The port's datagen runs here with ``device="cpu"``: its random draws are
the card's bits, and its ICs and trajectories equal the card's to float32
rounding.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=["jax", "port"], required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    args = p.parse_args(argv)
    if args.package == "jax":
        from nbody_tpu.experiments.common import generate_data

        generate_data(args.dir, num_files=10, seed=42)
    else:
        from nbody_tpu_torch.experiments.common import generate_data

        generate_data(args.dir, num_files=10, seed=42, device="cpu")
    from nbody_tpu_torch.data.dataset import SnapshotDataset

    sse, cnt, losses = {}, {}, []
    rng = np.random.default_rng(0)
    for f in sorted(glob.glob(os.path.join(args.dir, "*.csv"))):
        ys = {n: np.asarray(b.y, np.float64)
              for n, b in SnapshotDataset.from_file(f).buckets.items()}
        for n, y in ys.items():
            sse[n] = sse.get(n, 0.0) + float((y ** 2).sum())
            cnt[n] = cnt.get(n, 0) + y.size
        steps = -(-sum(y.shape[0] for y in ys.values()) // args.batch_size)
        perms = {n: rng.permutation(y.shape[0]) for n, y in ys.items()}
        for st in range(steps):
            s2 = sum(float((y[perms[n][st::steps]] ** 2).sum()) for n, y in ys.items())
            c = sum(y[perms[n][st::steps]].size for n, y in ys.items())
            losses.append(1e6 * np.sqrt(s2 / c))
    out = {"package": args.package,
           "rms_all": 1e6 * float(np.sqrt(sum(sse.values()) / sum(cnt.values()))),
           "zero_predictor_epoch_loss": float(np.mean(losses)),
           "rms_by_n": {int(n): 1e6 * float(np.sqrt(sse[n] / cnt[n])) for n in sorted(sse)}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
