"""Write the JAX trainer's initial ``train_large`` GNN weights as a port
checkpoint, so that the port's ``train_large`` starts from JAX's weights.

``nbody_tpu/experiments/train_large.py`` draws its GNN's initial weights
from ``jax.random`` (trainer seed 0); the port draws the same distribution
from ``torch.Generator`` (seed 0). To tell the two realisations apart from
anything else, this script builds the JAX model and trainer as the JAX
script does, converts the initial parameters to the port's layout, and
saves them as epoch 0 of a port checkpoint (fresh Adam state, fresh plateau
scheduler). ``train_large --save-every 1 --out X.json`` then resumes from
``X_ckpt/ckpt_0.pt`` and trains the same epochs in the same batch order as
a fresh run. CPU only, with JAX installed::

    JAX_PLATFORMS=cpu python scripts/jax_initial_checkpoint.py DIR [--neighbors 10]

writes ``DIR/ckpt_0.pt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--gnn-dim", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    args = p.parse_args(argv)

    import jax
    import torch

    from nbody_tpu.models import GraphModel as JGraphModel
    from nbody_tpu.train import PlateauScheduler as JPlateau
    from nbody_tpu.train import Trainer as JTrainer
    from nbody_tpu_torch.models import GraphModel, graph_model_state_dict
    from nbody_tpu_torch.train import PlateauScheduler, Trainer
    from nbody_tpu_torch.train.checkpoint import CheckpointManager

    # train_large's GNN (nbody_tpu/experiments/train_large.py:211-223); the
    # kNN impl does not touch the parameters
    kw = dict(input_dim=4, gnn_dim=args.gnn_dim, message_passing_steps=2, aggr="mean",
              neighbors=args.neighbors, scale_factor=1e6, knn_method="morton",
              fused_edgeconv=True, output_scale=1e6)
    jt = JTrainer(JGraphModel(**kw, knn_impl="xla"), learning_rate=args.lr, dt=1e-4, seed=0,
                  scheduler=JPlateau(lr=args.lr, factor=0.25, patience=5))
    # the init reads only the shapes of its sample batch
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(1, 64, 6)), np.full((1, 64, 1), 1 / 64)], -1)
    jt._ensure_state(types.SimpleNamespace(x=x.astype(np.float32),
                                           node_mask=np.ones((1, 64), bool)))
    model = GraphModel(**kw, knn_impl="dense")
    model.load_state_dict(graph_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jt.state.params)))
    tt = Trainer(model, learning_rate=args.lr, dt=1e-4, seed=0,
                 scheduler=PlateauScheduler(lr=args.lr, factor=0.25, patience=5))
    tt._ensure_state()
    CheckpointManager(args.out_dir).save(0, tt._ckpt_tree())
    path = os.path.join(args.out_dir, "ckpt_0.pt")
    n = sum(v.numel() for v in model.state_dict().values())
    print(f"wrote {path}: JAX's initial train_large GNN ({n} values), epoch 0")
    return path


if __name__ == "__main__":
    main()
