"""Plain training steps: the scaled-RMSE loss, autograd gradients and
torch's Adam (no weight decay, no amsgrad) written out, and the batch order
that the trainer draws for an epoch."""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List

import numpy as np
import torch


def epoch_order(epoch: int, path: str, n_bodies: int, n_snapshots: int) -> np.ndarray:
    """Snapshot order of one epoch over one file of single-size snapshots
    (batch 1, bucketed): the group's generator is seeded with ``epoch * 7919
    + crc32(path) % 1000``; it shuffles the bucket keys, then permutes the
    bucket's snapshots."""
    rng = np.random.default_rng(epoch * 7919 + zlib.crc32(path.encode()) % 1000)
    keys = [n_bodies]
    rng.shuffle(keys)
    return rng.permutation(n_snapshots)


def adam(params: Dict[str, torch.Tensor], loss_of: Callable[[int, Dict[str, torch.Tensor]], torch.Tensor],
         steps: int, lr: float, betas=(0.9, 0.999), eps=1e-8, state=None):
    """``steps`` Adam steps from ``params`` (float32 leaves, not modified).

    :param loss_of: (step index from 0, params requiring grad) -> loss.
    :param state: optional (first moments, second moments, steps taken)
        to continue from (not modified); fresh moments at step 0 if None.
    :return: (losses [steps], first gradients {name: tensor}, params after
        the last step {name: tensor}).
    """
    b1, b2 = betas
    p = {k: v.detach().clone() for k, v in params.items()}
    if state is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        t0 = 0
    else:
        m = {k: state[0][k].clone() for k in p}
        v2 = {k: state[1][k].clone() for k in p}
        t0 = int(state[2])
    losses: List[float] = []
    first = None
    for t in range(t0 + 1, t0 + steps + 1):
        leaves = {k: x.requires_grad_(True) for k, x in p.items()}
        loss = loss_of(t - t0 - 1, leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            if first is None:
                first = {k: g.clone() for k, g in zip(leaves, grads)}
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for (k, x), g in zip(leaves.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v2[k].sqrt() / (c2 ** 0.5) + eps
                p[k] = (x.detach() - (lr / c1) * m[k] / denom)
        del grads, leaves
    return losses, first, p
