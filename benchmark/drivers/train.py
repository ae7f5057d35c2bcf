"""Training traffic: the surrogate trained on snapshots of galaxies.

Traffic file keys: ``n_bodies``; ``snapshots`` S, each its own galaxy from
the seed, written as one npz dataset under ``TMPDIR`` with targets from
a direct sum over ``target_sources`` sampled sources (plus the black hole);
``batch_size`` and ``batch_mode`` of the trainer; ``check_steps``, the
optimiser steps the reference follows; ``limits`` of the numbers compared.

Set-up builds one ``Trainer`` and runs its first epoch through
``train_from_dir``, the window's own call and feed: that warms every shape
and gives the first ``check_steps`` steps, each on another snapshot, whose
losses, first gradient (from Adam's first moment after step 1) and
parameters after the last of them are kept. The window then drives the same
trainer's ``train_from_dir`` epoch after epoch until ``--seconds`` have
passed (its ``on_epoch_end`` stops it), whole epochs with their host work.

The window's first ``check_steps`` steps are kept alike (its first epoch's
losses, Adam's first moment after its first step, the parameters after the
last), with the parameters and Adam's moments at the window's start.

The reference works the batch order out again, builds each snapshot's graph
with its own Morton search and takes ``check_steps`` plain Adam steps: from
the seed's weights with fresh moments for the set-up epoch, and for the
window from the program's parameters and moments at its start, after the
set-up epoch's steps (the reference follows the program from its own state
there; the set-up stage checks the start by itself). Compared for each
stage, the window's under names that start ``window_`` (a leaf whose
reference gradient norm is under a thousandth of the median leaf's moves by
round-off alone and is left out):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over leaves, the largest gap between the norms of the two
  first gradients, over the larger of the reference leaf's norm and the
  median leaf's; the program's is worked out from Adam's first moments
  before and after its first step;
- ``change_gap``: the same for the change of each leaf over the steps;
- ``median_change_gap``: the median leaf's change gap, steady where Adam's
  first steps from fresh moments move elements whose gradient is at
  rounding level by a whole step either way.

The traffic's ``limits`` name the numbers compared; the others are printed
on standard error as readings.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark.harness import counts, inputs, port, weights
from benchmark.reference import models as ref_models
from benchmark.reference import morton
from benchmark.reference import train as ref_train

BETA1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "median_change_gap")
STATS = ("running_mean", "running_var")


def data_dir(ctx) -> str:
    return os.path.join(ctx.tmpdir, f"nbody-bench-{ctx.workload}-{int(ctx.seed)}")


def _keeper(st, names, last, m1_key, after_key):
    """An optimiser post-step hook that keeps, from the calls it sees,
    Adam's first moments after the first (``st.<m1_key>``) and the
    parameters after the ``last``-th (``st.<after_key>``)."""
    calls = [0]

    def after_step(opt, args, kwargs):
        calls[0] += 1
        if calls[0] > last:
            return
        params = [p for g in opt.param_groups for p in g["params"]]
        if calls[0] == 1:
            # a step that left no moment behind took no gradient: zeros
            setattr(st, m1_key, {names[id(p)]: opt.state[p].get("exp_avg", torch.zeros_like(p))
                                 .detach().clone() for p in params})
        if calls[0] == last:
            setattr(st, after_key, {names[id(p)]: p.detach().clone() for p in params})

    return register_optimizer_step_post_hook(after_step)


def setup(ctx):
    from nbody_tpu_torch.train.optim import PlateauScheduler
    from nbody_tpu_torch.train.trainer import Trainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    d = data_dir(ctx)
    path = os.path.join(d, "train.npz")
    inputs.write_snapshots(path, ctx.seed, tr["n_bodies"], tr["snapshots"], cfg,
                           tr["target_sources"], dev)
    model = port.build_model(cfg, weights.draw(cfg, ctx.seed, dev), dev, training=True)
    names = {id(p): name for name, p in model.named_parameters()}
    lr = cfg["learning_rate"]
    trainer = Trainer(model, learning_rate=lr, dt=cfg["dt"], seed=0,
                      scheduler=PlateauScheduler(lr, factor=cfg["scheduler_factor"],
                                                 patience=cfg["scheduler_patience"]))
    st = SimpleNamespace(trainer=trainer, dir=d, path=path, names=names, m1=None, after=None,
                         w_m1=None, w_after=None, w_losses=None)
    hook = _keeper(st, names, tr["check_steps"], "m1", "after")
    try:
        trainer.train_from_dir(d, epochs=1, **_job(tr), verbose=False)
    finally:
        hook.remove()
    st.losses = list(trainer.step_losses[:tr["check_steps"]])
    # the state the window starts from, which the check continues from
    opt = trainer.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    st.w_start = {names[id(p)]: p.detach().clone() for p in params}
    st.w_m0, st.w_v0 = ({names[id(p)]: opt.state[p][key].detach().clone() if key in opt.state[p]
                         else torch.zeros_like(p) for p in params}
                        for key in ("exp_avg", "exp_avg_sq"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def _job(tr):
    return {"batch_size": tr["batch_size"], "batch_mode": tr["batch_mode"]}


def window(st, ctx, seconds):
    tr = ctx.traffic
    epoch_means = []

    def stop(epoch, losses, mses):
        if not epoch_means:
            st.w_losses = list(st.trainer.step_losses[:tr["check_steps"]])
        epoch_means.append(losses[-1])
        return time.perf_counter() - t0 >= seconds

    hook = _keeper(st, st.names, tr["check_steps"], "w_m1", "w_after")
    e0 = st.trainer.epoch
    t0 = time.perf_counter()
    try:
        st.trainer.train_from_dir(st.dir, epochs=1 << 30, **_job(tr), verbose=False,
                                  on_epoch_end=stop)
    finally:
        hook.remove()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    elapsed = time.perf_counter() - t0
    epochs = st.trainer.epoch - e0
    per_epoch = math.ceil(tr["snapshots"] / tr["batch_size"])
    steps = epochs * per_epoch
    failed = per_epoch * sum(1 for x in epoch_means if not math.isfinite(x))
    particles = steps * tr["batch_size"] * tr["n_bodies"]
    return {"kind": "train", "seconds": elapsed, "epochs": epochs, "steps": steps,
            "attempted": steps, "failed": failed,
            "end_to_end": {"train_particles_per_s": particles / elapsed}}


def release(st):
    st.trainer.free_caches()
    st.trainer = None


def _norms(tree, keys):
    return {k: float(tree[k].double().norm()) for k in keys}


def _leaf_gaps(cand, ref, keys):
    """{leaf: gap of the candidate's norm from the reference's, over the
    larger of the reference leaf's norm and the median leaf's}."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(cand[k] - ref[k]) / max(ref[k], med) for k in keys}


def _gap_by_leaf(cand, ref, keys):
    return max(_leaf_gaps(cand, ref, keys).values())


def _gaps(start, ref, cand, moment, m0=None):
    """{number: value} of the candidate's steps from ``start`` against the
    reference's, and the leaves left out. Each side is (losses, first
    gradient, parameters after). With ``moment`` the candidate gives Adam's
    first moment after its first step instead of the gradient, which is
    worked out from it and ``m0``, the moment before (zeros if None).
    ``median_change_gap`` is the median leaf's change gap."""
    r_loss, r_grad, r_after = ref
    c_loss, c_m1, c_after = cand
    if c_loss is None or c_m1 is None or c_after is None or len(c_loss) < len(r_loss):
        return dict.fromkeys(NUMBERS, math.inf), []
    g_ref = _norms(r_grad, start)
    med = float(np.median(list(g_ref.values())))
    keys = [k for k in start if g_ref[k] >= 1e-3 * med]
    c_grad = c_m1 if not moment else \
        {k: (c_m1[k].double() - (0.0 if m0 is None else BETA1 * m0[k].double())) / (1 - BETA1)
         for k in keys}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(c_loss, r_loss))
    grad_gap = _gap_by_leaf(_norms(c_grad, keys), g_ref, keys)
    d_ref = {k: r_after[k] - start[k] for k in keys}
    d_cand = {k: c_after[k] - start[k] for k in keys}
    leaves = _leaf_gaps(_norms(d_cand, keys), _norms(d_ref, keys), keys)
    worst = max(leaves, key=leaves.get)
    flipped = float((torch.sign(d_cand[worst]) != torch.sign(d_ref[worst])).double().mean())
    print(f"reading change_gap's leaf {worst}: gap {leaves[worst]!r}, its elements whose change "
          f"differs in sign {flipped!r}", file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": leaves[worst],
            "median_change_gap": float(np.median(list(leaves.values())))}, \
        sorted(set(start) - set(keys))


def check(st, ctx, control=False):
    """Two stages of ``check_steps`` steps each, numbers of their own: the
    set-up epoch's first steps from the seed's weights and fresh Adam
    moments, and the window's first steps, continued from the program's
    parameters and Adam moments at the window's start (its second epoch,
    after ``per_epoch`` steps)."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, steps = tr["n_bodies"], tr["check_steps"]
    per_epoch = math.ceil(tr["snapshots"] / tr["batch_size"])
    with np.load(st.path) as f:
        pos_all = torch.from_numpy(f["scene0_pos"]).to(dev)
        target_all = torch.from_numpy(f["scene0_acc"]).to(dev)
        mass = torch.from_numpy(f["scene0_mass"]).to(dev)
    w = weights.draw(cfg, ctx.seed, dev)
    params = {k: v for k, v in w.items() if not k.endswith(STATS)}
    fixed = {k: v for k, v in w.items() if k.endswith(STATS)}
    lr = cfg["learning_rate"]
    stages = [("", 0, params, None, (st.losses, st.m1, st.after)),
              ("window_", 1, st.w_start, (st.w_m0, st.w_v0, per_epoch),
               (st.w_losses, st.w_m1, st.w_after))]
    numbers, first_graphs = [], None
    lim = tr["limits"]
    for prefix, epoch, start, state, cand in stages:
        order = ref_train.epoch_order(epoch, st.path, n, tr["snapshots"])[:steps]
        pos, target = pos_all[order], target_all[order]
        graphs = [morton.graph(cfg["graph"], pos[t]) for t in range(steps)]
        first_graphs = first_graphs or (pos, graphs)

        def loss_of(precision, pos=pos, target=target, graphs=graphs):
            def f(t, leaves):
                pred = ref_models.forward({**fixed, **leaves}, cfg, pos[t], mass, *graphs[t],
                                          precision=precision, train=True)
                return ref_models.scaled_rmse(pred, target[t], cfg["scale_factor"])
            return f

        ref = ref_train.adam(start, loss_of("float32"), steps, lr, state=state)
        if control:
            cand = ref_train.adam(start, loss_of("tf32"), steps, lr, state=state)
        gaps, left_out = _gaps(start, ref, cand, not control, state and state[0])
        for name in NUMBERS:
            # the traffic's limits name the numbers compared; the rest are
            # readings, on standard error
            if prefix + name in lim:
                numbers.append((prefix + name, gaps[name], lim[prefix + name]))
            else:
                print(f"reading {prefix + name} {gaps[name]!r} (not compared)", file=sys.stderr)
        print(f"check {prefix or 'setup_'}stage leaves left out (reference gradient under 1e-3 "
              f"of the median leaf's): {', '.join(left_out) or 'none'}", file=sys.stderr)
    spec = cfg["graph"]
    k = spec["k"] if spec["kind"] == "knn" else spec["k_max"]
    if cfg["model"] == "gnn":
        fwd = counts.gnn_forward_flops(n, k, cfg)
    else:
        from benchmark.drivers.rollout import _pairs_edges

        pos, graphs = first_graphs
        pe = [_pairs_edges(cfg, pos[t], *graphs[t]) for t in range(steps)]
        layers = [tuple(float(np.mean([p[i][j] for p in pe])) for j in range(2))
                  for i in range(cfg["continuous_conv_layers"])]
        fwd = counts.contconv_forward_flops(n, k, cfg, layers)
    shutil.rmtree(st.dir, ignore_errors=True)
    return numbers, {"step_flops": 3.0 * tr["batch_size"] * fwd}
