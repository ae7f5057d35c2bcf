"""Every sharded path once, each held to the single-rank result — the twin
of the JAX package's ``__graft_entry__.dryrun_multichip``:

1. a data-parallel training epoch (``Trainer(mesh=)`` over the ``"data"``
   axis) against the one-process ``Trainer``, for a ContConv model with its
   encoder batch norm;
2. the ring force, energies and a leapfrog step over ``"particles"``
   against the direct sum (``ops.pairwise``) and ``core.simulate``;
3. a particle-sharded surrogate rollout (GNN) and the ContConv forward and
   training gradients against ``train.rollout`` and autograd on one rank;
4. the sharded treecodes (bh, bh2, bh3 forces and a bh rollout) against
   ``ops.treeforce`` and ``core.simulate``.

    python -m nbody_tpu_torch.parallel.dryrun [--ranks 2] [--backend nccl|gloo]
                                              [--device cpu|cuda:0]

runs the small shapes of :func:`small_spec` on ``--ranks`` processes; the
ranks run on the card (rank r on ``cuda:(r % count)``) unless ``--device``
names another device. ``--backend`` defaults to ``gloo`` for ``--device
cpu`` and ``nccl`` otherwise; several ranks on one card need ``gloo``
(``--device cuda:0 --backend gloo``). It prints one line a check and exits
non-zero if any fails. ``chip_smoke.py`` runs :func:`check_paths` at real
sizes.

The bars are the JAX tests' own: ring accelerations 1e-5 of max |a| and
energies 1e-6 relative (``tests/test_ring.py``); treecode forces bit for bit
where the blocks divide evenly, else rtol 1e-4, atol 1e-9 (whether the bits
are equal there too is reported), and rollouts
rtol 1e-5, atol 1e-8 (``tests/test_sharded_bh.py``); surrogate forwards
and rollouts rtol 5e-5, loss 1e-5, gradients rtol 2e-4
(``tests/test_sharded_surrogate.py``), the atol of a predicted
acceleration (1e-7) and of a gradient (1e-5) taken relative to its largest
element here, since the card's paths run at full width; the biases that
feed a batch norm are left out of the gradients (rounding noise);
data-parallel training losses rtol 2e-4 (``tests/test_trainer.py``) and
gradients as above, on every step from the same parameters, and the small
run's free-running epoch losses too (see :func:`_train`).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from nbody_tpu_torch.parallel.launch import imported_jax, rank_device, run_ranks
from nbody_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from nbody_tpu_torch.utils.timing import device_time

G, EPS = 4.5e-6, 0.05


def small_spec(data_dir: str) -> dict:
    """The dryrun's shapes: the JAX tests' sizes, a few seconds on the CPU.
    ``data_dir`` holds the training files of check 1."""
    return {
        "ring": {"n": 64, "backend": "kernel", "dt": 1e-3},
        "bh": {"n": 2048, "uneven_n": 1792, "steps": 10, "refresh": 4,
               "bh": dict(n_near=8, block=128),
               "bh2": dict(n_near=6, block=64, coarse=4, rc=4),
               "bh3": dict(n_near=6, block=64, coarse=4, rc=4, sub_block=16, n_sub=12)},
        "gnn": {"n": 64, "steps": 3, "dt": 1e-3,
                "kwargs": dict(input_dim=4, gnn_dim=16, message_passing_steps=2,
                               aggr="mean", neighbors=5, scale_factor=1e6,
                               output_scale=1e3)},
        "contconv": {"n": 64, "kwargs": dict(
            in_channels=4, filter_resolution=(4, 3), radius=1.5,
            continuous_conv_layers=2, continuous_conv_dim=8, encoder_hiddens=(8,),
            decoder_hiddens=(8,), scale_factor=1e6, radius_kmax=6, self_loops=True,
            output_scale=1e3)},
        "train": {"dir": data_dir, "epochs": 2, "batch_size": 8, "lr": 0.01,
                  "batch_mode": "mixed", "merge_files": True, "hold_epochs": True,
                  "kwargs": dict(
                      in_channels=4, filter_resolution=(3, 2), radius=1.0,
                      continuous_conv_layers=2, continuous_conv_dim=8,
                      encoder_hiddens=(8, 12), decoder_hiddens=(8,), scale_factor=1e6)},
    }


# ----------------------------------------------------------------- helpers

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _close(name, got, want, rtol=0.0, atol=0.0, scaled=False) -> dict:
    """max |got - want| against ``atol + rtol |want|`` (both over max |want|
    with ``scaled``); raises past the bar. :return: the error and whether the
    bits are equal."""
    g, w = _np(got), _np(want)
    bits = bool(np.array_equal(g, w))
    if scaled:
        s = max(np.abs(w).max(), 1e-300)
        g, w = g / s, w / s
    d = np.abs(g - w)
    excess = float((d - (atol + rtol * np.abs(w))).max()) if d.size else 0.0
    if not np.isfinite(g).all() or excess > 0:
        raise AssertionError(f"{name}: max |d| {d.max():.3e} over the bar rtol {rtol} "
                             f"atol {atol}{' (scaled)' if scaled else ''}")
    return {"max_abs_err": float(d.max()) if d.size else 0.0, "bits_equal": bits}


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count (``.launches``) by its short name."""
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops import treeforce as tf

    return {"b1": pw.partial_accelerations.launches, "b1n": pw.near_accelerations.launches,
            "b2": pw.pair_potential.launches, "b3": cck.contconv_collect.launches,
            "b4": cck.contconv_bwd_filters.launches, "b5": cck.contconv_bwd_feat.launches,
            "b6": cck.contconv_bwd_geom.launches, "b7": sp.morton_select.launches,
            "b8": sp.morton_merge.launches, "b9": tf.multipole_acc.launches,
            "b10": tf.grouped_multipole_acc.launches}


class Launches:
    """The kernel launches of the sharded calls only, summed over the blocks
    run under :meth:`count` (the single-rank references run outside)."""

    def __init__(self):
        self.total = dict.fromkeys(kernel_counts(), 0)

    @contextlib.contextmanager
    def count(self):
        before = kernel_counts()
        try:
            yield
        finally:
            for k, v in kernel_counts().items():
                self.total[k] += v - before[k]


def _timed(fn, device, reps: int, launches=None):
    """``fn()`` ``reps`` times; (last result, ms of the last call). With
    ``launches``, the calls' kernel launches are counted there."""
    out, sec = None, 0.0
    with launches.count() if launches is not None else contextlib.nullcontext():
        for _ in range(reps):
            out, sec = device_time(fn, device)
    return out, 1e3 * sec


def _system(n, seed, device):
    """The JAX ring tests' bodies: normal positions (x3), velocities (x0.1),
    masses U(0.1, 1)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1, n).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pos, vel, mass))


def _spiral(n, seed, device):
    from nbody_tpu_torch.ics import generate_spiral

    return generate_spiral(torch.Generator().manual_seed(seed), n, device=device)


# ------------------------------------------------------------------- paths

def _ring(device, s, mesh, rank0, reps, launches):
    from nbody_tpu_torch.core.forces import kinetic_energy
    from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
    from nbody_tpu_torch.ops.pairwise import accelerations, potential_energy
    from nbody_tpu_torch.parallel.ring import (ring_accelerations, ring_energies,
                                               ring_simulate)

    pos, vel, mass = _system(s["n"], 0, device)
    be = s["backend"]
    acc, ms = _timed(lambda: ring_accelerations(pos, mass, G, EPS, mesh, backend=be),
                     device, reps, launches)
    (u, k), e_ms = _timed(lambda: ring_energies(pos, vel, mass, G, EPS, mesh), device, reps,
                          launches)
    ((p1, v1, _), _), _ = _timed(lambda: ring_simulate(pos, vel, mass, 1, G, EPS, s["dt"],
                                                       mesh, backend=be), device, 1, launches)
    if not rank0:
        return None
    want, ms1 = _timed(lambda: accelerations(pos, mass, G, EPS), device, reps)
    (u1, k1), e_ms1 = _timed(lambda: (potential_energy(pos, mass, G, EPS),
                                      kinetic_energy(vel, mass)), device, reps)
    traj = simulate(pos, vel, mass, 1, SimulationConfig(
        g_const=G, softening=EPS, dt=s["dt"], calc_energy=False,
        force_backend="kernel" if be == "kernel" else "dense"))
    out = {"acc": {**_close("ring acc", acc, want, atol=1e-5, scaled=True), "ms": ms,
                   "single_ms": ms1},
           "energies": {**_close("ring U", u, u1, rtol=1e-6),
                        "k": _close("ring K", k, k1, rtol=1e-6), "ms": e_ms,
                        "single_ms": e_ms1},
           "step": _close("ring step pos", p1, traj.positions[-1], rtol=1e-4, atol=1e-6)}
    _close("ring step vel", v1, traj.velocities[-1], rtol=1e-4, atol=1e-6)
    return out


def _bh(device, s, mesh, rank0, reps, launches):
    from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
    from nbody_tpu_torch.ops import treeforce as tf
    from nbody_tpu_torch.parallel import bh

    out = {}
    pos, vel, mass = _spiral(s["n"], 0, device)
    for name in ("bh", "bh2", "bh3"):
        if name not in s:
            continue
        kw = s[name]
        n = s.get(f"{name}_n", s["n"])
        p, v, m = (pos, vel, mass) if n == s["n"] else _spiral(n, 1, device)
        sharded = getattr(bh, f"sharded_{name}_accelerations")
        single = getattr(tf, f"{name}_accelerations")
        got, ms = _timed(lambda: sharded(p, m, G, EPS, mesh, **kw), device, reps, launches)
        if rank0:
            want, ms1 = _timed(lambda: single(p, m, G, EPS, **kw), device, reps)
            nb = -(-n // kw["block"])
            units = nb if name == "bh" else -(-nb // kw["coarse"])
            if units % mesh.size("particles") == 0:  # even: the single-rank bits
                rec = _close(f"sharded {name}", got, want)
            else:
                rec = _close(f"sharded {name}", got, want, rtol=1e-4, atol=1e-9)
            out[name] = {**rec, "n": n, "even": units % mesh.size("particles") == 0,
                         "ms": ms, "single_ms": ms1}
    if "uneven_n" in s:  # the JAX test's 14 blocks
        p, _, m = _spiral(s["uneven_n"], 2, device)
        got, _ = _timed(lambda: bh.sharded_bh_accelerations(p, m, G, EPS, mesh, **s["bh"]),
                        device, 1, launches)
        if rank0:
            out["bh_uneven"] = _close("sharded bh, uneven blocks", got,
                                      tf.bh_accelerations(p, m, G, EPS, **s["bh"]),
                                      rtol=1e-4, atol=1e-9)
    if s.get("steps"):
        kw = s["bh"]
        steps, refresh = s["steps"], s["refresh"]
        (p1, v1, _), ms = _timed(lambda: bh.bh_simulate(
            pos, vel, mass, steps, G, EPS, 1e-4, mesh, refresh=refresh, **kw), device, 1,
            launches)
        if rank0:
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4, calc_energy=False,
                                   force_backend="bh", bh_near=kw["n_near"],
                                   bh_block=kw["block"], bh_refresh=refresh)
            traj, ms1 = _timed(lambda: simulate(pos, vel, mass, steps, cfg), device, 1)
            out["bh_simulate"] = {
                **_close("bh_simulate pos", p1, traj.positions[-1], rtol=1e-5, atol=1e-8),
                "vel": _close("bh_simulate vel", v1, traj.velocities[-1], rtol=1e-5,
                              atol=1e-8),
                "steps": steps, "ms_per_step": ms / steps, "single_ms_per_step": ms1 / steps}
    return out if rank0 else None


def _gnn(device, s, mesh, rank0, reps, launches):
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.parallel.surrogate import sharded_rollout
    from nbody_tpu_torch.train.rollout import autoregressive_rollout

    model = GraphModel(**s["kwargs"], generator=torch.Generator().manual_seed(0))
    if s.get("weights"):
        model.load_state_dict(torch.load(s["weights"], map_location="cpu", weights_only=True))
    model = model.to(device)
    pos, vel, mass = _system(s["n"], 3, device)
    pos = pos / 3.0
    steps, dt = s["steps"], s["dt"]
    got, ms = _timed(lambda: sharded_rollout(model, pos, vel, mass, steps, dt, mesh),
                     device, reps, launches)
    if not rank0:
        return None
    want, ms1 = _timed(lambda: autoregressive_rollout(model, pos, vel, mass, steps, dt),
                       device, reps)
    rec = {name: _close(f"sharded rollout {name}", g, w, rtol=5e-5, atol=1e-7,
                        scaled=name == "acc")
           for name, g, w in zip(("pos", "vel", "acc"), got, want)}
    return {**rec, "n": s["n"], "steps": steps, "ms_per_step": ms / steps,
            "single_ms_per_step": ms1 / steps}


def _contconv_model(s, device):
    if s.get("config"):
        from nbody_tpu_torch.config import ExperimentConfig

        cfg = ExperimentConfig.load(s["config"]).apply_overrides(s.get("overrides", []))
        return cfg.build_model(torch.Generator().manual_seed(s.get("seed", 0))).to(device)
    from nbody_tpu_torch.models import ContinuousConvModel

    return ContinuousConvModel(**s["kwargs"],
                               generator=torch.Generator().manual_seed(0)).to(device)


def _pre_norm_biases(model) -> set:
    """The biases of the Linear layers that feed a batch norm: their
    gradient is zero up to rounding noise that any two summation orders
    draw differently."""
    enc = model.encoder
    return set() if enc is None or enc.norms is None else {
        f"encoder.layers.{i}.bias" for i in range(len(enc.norms))}


def _contconv(device, s, mesh, rank0, reps, launches):
    from nbody_tpu_torch.parallel.surrogate import (sharded_contconv_loss_and_grad,
                                                    sharded_contconv_predict)
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.train.rollout import predict_accelerations

    model = _contconv_model(s, device)
    pos, vel, mass = _system(s["n"], 4, device)
    pos = pos / 3.0
    y = torch.from_numpy(np.random.default_rng(5).normal(size=(s["n"], 3)).astype(
        np.float32) * 1e-6).to(device)
    got, ms = _timed(lambda: sharded_contconv_predict(model, pos, vel, mass, mesh),
                     device, reps, launches)
    ref = copy.deepcopy(model)  # the single-rank step starts from the same stats
    for _ in range(reps - 1):  # warm-up steps on copies: a step updates the stats
        _timed(lambda: sharded_contconv_loss_and_grad(copy.deepcopy(model), pos, vel, mass,
                                                      y, mesh), device, 1, launches)
    (loss, grads, stats), g_ms = _timed(
        lambda: sharded_contconv_loss_and_grad(model, pos, vel, mass, y, mesh), device, 1,
        launches)
    if not rank0:
        return None
    want, ms1 = _timed(lambda: predict_accelerations(ref, pos, vel, mass), device, reps)
    out = {"predict": {**_close("sharded contconv predict", got, want, rtol=5e-5,
                                atol=1e-7, scaled=True), "n": s["n"], "ms": ms,
                       "single_ms": ms1}}
    ref.train()
    names = [k for k, t in ref.named_parameters() if t.requires_grad]

    def single_step():
        x = torch.cat([pos, vel, mass[:, None]], -1)[None]
        idx, valid = build_graph(ref.graph_spec, x[..., :3])
        pred = ref(x, idx, valid)[0]
        loss = torch.sqrt(((ref.scale_factor * (pred - y)) ** 2).mean())
        named = dict(ref.named_parameters())
        return loss, torch.autograd.grad(loss, [named[k] for k in names])

    (want_loss, want_g), g_ms1 = _timed(single_step, device, 1)
    noisy = _pre_norm_biases(ref)
    out["loss"] = {**_close("sharded contconv loss", loss, want_loss, rtol=1e-5),
                   "ms": g_ms, "single_ms": g_ms1}
    out["grads"] = max((_close(f"grad {k}", grads[k], g, rtol=2e-4, atol=1e-5, scaled=True)
                        for k, g in zip(names, want_g) if k not in noisy),
                       key=lambda r: r["max_abs_err"])
    want_stats = {k: t for k, t in ref.state_dict().items() if k.endswith(("_mean", "_var"))}
    out["batch_stats"] = max((_close(f"stat {k}", stats[k], t, rtol=1e-5, atol=1e-8)
                              for k, t in want_stats.items()),
                             key=lambda r: r["max_abs_err"])
    return out


def _trained(model) -> list:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _trainers():
    """Two ``Trainer`` subclasses for :func:`_train`'s step-by-step check."""
    from nbody_tpu_torch.train import Trainer

    class Recorded(Trainer):
        """Keeps, for every optimiser step of every epoch, the parameters
        the step started from, its loss and the gradients it applied."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.record = []

        def _apply_step(self, loss):
            params = [p for _, p in _trained(self.model)]
            before = [p.detach().clone() for p in params]
            super()._apply_step(loss)
            self.record.append((before, loss.detach(),
                                [p.grad.detach().clone() for p in params]))

    class Replayed(Trainer):
        """Takes every step from the recorded parameters, holds the step's
        gradients to the recorded ones (rtol 2e-4, atol 1e-5 of the largest
        element, the parameters in ``skip`` left out) and puts the next
        recorded parameters in the place of its own update."""

        def __init__(self, model, record, skip, **kw):
            super().__init__(model, **kw)
            self.record, self.skip = record, skip
            self.losses, self.grad_err = [], 0.0
            self._load(0)

        def _load(self, k):
            with torch.no_grad():
                for (_, p), t in zip(_trained(self.model), self.record[k][0]):
                    p.copy_(t)

        def _apply_step(self, loss):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            k = len(self.losses)
            self.losses.append(loss.detach())
            for (name, p), got in zip(_trained(self.model), self.record[k][2]):
                if name in self.skip:
                    continue
                want = torch.zeros_like(p) if p.grad is None else p.grad
                scale = want.abs().max().clamp_min(1e-30)
                d = (got - want).abs() / scale
                excess = float((d - (1e-5 + 2e-4 * want.abs() / scale)).max())
                if not torch.isfinite(got).all() or excess > 0:
                    raise AssertionError(
                        f"data-parallel step {k} grad {name}: max |d| {float(d.max()):.3e} "
                        "over the bar rtol 0.0002 atol 1e-05 (scaled)")
                self.grad_err = max(self.grad_err, float(d.max()))
            if k + 1 < len(self.record):
                self._load(k + 1)

    return Recorded, Replayed


def _train(device, s, rank0, reps, launches):
    """Epochs of ``Trainer(mesh=)`` against the one-process ``Trainer``.

    Every optimiser step is held on its own: each rank records the
    parameters every data-parallel step started from and the all-reduced
    gradients it applied, and on rank 0 a one-process ``Trainer`` replays
    the epochs from those parameters, step by step: each step's loss at
    rtol 2e-4, its gradients at rtol 2e-4, atol 1e-5 of the largest element
    (the biases that feed a batch norm left out: rounding noise). The
    free-running epochs, each from its own updates, are held at rtol 2e-4
    only with ``s["hold_epochs"]``: the ranks sum in another order than one
    process, and over a long epoch Adam magnifies that rounding. How far is
    reported beside: the epoch means' relative difference, and that of a
    one-process run whose initial weights were moved up by one ulp. With
    ``reps > 1`` every rank first trains one untimed epoch alone, so that
    neither timed run pays the process's first training steps."""
    from nbody_tpu_torch.train import Trainer

    Recorded, Replayed = _trainers()
    mesh = make_mesh(axis_names=(DATA_AXIS,))
    kw = dict(epochs=s["epochs"], batch_size=s["batch_size"], verbose=False,
              batch_mode=s["batch_mode"], merge_files=s["merge_files"])
    if reps > 1:
        Trainer(_contconv_model(s, device), learning_rate=s["lr"],
                dt=1e-4).train_from_dir(s["dir"], **kw)
        dist.barrier()
    dp = Recorded(_contconv_model(s, device), learning_rate=s["lr"], dt=1e-4, mesh=mesh)
    with launches.count():
        (got, _), sec = device_time(lambda: dp.train_from_dir(s["dir"], **kw), device)
    if not rank0:
        return None
    model = _contconv_model(s, device)
    replay = Replayed(model, dp.record, _pre_norm_biases(model), learning_rate=s["lr"],
                      dt=1e-4)
    replay.train_from_dir(s["dir"], **kw)
    rec = _close("data-parallel step losses", torch.stack([r[1] for r in dp.record]),
                 torch.stack(replay.losses), rtol=2e-4)
    single = Trainer(_contconv_model(s, device), learning_rate=s["lr"], dt=1e-4)
    (want, _), sec1 = device_time(lambda: single.train_from_dir(s["dir"], **kw), device)
    if s.get("hold_epochs"):
        _close("data-parallel epoch losses", torch.tensor(got), torch.tensor(want), rtol=2e-4)
    moved = Trainer(_contconv_model(s, device), learning_rate=s["lr"], dt=1e-4)
    with torch.no_grad():
        for p in moved.model.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    ulp, _ = moved.train_from_dir(s["dir"], **kw)
    return {**rec, "grads_max_abs_err": replay.grad_err, "steps": len(dp.record),
            "losses": got, "single_losses": want, "ulp_losses": ulp,
            "epoch_rel_diff": abs(got[-1] - want[-1]) / abs(want[-1]),
            "ulp_epoch_rel_diff": abs(ulp[-1] - want[-1]) / abs(want[-1]),
            "s_per_epoch": sec / s["epochs"], "single_s_per_epoch": sec1 / s["epochs"]}


def check_paths(device, spec: dict) -> dict:
    """A rank body for :func:`parallel.launch.run_ranks`: every path of
    ``spec`` sharded over all ranks, rank 0 holding each result to the
    single-rank one computed in its own process. Raises on a miss.
    :return: rank 0's numbers by path (None on the other ranks)."""
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    rank0 = dist.get_rank() == 0
    reps = spec.get("reps", 1)
    mesh = make_mesh()
    launches = Launches()
    out = {"world": dist.get_world_size(), "backend": dist.get_backend(),
           "device": str(device)}
    t0 = time.perf_counter()
    for name, fn in (("ring", _ring), ("bh", _bh), ("gnn", _gnn),
                     ("contconv", _contconv)):
        if name in spec:
            out[name] = fn(device, spec[name], mesh, rank0, reps, launches)
            out[f"{name}_wall_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    if "train" in spec:
        out["train"] = _train(device, spec["train"], rank0, reps, launches)
        out["train_wall_s"] = time.perf_counter() - t0
    out["launches"] = launches.total
    if imported_jax():
        raise AssertionError(f"a rank imported JAX or the JAX package: {imported_jax()}")
    return out if rank0 else None


def write_train_data(out_dir: str, device) -> None:
    """Two small training files (8- and 12-body scenes) for check 1."""
    from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset

    for i, (n, kind) in enumerate(((8, "spiral"), (12, "disk"))):
        generate_dataset([ScenarioConfig(n_bodies=n, sim_type=kind, steps=20, seed=i + 1,
                                         force_backend="dense")],
                         os.path.join(out_dir, f"f{i}.csv"), verbose=False, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default=None,
                    help="device of every rank (cpu, cuda:0); default cuda:(rank %% count)")
    args = ap.parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    setup_device = rank_device(0, args.device)
    with tempfile.TemporaryDirectory(prefix="nbody_dryrun_") as tmp:
        write_train_data(tmp, setup_device)
        spec = small_spec(tmp)
        if setup_device.type == "cpu":
            spec["threads"] = 1
        out = run_ranks(check_paths, args.ranks, backend, spec, device=args.device)
    for name in ("train", "ring", "bh", "gnn", "contconv"):
        print(f"{name}: {json.dumps(out[name], default=float)}")
    print(f"dryrun: {args.ranks} ranks over {backend} on {out['device']}: every path "
          "matches the single-rank result")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
