#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``nbody_tpu_torch/csrc`` and drives
the port's main path once:

0. device and build: the card's name and power limit, full-f32 matmuls, the
   kernels built with nvcc for sm_90a;
1. every kernel against its plain-torch twin on spiral initial conditions,
   with kernel and twin times, and the kernel simulate path against the
   dense one;
2. the reference-recipe datagen through ``nbody_tpu_torch.cli.datagen`` (six
   spiral scenes of 3-500 bodies, 1000 leapfrog steps, energy columns), with
   the kernels' launch counters checked and the 500-body energy drift bounded;
3. one 20,000-body spiral scene of 200 steps with energies;
4. the EdgeConv surrogate at the reference width (seeded random weights):
   stepwise and 1000-step rollout evaluation over the phase-2 dataset, then
   a 50-step rollout at 20,000 bodies;
5. the large-N kernels against their twins on spiral initial conditions:
   the Morton select (B7) and merge (B8) at 20,000 and 100,000 bodies for
   kNN(10) and the radius search's k = 32 with self edges, recall against
   exact kNN, the ContConv collect (B3) on the geometry of a Morton radius
   graph at D = 6 and 4, and the full-width ContinuousConvModel on the card
   against the CPU;
6. the large-N surrogate path through
   ``nbody_tpu_torch.experiments.large_scale`` at 100,000 bodies, 20 steps,
   modes direct, surrogate and hybrid, for the reference-width ContConv
   model and the GNN with Morton kNN;
7. the backward of B3 against its plain version: B4 (filters), B5
   (features) and B6 (geometry) on the 100,000-body Morton radius graph's
   geometry at D = 6 and 4 and on one small odd shape, each twice for the
   same bits; then the full-width ContinuousConvModel's parameter and
   position gradients with the kernels against the dense layer (the
   position gradient is the path that launches B6);
8. the training path: ``nbody_tpu_torch.experiments.run`` with
   ``configs/contconv_adopted.json`` as it stands, at full width, whose
   layers take the kernels on the card with no override (datagen cut to 2
   files of 200 steps, 2 epochs, a checkpoint each), a
   resumed third epoch and the evaluation from the checkpoints; the
   recipe-shape training step timed and profiled; ``gnn_experiment
   --quick``; and the 100,000-body training step (Morton radius search,
   B3 + B4 + B5, batch 1) on a strided port-datagen dataset, beside the
   dense layer's step at the largest N that fits;
9. the treecodes: (a) B9 (far field), B10 (grouped multipoles) and B1's
   near-list form against their plain versions, each twice for the same
   bits, on the shapes of the 100,000-body bh recipe (M=32, B=256) and of
   the 1,000,000-body bh3 recipe (B=128, C=16, rc=48, Bs=32, K=48); (b) each
   engine's kernel path against its dense path on one partition at 100,000
   bodies; (c) ``nbody_tpu_torch.experiments.bh_rollout`` through its
   ``main``: bh at 100,000 bodies for 200 steps with the exact energy audit
   (B2), and bh3 at 1,000,000 bodies for 16 steps in chunks of 8 with the
   sampled force audit; (d) ``treeforce_bench`` at 100,000 bodies for each
   engine;
10. the large-N entry points: (a) B11, the windowed EdgeConv message sum,
    against its plain version at a small odd shape and at 1,000,192 rows
    (k = 8, d = 64, tile 256, half 384), float32 and bfloat16 gather, each
    twice for the same bits; (b) the crossover path's own data at 1M: spiral
    bodies in Morton order, their Morton graph (B7, B8) with the select and
    the merge behind it against their plain versions at that size, its
    recall against the exact search and B1 against its plain version on
    4096 receivers over all 1M sources; ``u'`` and ``v`` of
    the first EdgeConv of the 1M model with the committed trained weights,
    ``edge_message_sum`` (B11 + fallback list) against the fused layer's
    masked tanh sum, with the in-window share, the overflow (0) and the
    times of the torch gather, of B11 alone and of B11 + fallback; (c) the
    fused against the unfused ``GraphModel`` forward at 100,000 bodies, with
    each one's peak memory; (d) ``nbody_tpu_torch.experiments.crossover``
    through its ``main``: every mode at 100k, direct, bh3 and the surrogate
    at 1M with the trained weights; (e) ``train_large`` through its ``main``:
    the GNN at 1M with ``--remat`` (2 epochs, a resumed third, an eval-only
    rerun from the saved weights) and the full-width ContConv at 100k with 4
    node chunks beside the unchunked layer; (f) ``knn_recall`` at 100k.

Every phase raises on failure, so the exit code is non-zero and no result
line is printed. Informative lines come first. The last three lines are a
JSON object with one entry per kernel (launches counted over the path that
runs it, its counters set to 0 just before the path and read just after:
phases 2-4 for B1 and B2, phase 6 for B3, B7 and B8, phase 8 for B4 and B5,
the phase-7 position gradient for B6, phase 9c for B9, B10 and B1's near
list, phase 10b for B11, which stands beside the model as in the JAX
package, so that the entry points of 10d and 10e leave it at 0: each of
their ``main`` calls starts with the counters at 0 and is held, right after
it returns and before any profiling helper runs, to the kernels it must
launch, B1, B3-B5, B7-B10 and the near list between them; errors and times
from phases 1, 5, 7, 9a and 10a; ``bound_ms``, the least
time of the same work on the card, from the operations and bytes of those
inputs, see :func:`bound`), the card's ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

G, EPS, DT = 4.5e-6, 0.05, 1e-4
B1_TOL = 2e-5      # max |da| / max |a| (tests/test_forces.py:56,65)
B2_TOL = 1e-5      # relative PE error (tests/test_forces.py:114-130)
DRIFT_500 = 1e-4   # 500-body leapfrog energy drift over 1000 steps
DRIFT_20K = 1e-3   # 20k-body drift over 200 steps (treecode tests' bar)
RECIPE_N = [3, 25, 50, 100, 250, 500]
SOURCES = ("pairwise", "spatial", "contconv", "treeforce", "edgeconv")
RECIPE_STEPS = 1000
BIG_N, BIG_STEPS, SURR_STEPS = 20_000, 200, 50
LARGE_N, LARGE_STEPS = 100_000, 20
RECALL = 0.99      # Morton kNN recall (tests/test_spatial.py:69-76,132-141)
B3_TOL = 2e-4      # max |dout| / max |out| (tests/test_models.py:161); B4-B6 too
MODEL_RTOL, MODEL_ATOL = 2e-4, 1e-5  # atol times max |a|; gradients too
# (tests/test_models.py:387-391,429-430)
GRAD_N = 2_000     # bodies of the full-width model's card checks
# configs/contconv_adopted.json's widths with the Morton radius search
FULL_CONTCONV = dict(in_channels=4, out_channels=3, filter_resolution=(6, 4), radius=1.0,
                     agg="mean", self_loops=True, continuous_conv_layers=2,
                     continuous_conv_dim=128, encoder_hiddens=(32, 64),
                     decoder_hiddens=(64, 32), scale_factor=1e6, radius_method="morton",
                     radius_impl="kernel", conv_impl="kernel")
# the config's own model: its layers take the kernels for card tensors
RUN_SETS = ["datagen.train_files=2", "datagen.steps=200", "train.save_every=1"]
TRAIN_STEPS, TRAIN_STRIDE = 50, 10  # the 100k dataset: 5 snapshots
# the treecodes: the JAX package's recipes (results/large_scale/bh_rollout*.json)
TREE_N, TREE_1M = 100_000, 1_000_000
BH_100K = dict(n_near=32, block=256)
BH3_1M = dict(n_near=32, block=128, coarse=16, rc=48, sub_block=32, n_sub=48)
MULT_TOL = 1e-5    # B9/B10 against their plain versions, max |d| / max |plain|
NEAR_ATOL = {"bh": 5e-9, "bh2": 5e-9, "bh3": 2e-8}  # kernel vs dense path, rtol 2e-3
# (tests/test_treeforce.py:136-137,241-242,401-402), met at 100k by all but
SEAM_SHARE = 1e-4  # this share of elements (see phase9_engines)
BH_DRIFT = 1e-3    # 100k bh rollout energy drift (tests/test_treeforce.py:120-121)
BH3_MEDIAN = 5e-2  # 1M bh3 sampled median relative force error
B11_TOL = 2e-6     # rtol = atol of B11 against its plain version
# (attic/test_edgeconv_kernel.py:44)
TANH_FLOPS = 20.0  # taken for one float32 tanhf (an exp, a division, a few fmas)
WINDOW = dict(tile=256, half=384)  # the JAX module's defaults
PARAMS_1M = os.path.join(HERE, "results", "large_scale", "train_1m_params.pt")
# the crossover / train_1m GNN (results/large_scale/train_1m.json)
GNN_1M = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean", neighbors=8,
              scale_factor=1e6, knn_method="morton", knn_impl="kernel")
CHUNKS = 4         # node chunks of the 100k ContConv training run
SAMPLE_1M = 4096   # receivers of the 1M path's exact-search and direct-sum checks
# published peaks of one H100 SXM (NVIDIA's data sheet): FP32
# outside the tensor cores and HBM bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time of work that does ``flops``
    FP32 operations and moves ``nbytes`` (each input read once, each output
    written once), the larger of the two at the card's published peaks."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def collect_bound(gx, gy, gz, win, ci: int, co: int, d: int, other_bytes: float):
    """(bound_ms, bound_by) of B3-B6 on one geometry: per touched (receiver,
    cell) pair a ci x co product (2 ci co flops), per edge corner a ci-wide
    weighted feature sum (2 ci). The pairs are counted from these inputs:
    corners of nonzero weight on edges of nonzero window. Bytes: the four
    (M, k) geometry inputs, the (M, k, ci) features (or, for B5, their
    cotangent), the (D^3, ci, co) filters (or, for B4, their cotangent) and
    ``other_bytes`` of the kernel's other operands and outputs."""
    import torch

    from nbody_tpu_torch.ops.interpolate import trilinear_corners

    m, k = win.shape
    touched, rows = 0, max(1, (1 << 22) // k)
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        cidx, cw = trilinear_corners(torch.stack([gx[sl], gy[sl], gz[sl]], -1).reshape(-1, 3), d)
        live = (cw != 0) & (win[sl].reshape(-1, 1) != 0)
        recv = torch.arange(r0, r0 + win[sl].shape[0], device=win.device).repeat_interleave(k)
        keys = recv[:, None].expand_as(cidx)[live] * d ** 3 + cidx[live].long()
        touched += torch.unique(keys).numel()
    flops = 2.0 * touched * ci * co + 2.0 * 8 * m * k * ci
    nbytes = 4.0 * (4 * m * k + m * k * ci + d ** 3 * ci * co) + other_bytes
    return bound(flops, nbytes)


def rel_drift(u, k) -> float:
    import numpy as np

    e = np.asarray(u, np.float64) + np.asarray(k, np.float64)
    return float(np.abs(e - e[0]).max() / abs(e[0]))


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its short name; each counts its
    launches in ``.launches``."""
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops import treeforce as tf

    return {"b1": pw.partial_accelerations, "b2": pw.pair_potential,
            "b3": cck.contconv_collect, "b4": cck.contconv_bwd_filters,
            "b5": cck.contconv_bwd_feat, "b6": cck.contconv_bwd_geom,
            "b7": sp.morton_select, "b8": sp.morton_merge,
            "b9": tf.multipole_acc, "b10": tf.grouped_multipole_acc,
            "b1n": pw.near_accelerations, "b11": ek.windowed_tanh_sum}


def zero_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def entry_point_counts(label: str, need) -> dict:
    """The launch counts of one entry point's ``main``, read right after it
    (they were set to 0 just before): every kernel of ``need`` must have
    launched there, and B6 and B11, which no entry point of 10d and 10e
    reaches, must not."""
    ran = read_counts()
    log(f"[10] launches in {label}: {ran}")
    if min(ran[k] for k in need) == 0 or ran["b6"] or ran["b11"]:
        raise AssertionError(f"{label}: launches {ran}; {need} must be above 0, B6 and B11 "
                             f"at 0 (B11 stands beside the model)")
    return ran


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA required (torch.cuda.is_available() "
                         "is False); the port has no CPU fallback for this run")
    sys.path.insert(0, HERE)
    from nbody_tpu_torch.ops import build  # fails when run alone

    card = card_line()
    log(f"[0] card: {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on"
    t0 = time.perf_counter()
    build.load_all(SOURCES)  # one nvcc per source, all at once
    log(f"[0] kernels built in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        info = build.BUILD_INFO[name]
        log(f"[0] {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[0]   ptxas: {line.strip()}")
    return card


def phase1_kernels():
    """Each kernel against its twin; returns the 20k-shape numbers."""
    import torch

    from nbody_tpu_torch.core import SimulationConfig, simulate
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    results = {}
    for n in (500, 1_000, BIG_N):
        pos, _, mass = generate_spiral(torch.Generator().manual_seed(n), n, device=dev)
        acc_k = pw.partial_accelerations(pos, pos, mass, G, EPS)
        acc_t = pw.partial_accelerations_torch(pos, pos, mass, G, EPS)
        d_acc = float((acc_k - acc_t).abs().max())
        rel_acc = d_acc / float(acc_t.abs().max())
        ms_k = cuda_time_ms(lambda: pw.partial_accelerations(pos, pos, mass, G, EPS))
        ms_t = cuda_time_ms(lambda: pw.partial_accelerations_torch(pos, pos, mass, G, EPS),
                            reps=5, warmup=1)
        log(f"[1] B1 force    N={n}: max|da|/max|a| {rel_acc:.3e} (bar {B1_TOL}) "
            f"kernel {ms_k:.4f} ms  twin {ms_t:.4f} ms")
        if not rel_acc <= B1_TOL:
            raise AssertionError(f"B1 disagrees with its twin at N={n}: {rel_acc}")

        u_k = pw.pair_potential(pos, mass, pos, mass, G, EPS, masked=True)
        u_t = pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, masked=True)
        d_u = abs(float(u_k) - float(u_t))
        rel_u = d_u / abs(float(u_t))
        ms_uk = cuda_time_ms(lambda: pw.pair_potential(pos, mass, pos, mass, G, EPS, True))
        ms_ut = cuda_time_ms(lambda: pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, True),
                             reps=5, warmup=1)
        log(f"[1] B2 energy   N={n}: U kernel {float(u_k):.9e} twin {float(u_t):.9e} "
            f"rel {rel_u:.3e} (bar {B2_TOL}) kernel {ms_uk:.4f} ms  twin {ms_ut:.4f} ms")
        if not rel_u <= B2_TOL:
            raise AssertionError(f"B2 (masked) disagrees with its twin at N={n}: {rel_u}")
        # B1: ~20 flops a pair (csrc/pairwise.cu); B2: ~13 a pair of the upper triangle
        results[n] = dict(b1=(d_acc, ms_k, ms_t, bound(20.0 * n * n, 40.0 * n)),
                          b2=(d_u, ms_uk, ms_ut, bound(13.0 * n * (n - 1) / 2, 32.0 * n + 4)))

    pos, _, mass = generate_spiral(torch.Generator().manual_seed(8), 8_000, device=dev)
    a, ma, b, mb = pos[:3_000], mass[:3_000], pos[3_000:], mass[3_000:]
    a, b = a.contiguous(), b.contiguous()
    x_k = pw.pair_potential(a, ma, b, mb, G, EPS, masked=False)
    x_t = pw.pair_potential_torch(a, ma, b, mb, G, EPS, masked=False)
    rel_x = abs(float(x_k) - float(x_t)) / abs(float(x_t))
    ms_xk = cuda_time_ms(lambda: pw.pair_potential(a, ma, b, mb, G, EPS, False))
    ms_xt = cuda_time_ms(lambda: pw.pair_potential_torch(a, ma, b, mb, G, EPS, False),
                         reps=5, warmup=1)
    log(f"[1] B2 cross 3000x5000: rel {rel_x:.3e} (bar {B2_TOL}) "
        f"kernel {ms_xk:.4f} ms  twin {ms_xt:.4f} ms")
    if not rel_x <= B2_TOL:
        raise AssertionError(f"B2 (cross) disagrees with its twin: {rel_x}")
    # the kernel backend against the dense torch path on the card
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(3), 256,
                                     device=torch.device("cuda"))
    cfg = dict(g_const=G, softening=EPS, dt=DT, calc_energy=True)
    tk = simulate(pos, vel, mass, 100, SimulationConfig(**cfg, force_backend="kernel"))
    td = simulate(pos, vel, mass, 100, SimulationConfig(**cfg, force_backend="dense"))
    d_pos = float((tk.positions - td.positions).abs().max())
    d_u = float(((tk.u_energy - td.u_energy) / td.u_energy).abs().max())
    log(f"[1] simulate N=256 x100 kernel vs dense: max|dpos| {d_pos:.3e} rel dU {d_u:.3e}")
    if not (d_pos <= 1e-5 and d_u <= 1e-5):
        raise AssertionError("kernel and dense simulate disagree on the card")

    torch.cuda.synchronize()
    return results[BIG_N]


def phase2_datagen(out_dir: str):
    import numpy as np
    import pandas as pd

    from nbody_tpu_torch.cli import datagen
    from nbody_tpu_torch.data.schema import CSV_FIELDS
    from nbody_tpu_torch.ops import pairwise as pw

    csv = os.path.join(out_dir, "recipe.csv")
    b1_0, b2_0 = pw.partial_accelerations.launches, pw.pair_potential.launches
    t0 = time.perf_counter()
    datagen.main([
        "--n-bodies", *map(str, RECIPE_N), "--sim-type", "spiral",
        "--steps", str(RECIPE_STEPS), "--dt", str(DT), "--softening", str(EPS),
        "--g", str(G), "--seed", "42", "--force-backend", "kernel",
        "--device", "cuda", "--output", csv])
    wall = time.perf_counter() - t0
    b1 = pw.partial_accelerations.launches - b1_0
    b2 = pw.pair_potential.launches - b2_0
    total_steps = len(RECIPE_N) * RECIPE_STEPS
    log(f"[2] datagen: {wall:.2f} s wall for {len(RECIPE_N)} scenes x "
        f"{RECIPE_STEPS} steps (CSV and npz writing included); "
        f"B1 launches {b1}, B2 launches {b2}")
    if b1 < total_steps or b2 < total_steps:
        raise AssertionError(f"datagen bypassed the kernels: B1 {b1}, B2 {b2}, "
                             f"steps {total_steps}")
    npz_path = csv[:-4] + ".npz"
    if not (os.path.exists(csv) and os.path.exists(npz_path)):
        raise AssertionError("datagen wrote no CSV or npz")
    df = pd.read_csv(csv)
    if list(df.columns) != CSV_FIELDS or len(df) != sum(RECIPE_N) * RECIPE_STEPS:
        raise AssertionError(f"bad CSV: columns {list(df.columns)}, rows {len(df)}")
    if not np.isfinite(df.drop(columns=["scene_type"]).to_numpy(np.float64)).all():
        raise AssertionError("non-finite values in the CSV")
    data = np.load(npz_path)
    for s, n in enumerate(RECIPE_N):
        step_ms = 1e3 * float(data[f"scene{s}_meta"][3])
        log(f"[2] scene {s} N={n}: {step_ms:.4f} ms/step, energy drift "
            f"{rel_drift(data[f'scene{s}_u'], data[f'scene{s}_k']):.3e}")
    drift = rel_drift(data["scene5_u"], data["scene5_k"])
    if not drift < DRIFT_500:
        raise AssertionError(f"500-body energy drift {drift} >= {DRIFT_500}")


def phase3_real_size():
    import torch

    from nbody_tpu_torch.data.generate import ScenarioConfig, run_scenario

    cfg = ScenarioConfig(n_bodies=BIG_N, sim_type="spiral", steps=BIG_STEPS,
                         dt=DT, softening=EPS, g=G, seed=7,
                         force_backend="kernel", calc_energy=True)
    traj, _, step_time = run_scenario(cfg, device="cuda")
    for t in traj:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite 20k trajectory")
    drift = rel_drift(traj.u_energy.cpu(), traj.k_energy.cpu())
    log(f"[3] N={BIG_N} x {BIG_STEPS} steps (B1 + B2 every step): "
        f"{1e3 * step_time:.4f} ms/step, energy drift {drift:.3e}")
    if not drift < DRIFT_20K:
        raise AssertionError(f"20k energy drift {drift} >= {DRIFT_20K}")
    return traj


def phase4_surrogate(data_dir: str, traj):
    import numpy as np
    import torch

    from nbody_tpu_torch.data.generate import make_initial_conditions, ScenarioConfig
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import Trainer, autoregressive_rollout, predict_accelerations
    from nbody_tpu_torch.utils.timing import device_time

    dev = torch.device("cuda")
    kw = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
              neighbors=10, scale_factor=1e6)
    model = GraphModel(**kw, generator=torch.Generator().manual_seed(0)).to(dev).eval()

    # the model on the card against the same weights on the CPU
    cpu_model = GraphModel(**kw).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pos, vel, mass = make_initial_conditions(
        ScenarioConfig(n_bodies=500, sim_type="spiral", seed=42))
    a_gpu = predict_accelerations(model, pos.to(dev), vel.to(dev), mass.to(dev)).cpu()
    a_cpu = predict_accelerations(cpu_model, pos, vel, mass)
    if not torch.allclose(a_gpu, a_cpu, rtol=1e-4, atol=1e-5):
        raise AssertionError("GraphModel on the card disagrees with the CPU")

    t0 = time.perf_counter()
    df_step, df_roll = Trainer(model, dt=DT).test_from_dir(
        data_dir, sim_steps=RECIPE_STEPS, stepwise=True, rollout=True)
    wall = time.perf_counter() - t0
    if (list(df_step.columns) != ["loss", "step_time"]
            or list(df_step.index.names) != ["filename", "scene"]
            or len(df_step) != len(RECIPE_N)):
        raise AssertionError(f"bad stepwise frame:\n{df_step}")
    if (list(df_roll.columns) != ["pos_rmse", "vel_rmse", "acc_rmse", "step_time"]
            or list(df_roll.index.names) != ["filename", "scene", "step"]
            or len(df_roll) != len(RECIPE_N) * RECIPE_STEPS):
        raise AssertionError(f"bad rollout frame:\n{df_roll}")
    for df in (df_step, df_roll):
        if not np.isfinite(df.to_numpy(np.float64)).all():
            raise AssertionError("non-finite evaluation metrics")
    log(f"[4] test_from_dir: {wall:.2f} s wall")
    log("[4] stepwise (mean per scene):\n" + df_step.to_string())
    per_scene = df_roll.groupby(level="scene").agg(
        pos_rmse_last=("pos_rmse", "last"), acc_rmse_mean=("acc_rmse", "mean"),
        step_time=("step_time", "first"))
    log("[4] rollout (1000 steps per scene):\n" + per_scene.to_string())
    for s, n in enumerate(RECIPE_N):
        log(f"[4] N={n}: stepwise {1e3 * df_step['step_time'].iloc[s]:.4f} ms/snapshot, "
            f"rollout {1e3 * per_scene['step_time'].iloc[s]:.4f} ms/step")

    pos0, vel0 = traj.positions[0].contiguous(), traj.velocities[0].contiguous()
    _, _, mass20k = make_initial_conditions(ScenarioConfig(
        n_bodies=BIG_N, sim_type="spiral", seed=7), device=dev)
    autoregressive_rollout(model, pos0, vel0, mass20k, 2, DT)  # warm-up
    (ps, vs, accs), sec = device_time(
        lambda: autoregressive_rollout(model, pos0, vel0, mass20k, SURR_STEPS, DT), dev)
    for t in (ps, vs, accs):
        if t.shape != (SURR_STEPS, BIG_N, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError("bad 20k surrogate rollout")
    log(f"[4] surrogate rollout N={BIG_N} x {SURR_STEPS} steps (chunked exact kNN): "
        f"{1e3 * sec / SURR_STEPS:.4f} ms/step")
    return 1e3 * sec / SURR_STEPS


def phase5_large_n_kernels():
    """B7, B8 and B3 against their twins on the card; the full-width
    ContConv model on the card against the CPU. Returns the numbers of the
    kernels line: B7/B8 at 100k bodies, k = 32, B3 at 100k, D = 6."""
    import torch

    from nbody_tpu_torch.experiments.knn_recall import recall_of
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import ContinuousConvModel
    from nbody_tpu_torch.models.contconv import conv_geometry
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops.knn import knn_neighbors
    from nbody_tpu_torch.ops.radius import radius_neighbors
    from nbody_tpu_torch.train import predict_accelerations
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    out = {}
    for n in (BIG_N, LARGE_N):
        pos, _, _ = generate_spiral(torch.Generator().manual_seed(n + 5), n, device=dev)
        order = sp._curve_order(pos, None, 4)
        cand, qg = sp._candidates(pos, order, 256)
        for k, inc in ((10, False), (32, True)):
            ids, d2 = sp.morton_select(cand, k, 256, inc)
            ids_t, d2_t = sp.morton_select_torch(cand, k, 256, inc)
            ok7 = torch.equal(ids, ids_t) and torch.allclose(d2, d2_t, rtol=1e-6, atol=0)
            err7 = float((d2 - d2_t).abs().max())
            ms7 = cuda_time_ms(lambda: sp.morton_select(cand, k, 256, inc))
            ms7t = cuda_time_ms(lambda: sp.morton_select_torch(cand, k, 256, inc),
                                reps=3, warmup=1)
            mc, md = sp._to_rows(qg, ids, d2, n)
            m_ids, m_d2 = sp.morton_merge(mc, md, k)
            t_ids, t_d2 = sp.morton_merge_torch(mc, md, k)
            ok8 = torch.equal(m_ids, t_ids) and torch.allclose(m_d2, t_d2, rtol=1e-6, atol=0)
            err8 = float((m_d2 - t_d2).abs().max())
            ms8 = cuda_time_ms(lambda: sp.morton_merge(mc, md, k))
            ms8t = cuda_time_ms(lambda: sp.morton_merge_torch(mc, md, k), reps=3, warmup=1)
            ms_all = cuda_time_ms(lambda: sp.knn_morton(pos, k, include_self=inc,
                                                        impl="kernel"), reps=5, warmup=1)
            log(f"[5] B7 select N={n} k={k} self={inc}: ids identical {ok7}, max|dd2| "
                f"{err7:.3e}; kernel {ms7:.4f} ms  twin {ms7t:.4f} ms")
            log(f"[5] B8 merge  N={n} k={k}: ids identical {ok8}, max|dd2| {err8:.3e}; "
                f"kernel {ms8:.4f} ms  twin {ms8t:.4f} ms; whole knn_morton(kernel) "
                f"{ms_all:.4f} ms")
            if not (ok7 and ok8):
                raise AssertionError(f"B7/B8 disagree with their twins at N={n}, k={k}")
            if n == BIG_N:
                got = sp.knn_morton(pos, k, include_self=inc, impl="kernel")
                cpu = sp.knn_morton(pos.cpu(), k, include_self=inc, impl="kernel")
                same = all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))
                rec = recall_of(*got, *knn_neighbors(pos, k, include_self=inc))
                log(f"[5] knn_morton(kernel) N={n} k={k}: card == CPU twins {same}, "
                    f"recall vs exact {rec:.5f} (bar {RECALL})")
                if not (same and rec >= RECALL):
                    raise AssertionError(f"Morton kNN at N={n}, k={k}: same {same}, "
                                         f"recall {rec}")
            if n == LARGE_N and k == 32:
                # B7: per (query, candidate) ~8 flops of distance and a compare;
                # B8: per row, k passes of a min and a mask over W candidates
                c_, L = cand.shape[0], cand.shape[1]
                nq = ids.shape[1]
                out["b7"] = (err7, ms7, ms7t, bound(9.0 * c_ * nq * 3 * 256,
                                                    16.0 * c_ * L + 8.0 * ids.numel()))
                out["b8"] = (err8, ms8, ms8t, bound(2.0 * mc.shape[0] * k * mc.shape[1],
                                                    8.0 * mc.numel() + 8.0 * m_ids.numel()))

        # B3 on the geometry of this N's Morton radius graph
        idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
        geom = conv_geometry(pos[None], idx[None], valid[None], 1.0)
        feat = torch.randn(n, 128, generator=torch.Generator().manual_seed(n)).to(dev)
        fj = feat[idx.long()].contiguous()
        win = geom["window"][0].contiguous()
        for d in (6, 4):
            grid = (geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)
            gx, gy, gz = (grid[..., a].contiguous() for a in range(3))
            filters = torch.randn(d ** 3, 128, 128,
                                  generator=torch.Generator().manual_seed(d)).to(dev)
            args = (gx, gy, gz, win, fj, filters)
            got = cck.contconv_collect(*args, d=d)
            want = cck.contconv_collect_torch(*args, d=d)
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ms = cuda_time_ms(lambda: cck.contconv_collect(*args, d=d), reps=5, warmup=1)
            ms_t = cuda_time_ms(lambda: cck.contconv_collect_torch(*args, d=d),
                                reps=3, warmup=1)
            log(f"[5] B3 collect N={n} k=32 D={d} ci=co=128: max|d|/max|out| {rel:.3e} "
                f"(bar {B3_TOL}); kernel {ms:.4f} ms  twin {ms_t:.4f} ms")
            if not rel <= B3_TOL:
                raise AssertionError(f"B3 disagrees with its twin at N={n}, D={d}: {rel}")
            if n == LARGE_N and d == 6:
                out["b3"] = (err, ms, ms_t, collect_bound(gx, gy, gz, win, 128, 128, d,
                                                          4.0 * n * 128))
        del fj, geom

    # the full-width model: kernels on the card, twins on the CPU, same weights
    model = ContinuousConvModel(**FULL_CONTCONV,
                                generator=torch.Generator().manual_seed(4)).eval()
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(2), GRAD_N)
    a_cpu = predict_accelerations(model, pos, vel, mass)
    model.to(dev)
    before = cck.contconv_collect.launches
    a_gpu = predict_accelerations(model, pos.to(dev), vel.to(dev), mass.to(dev)).cpu()
    if cck.contconv_collect.launches != before + 2:
        raise AssertionError("the model's layers did not go through B3")
    scale = float(a_cpu.abs().max())
    d_model = float((a_gpu - a_cpu).abs().max())
    log(f"[5] ContinuousConvModel N=2000 card vs CPU: max|da| {d_model:.3e}, max|a| {scale:.3e}")
    if not torch.allclose(a_gpu, a_cpu, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
        raise AssertionError("the ContConv model on the card disagrees with the CPU")
    torch.cuda.synchronize()
    return out


def phase6_large_n_path(exact_20k_ms: float):
    """The large-N surrogate path through the port's large_scale entry point at
    100k bodies, both surrogate families; then the 20k GNN rollout with
    Morton kNN beside phase 4's exact-kNN one."""
    import torch

    from nbody_tpu_torch.experiments import large_scale
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import autoregressive_rollout
    from nbody_tpu_torch.utils.timing import device_time

    base = ["--n-bodies", str(LARGE_N), "--steps", str(LARGE_STEPS), "--device", "cuda",
            "--modes", "direct", "surrogate", "hybrid"]
    runs = {"contconv": ["--model", "contconv", "--conv-impl", "kernel", "--knn-impl", "kernel"],
            "gnn-morton": ["--model", "gnn", "--knn-method", "morton", "--knn-impl", "kernel"]}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        res = large_scale.main(base + argv)
        wall = time.perf_counter() - t0
        if set(res) != {"direct", "surrogate", "hybrid"}:
            raise AssertionError(f"{name}: modes {sorted(res)}")
        for mode, r in res.items():
            vals = [r["seconds"], r["psteps_per_s"]]
            if mode == "surrogate":
                vals.append(r["final_pos_rmse_vs_direct"])
            if not all(math.isfinite(v) and v >= 0 for v in vals):
                raise AssertionError(f"{name} {mode}: non-finite result {r}")
            log(f"[6] {name} {mode} N={LARGE_N}: {1e3 * r['seconds'] / LARGE_STEPS:.4f} "
                f"ms/step" + (f", final pos RMSE vs direct {r['final_pos_rmse_vs_direct']:.3e}"
                              if mode == "surrogate" else ""))
        log(f"[6] {name}: {wall:.2f} s wall with warm-ups")

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(7), BIG_N, device=dev)
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=10, scale_factor=1e6, knn_method="morton",
                       knn_impl="kernel",
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    autoregressive_rollout(model, pos, vel, mass, 2, DT)
    (ps, _, _), sec = device_time(
        lambda: autoregressive_rollout(model, pos, vel, mass, SURR_STEPS, DT), dev)
    if not bool(torch.isfinite(ps).all()):
        raise AssertionError("bad 20k Morton surrogate rollout")
    log(f"[6] GNN surrogate rollout N={BIG_N}: Morton kNN (kernels) "
        f"{1e3 * sec / SURR_STEPS:.4f} ms/step; chunked exact kNN (phase 4) "
        f"{exact_20k_ms:.4f} ms/step")


def _bwd_against_plain(args, dout, d: int, label: str, time_it: bool) -> dict:
    """B4, B5 and B6 on one shape against the plain backward, each twice
    for the same bits; {"b4"|"b5"|"b6": (max abs err, ms, plain ms)}."""
    import torch

    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    want = cck.contconv_collect_bwd_torch(*args, dout, d=d)
    parts = {"b4": (cck.contconv_bwd_filters, (5,)), "b5": (cck.contconv_bwd_feat, (4,)),
             "b6": (cck.contconv_bwd_geom, (0, 1, 2, 3))}
    out = {}
    for key, (fn, slots) in parts.items():
        def call(fn=fn):
            got = fn(*args, dout, d=d)
            return got if isinstance(got, tuple) else (got,)

        got, again = call(), call()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = [float((g - want[s]).abs().max()) for g, s in zip(got, slots)]
        rel = max(e / max(float(want[s].abs().max()), 1e-30) for e, s in zip(errs, slots))
        ms = plain_ms = float("nan")
        if time_it:
            need = tuple(i in slots for i in range(6))
            ms = cuda_time_ms(call, reps=3, warmup=1)
            plain_ms = cuda_time_ms(
                lambda: cck.contconv_collect_bwd_torch(*args, dout, d=d, need=need),
                reps=2, warmup=1)
        log(f"[7] {key.upper()} {fn.__name__} {label}: max|d|/max|plain| {rel:.3e} "
            f"(bar {B3_TOL}), same bits twice {same}; kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms")
        if not (rel <= B3_TOL and same):
            raise AssertionError(f"{key} disagrees with its plain version ({label}): "
                                 f"{rel}, same bits {same}")
        out[key] = (max(errs), ms, plain_ms)
    return out


def phase7_backward_kernels():
    """B4-B6 against the plain backward; returns the kernels line's numbers
    (100k, D = 6)."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models.contconv import conv_geometry
    from nbody_tpu_torch.ops.radius import radius_neighbors

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    m, k, ci, co, d = 333, 7, 5, 3, 3  # a small odd shape, some edges clamped
    g3 = [(torch.rand(m, k, generator=gen) * (d + 0.4) - 0.3).to(dev) for _ in range(3)]
    win = (torch.rand(m, k, generator=gen) * (torch.rand(m, k, generator=gen) > 0.2)).to(dev)
    args = (*g3, win, torch.randn(m, k, ci, generator=gen).to(dev),
            torch.randn(d ** 3, ci, co, generator=gen).to(dev))
    _bwd_against_plain(args, torch.randn(m, co, generator=gen).to(dev), d,
                       f"M={m} k={k} ci={ci} co={co} D={d}", time_it=False)

    pos, _, _ = generate_spiral(torch.Generator().manual_seed(LARGE_N + 5), LARGE_N,
                                device=dev)
    idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
    geom = conv_geometry(pos[None], idx[None], valid[None], 1.0)
    fj = torch.randn(LARGE_N, 128, generator=gen).to(dev)[idx.long()].contiguous()
    win = geom["window"][0].contiguous()
    dout = torch.randn(LARGE_N, 128, generator=gen).to(dev)
    out = {}
    for d in (6, 4):
        grid = (geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)
        args = (*(grid[..., a].contiguous() for a in range(3)), win, fj,
                torch.randn(d ** 3, 128, 128, generator=gen).to(dev))
        res = _bwd_against_plain(args, dout, d, f"N={LARGE_N} k=32 ci=co=128 D={d}",
                                 time_it=True)
        if d == 6:
            # other operands: dout (M, co); B6 also writes four (M, k) cotangents
            other = {"b4": 4.0 * LARGE_N * 128, "b5": 4.0 * LARGE_N * 128,
                     "b6": 4.0 * LARGE_N * 128 + 16.0 * LARGE_N * 32}
            out = {key: (*nums, collect_bound(*args[:4], 128, 128, d, other[key]))
                   for key, nums in res.items()}
    del fj, geom
    torch.cuda.empty_cache()
    return out


def phase7_model_gradients() -> int:
    """The full-width model's parameter and position gradients, kernels
    against the dense layer on one graph. Returns B6's launches on the
    kernel run (the position-gradient path)."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import ContinuousConvModel
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.train.graphs import build_graph

    dev = torch.device("cuda")
    model = ContinuousConvModel(**FULL_CONTCONV,
                                generator=torch.Generator().manual_seed(5)).to(dev).train()
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(6), GRAD_N, device=dev)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, pos[None])
    cot = torch.randn(1, GRAD_N, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    wrappers = (cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom)

    def grads(impl):
        for conv in model.convs:
            conv.impl = impl
        model.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        (model(xg, idx, valid) * cot).sum().backward()
        torch.cuda.synchronize()
        return {n: p.grad for n, p in model.named_parameters()}, xg.grad[..., :3]

    want, want_pos = grads("dense")
    for w in wrappers:
        w.launches = 0
    got, got_pos = grads("kernel")
    launches = [w.launches for w in wrappers]
    log(f"[7] full-width model gradient N={GRAD_N} (kernel impl): launches B3 "
        f"{launches[0]}, B4 {launches[1]}, B5 {launches[2]}, B6 {launches[3]}")
    if launches != [2, 2, 2, 2]:
        raise AssertionError(f"the model's gradient did not go through B3-B6: {launches}")
    # A batch norm in train mode subtracts the batch mean, so the bias of
    # the Linear layer before it has a zero gradient up to rounding noise,
    # which differs between any two summation orders: left out.
    noise = {f"encoder.layers.{i}.bias" for i in range(len(model.encoder.norms))}
    worst = 0.0
    for name, ref in [*want.items(), ("positions", want_pos)]:
        if name in noise:
            continue
        g = got_pos if name == "positions" else got[name]
        scale = float(ref.abs().max())
        worst = max(worst, float((g - ref).abs().max()) / max(scale, 1e-30))
        if not torch.allclose(g, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
            raise AssertionError(f"gradient of {name}: kernels disagree with dense")
    log(f"[7] full-width model gradients, kernels vs dense, {len(want) - len(noise)} "
        f"parameters and the positions: worst max|d|/max|ref| {worst:.3e} (rtol "
        f"{MODEL_RTOL}, atol {MODEL_ATOL} x max|ref|)")
    return launches[3]


def _sets(*overrides):
    return [a for o in overrides for a in ("--set", o)]


def _epoch_numbers(trainer, data_dir, batch_size, steps, **kw):
    """ms per optimiser step of a warm epoch, and the idle share and top
    device rows (ms per step) of one more, profiled."""
    import torch

    from nbody_tpu_torch.utils.timing import device_time, profile_ms

    def epoch():
        return trainer.train_from_dir(data_dir, epochs=1, batch_size=batch_size,
                                      verbose=False, **kw)

    epoch()  # warm-up
    (losses, _), sec = device_time(epoch, trainer.device)
    busy_ms, top = profile_ms(epoch, trainer.device)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    torch.cuda.synchronize()
    return 1e3 * sec / steps, 1.0 - busy_ms / 1e3 / sec, [(n, t / steps) for n, t in top]


def phase8_training(tmp: str):
    """The training path through the port's entry points; asserts the
    kernels it must (and must not) launch."""
    import numpy as np
    import pandas as pd
    import torch

    from nbody_tpu_torch.config import ExperimentConfig
    from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset
    from nbody_tpu_torch.experiments import gnn_experiment, run
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.train import Trainer
    from nbody_tpu_torch.train.trainer import _list_dataset_files

    dev = torch.device("cuda")
    cfg_path = os.path.join(HERE, "configs", "contconv_adopted.json")
    wrappers = (cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom)

    # (a) the config runner at full width: 2 epochs, then a resumed third
    base = os.path.join(tmp, "run")
    argv = ["--config", cfg_path, "--device", "cuda"] + _sets(f"base={base}", *RUN_SETS)
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    first = run.main(argv + _sets("train.epochs=2"))
    wall = time.perf_counter() - t0
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    model = first["trainer"].model
    log(f"[8a] run --config contconv_adopted.json: {wall:.2f} s wall, epoch losses "
        f"{first['epoch_loss']}; launches B3 {counts[0]}, B4 {counts[1]}, B5 {counts[2]}, "
        f"B6 {counts[3]}")
    if not (all(c.impl is None for c in model.convs) and first["trainer"].epoch == 2
            and len(first["epoch_loss"]) == 2
            and all(math.isfinite(v) for v in first["epoch_loss"])):
        raise AssertionError("run did not train the config's model for 2 finite epochs")
    if min(counts[:3]) == 0 or counts[3] != 0:
        raise AssertionError(f"training launches B3-B6 {counts}: B3-B5 > 0, B6 = 0 expected")
    t0 = time.perf_counter()
    again = run.main(argv + _sets("train.epochs=1"))
    wall = time.perf_counter() - t0
    if again["trainer"].epoch != 3 or not math.isfinite(again["epoch_loss"][0]):
        raise AssertionError(f"resume: epoch {again['trainer'].epoch}, {again['epoch_loss']}")
    ckpts = sorted(os.listdir(os.path.join(base, "contconv_weights")))
    results = os.path.join(base, "results", "contconv")
    loss = pd.read_csv(os.path.join(results, "epoch_loss.csv"))
    step = pd.read_csv(os.path.join(results, "test_results_stepwise.csv"))
    roll = pd.read_csv(os.path.join(results, "test_results_rollout.csv"))
    if (ckpts != ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"] or list(loss.columns) != ["loss"]
            or list(step.columns) != ["filename", "scene", "loss", "step_time"]
            or list(roll.columns) != ["filename", "scene", "step", "pos_rmse", "vel_rmse",
                                      "acc_rmse"]
            or not np.isfinite(roll.drop(columns=["filename"]).to_numpy(float)).all()):
        raise AssertionError(f"resumed run: checkpoints {ckpts}, csv columns "
                             f"{list(loss.columns)}, {list(step.columns)}, {list(roll.columns)}")
    log(f"[8a] resumed run: epoch {again['trainer'].epoch}, loss {again['epoch_loss'][0]:.6g}, "
        f"{wall:.2f} s wall; evaluated from {ckpts[-1]}: stepwise loss "
        f"{step['loss'].mean():.6g}, final pos RMSE "
        f"{roll.groupby('scene')['pos_rmse'].last().mean():.6g}")

    train_dir = os.path.join(base, "data", "train")
    cfg = ExperimentConfig.load(cfg_path).apply_overrides(RUN_SETS)
    snaps = sum(again["trainer"]._dataset(f).n_snapshots for f in _list_dataset_files(train_dir))
    steps = -(-snaps // cfg.train.batch_size)
    trainer = Trainer(cfg.build_model(torch.Generator().manual_seed(0)).to(dev),
                      learning_rate=cfg.train.learning_rate, dt=cfg.train.dt)
    ms, idle, top = _epoch_numbers(trainer, train_dir, cfg.train.batch_size, steps,
                                   merge_files=True, batch_mode="mixed")
    log(f"[8a] recipe-shape train step (mixed batches of {cfg.train.batch_size} padded to "
        f"{max(cfg.datagen.n_bodies)} bodies, {steps} steps an epoch): {ms:.4f} ms/step, "
        f"idle share {idle:.4f}, top device rows {_rows(top)}")

    # (b) the GNN experiment
    t0 = time.perf_counter()
    gnn = gnn_experiment.main(["--quick", "--base", os.path.join(tmp, "gnn"), "--seed", "3",
                               "--device", "cuda", "--check"])
    if gnn["trainer"].epoch != 3 or not all(math.isfinite(v) for v in gnn["epoch_loss"]):
        raise AssertionError(f"gnn_experiment --quick: {gnn['epoch_loss']}")
    log(f"[8b] gnn_experiment --quick: {time.perf_counter() - t0:.2f} s wall, losses "
        f"{gnn['epoch_loss']}")

    # (c) the 100k training step on a strided port-datagen dataset
    def dataset(n):
        out = os.path.join(tmp, f"large_{n}")
        os.makedirs(out)
        generate_dataset([ScenarioConfig(n_bodies=n, sim_type="spiral", steps=TRAIN_STEPS,
                                         dt=DT, softening=EPS, g=G, seed=11,
                                         force_backend="kernel", calc_energy=False)],
                         os.path.join(out, f"spiral_{n}.csv"), write_csv_file=False,
                         snapshot_stride=TRAIN_STRIDE, device=dev, verbose=False)
        return out

    def step_numbers(impl, data_dir):
        cfg_n = cfg.apply_overrides(["model.kwargs.radius_method=morton",
                                     "model.kwargs.radius_impl=kernel",
                                     f"model.kwargs.conv_impl={impl}"])
        trainer = Trainer(cfg_n.build_model(torch.Generator().manual_seed(1)).to(dev),
                          learning_rate=cfg.train.learning_rate, dt=DT)
        snaps = trainer._dataset(_list_dataset_files(data_dir)[0]).n_snapshots
        return _epoch_numbers(trainer, data_dir, 1, snaps), snaps

    large = dataset(LARGE_N)
    before = [w.launches for w in wrappers]
    (ms_k, idle_k, top_k), snaps = step_numbers("kernel", large)
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    log(f"[8c] train step N={LARGE_N} kernels (Morton radius, batch 1, {snaps} snapshots): "
        f"{ms_k:.4f} ms/step, idle share {idle_k:.4f}, top device rows {_rows(top_k)}; "
        f"launches B3 {counts[0]}, B4 {counts[1]}, B5 {counts[2]}, B6 {counts[3]}")
    if min(counts[:3]) == 0 or counts[3] != 0:
        raise AssertionError(f"100k training launches B3-B6 {counts}")
    torch.cuda.empty_cache()
    try:
        (ms_d, idle_d, top_d), _ = step_numbers("dense", large)
        n_dense = LARGE_N
    except torch.cuda.OutOfMemoryError:
        log(f"[8c] the dense layer's training step at N={LARGE_N} does not fit in memory")
        torch.cuda.empty_cache()
        n_dense = BIG_N
        (ms_d, idle_d, top_d), _ = step_numbers("dense", dataset(BIG_N))
    log(f"[8c] train step N={n_dense} dense layer: {ms_d:.4f} ms/step, idle share "
        f"{idle_d:.4f}, top device rows {_rows(top_d)}; kernels at N={LARGE_N}: "
        f"{ms_k:.4f} ms/step")


def _rows(top):
    return "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top)


def _against_plain(label, kernel, plain, tol, bound_):
    """A kernel call against its plain version on the same inputs, twice for
    the same bits; returns (max abs err, kernel ms, plain ms, bound)."""
    import torch

    from nbody_tpu_torch.utils.timing import cuda_time_ms

    got, again = kernel(), kernel()
    same = torch.equal(got, again)
    want = plain()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    ms = cuda_time_ms(kernel, reps=10, warmup=1)
    plain_ms = cuda_time_ms(plain, reps=2, warmup=1)
    log(f"[9a] {label}: max|d|/max|plain| {rel:.3e} (bar {tol}), same bits twice {same}; "
        f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_[0]:.4f} ms "
        f"({bound_[1]})")
    if not (rel <= tol and same and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version "
                             f"({rel}, same bits {same})")
    return err, ms, plain_ms, bound_


def _tree_shapes(n, seed, build, knobs):
    """A spiral of n bodies on the card and its partition, with the build's
    time logged."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral

    pos, _, mass = generate_spiral(torch.Generator().manual_seed(seed), n,
                                   device=torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = build(pos, mass, **knobs)
    torch.cuda.synchronize()
    log(f"[9a] N={n} {build.__name__}({knobs}): {time.perf_counter() - t0:.4f} s "
        f"(first call), near {tuple(part.near.shape)}")
    return pos, mass, part


def _table(tf, spos, sm, rows):
    nb = spos.shape[0] // rows
    bp, _, msum, com, quad = tf._block_moments(spos, sm, nb, rows)
    return bp.contiguous(), tf._blk_rows(com, msum, quad)


def phase9_kernels():
    """B9, B10 and B1's near-list form against their plain versions on the
    shapes of the 100k bh and 1M bh3 recipes; returns the kernels line's
    numbers (the 1M bh3 shapes)."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf

    eps2 = EPS ** 2
    pos, mass, part = _tree_shapes(TREE_N, TREE_N + 9, tf.build_bh_partition, BH_100K)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b = BH_100K["block"]
    q_blocks, table = _table(tf, spos, sm, b)
    (nb, m), p, k = part.near.shape, spos.shape[0], table.shape[0]
    _against_plain(f"B9 far field N={TREE_N}: {p} receivers x {k} blocks",
                   lambda: tf.multipole_acc(spos, table, G, eps2),
                   lambda: tf.multipole_acc_torch(spos, table, G, eps2), MULT_TOL,
                   bound(45.0 * p * k, 24.0 * p + 40.0 * k))
    _against_plain(f"B10 near subtraction N={TREE_N}: {nb} groups x {b} x {m} blocks",
                   lambda: tf.grouped_multipole_acc(q_blocks, table, part.near, G, eps2),
                   lambda: tf.grouped_multipole_acc_torch(q_blocks, table, part.near, G, eps2),
                   MULT_TOL, bound(45.0 * p * m, 24.0 * p + 40.0 * k + 4.0 * nb * m))
    _against_plain(f"B1 near list N={TREE_N}: {nb} groups x {b} x {m} blocks of {b}",
                   lambda: pw.near_accelerations(q_blocks, spos, sm, part.near, b, G, EPS),
                   lambda: pw.near_accelerations_torch(q_blocks, spos, sm, part.near, b, G,
                                                       EPS),
                   B1_TOL, bound(20.0 * p * m * b, 24.0 * p + 16.0 * p + 4.0 * nb * m))
    del pos, mass, part, spos, sm, q_blocks, table

    pos, mass, part = _tree_shapes(TREE_1M, TREE_1M + 9, tf.build_bh3_partition, BH3_1M)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b, c, bs = BH3_1M["block"], BH3_1M["coarse"], BH3_1M["sub_block"]
    q_blocks, table_f = _table(tf, spos, sm, b)
    _, table_c = _table(tf, spos, sm, b * c)
    _, table_s = _table(tf, spos, sm, bs)
    p, nbc, rc = spos.shape[0], *part.refined.shape
    nb, kk = part.sub_near.shape
    u = part.sub_far.shape[1]
    fine_ids = (part.refined[:, :, None] * c + torch.arange(
        c, dtype=torch.int32, device=spos.device)).reshape(nbc, rc * c).contiguous()
    qg = spos.reshape(nbc, c * b, 3)
    out = {}
    out["b9"] = _against_plain(
        f"B9 far field N={TREE_1M}: {p} receivers x {nbc} superblocks",
        lambda: tf.multipole_acc(spos, table_c, G, eps2),
        lambda: tf.multipole_acc_torch(spos, table_c, G, eps2), MULT_TOL,
        bound(45.0 * p * nbc, 24.0 * p + 40.0 * nbc))
    out["b10"] = _against_plain(
        f"B10 refinement N={TREE_1M}: {nbc} groups x {c * b} x {rc * c} fine blocks",
        lambda: tf.grouped_multipole_acc(qg, table_f, fine_ids, G, eps2),
        lambda: tf.grouped_multipole_acc_torch(qg, table_f, fine_ids, G, eps2), MULT_TOL,
        bound(45.0 * p * rc * c, 24.0 * p + 40.0 * nb + 4.0 * fine_ids.numel()))
    _against_plain(
        f"B10 coarse subtraction N={TREE_1M}: {nbc} groups x {c * b} x {rc} superblocks",
        lambda: tf.grouped_multipole_acc(qg, table_c, part.refined, G, eps2),
        lambda: tf.grouped_multipole_acc_torch(qg, table_c, part.refined, G, eps2), MULT_TOL,
        bound(45.0 * p * rc, 24.0 * p + 40.0 * nbc + 4.0 * part.refined.numel()))
    _against_plain(
        f"B10 sub-block multipoles N={TREE_1M}: {nb} groups x {b} x {u} sub-blocks",
        lambda: tf.grouped_multipole_acc(q_blocks, table_s, part.sub_far, G, eps2),
        lambda: tf.grouped_multipole_acc_torch(q_blocks, table_s, part.sub_far, G, eps2),
        MULT_TOL, bound(45.0 * p * u, 24.0 * p + 40.0 * table_s.shape[0] + 4.0 * nb * u))
    out["b1n"] = _against_plain(
        f"B1 near list N={TREE_1M}: {nb} groups x {b} x {kk} sub-blocks of {bs}",
        lambda: pw.near_accelerations(q_blocks, spos, sm, part.sub_near, bs, G, EPS),
        lambda: pw.near_accelerations_torch(q_blocks, spos, sm, part.sub_near, bs, G, EPS),
        B1_TOL, bound(20.0 * p * kk * bs, 24.0 * p + 16.0 * p + 4.0 * nb * kk))
    del pos, mass, part, spos, sm, q_blocks, qg, fine_ids
    torch.cuda.empty_cache()
    return out


def phase9_engines():
    """Each engine's kernel path against its dense path on one partition at
    100k bodies, elementwise at the JAX tests' bar between their two near
    paths. At 100k a few elements in 10^5 miss that bar through float32
    cancellation at the near/far seam, shared by the two paths: the float32
    dense path misses it as often against its own float64 run, which is
    printed beside. So the check is: at most ``SEAM_SHARE`` of the elements
    over the bar, and the kernel path's median force error against the
    exact sum (B1) no larger than the dense path's."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    pos, _, mass = generate_spiral(torch.Generator().manual_seed(TREE_N + 11), TREE_N,
                                   device=torch.device("cuda"))
    exact = pw.accelerations(pos, mass, G, EPS)
    two = dict(n_near=32, block=128, coarse=16, rc=32)
    runs = {"bh": (tf.build_bh_partition, tf.bh_accelerations, BH_100K),
            "bh2": (tf.build_bh2_partition, tf.bh2_accelerations, two),
            "bh3": (tf.build_bh3_partition, tf.bh3_accelerations,
                    dict(two, sub_block=32, n_sub=48))}
    for name, (build, engine, knobs) in runs.items():
        part = build(pos, mass, **knobs)

        def run(impl, p_=pos, m_=mass):
            return engine(p_, m_, G, EPS, partition=part, near_impl=impl)

        got, dense = run("kernel"), run("dense")
        f64 = run("dense", pos.double(), mass.double())

        def over(a, b):
            e = (a.double() - b.double()).abs() - (NEAR_ATOL[name] + 2e-3 * b.double().abs())
            return int((e > 0).sum()), float(e.max())

        def median_err(a):
            return float(((a - exact).norm(dim=-1) / (exact.norm(dim=-1) + 1e-30)).median())

        n_over, worst = over(got, dense)
        meds = [median_err(got), median_err(dense)]
        ms = cuda_time_ms(lambda: run("kernel"), reps=5, warmup=1)
        ms_d = cuda_time_ms(lambda: run("dense"), reps=2, warmup=1)
        log(f"[9b] {name} {knobs} N={TREE_N}: elements over rtol 2e-3 + atol "
            f"{NEAR_ATOL[name]}: kernel vs dense {n_over} of {got.numel()} (worst excess "
            f"{worst:.3e}), float32 dense vs float64 dense {over(dense, f64)[0]}, kernel vs "
            f"float64 dense {over(got, f64)[0]}; median rel error vs exact: kernel "
            f"{meds[0]:.4e}, dense {meds[1]:.4e}; force evaluation (reused partition) "
            f"kernel {ms:.4f} ms, dense {ms_d:.4f} ms")
        if not (n_over <= SEAM_SHARE * got.numel() and meds[0] <= meds[1]):
            raise AssertionError(f"{name}: the kernel path disagrees with the dense path")
    torch.cuda.synchronize()


def phase9_rollouts():
    """The treecode path through ``bh_rollout.main``: bh at 100k with the
    exact energy audit, bh3 at 1M with the sampled force audit."""
    from nbody_tpu_torch.experiments import bh_rollout

    bh = bh_rollout.main(["--engine", "bh", "--n-bodies", str(TREE_N), "--steps", "200",
                          "--bh-refresh", "8", "--device", "cuda", "--profile"])
    log(f"[9c] bh_rollout bh N={TREE_N} x 200 steps (refresh 8): "
        f"{bh['ms_per_step']:.4f} ms/step, {bh['wall_s']:.4f} s wall, energy drift "
        f"{bh['rel_energy_drift']:.3e} (bar {BH_DRIFT})")
    if not bh["rel_energy_drift"] < BH_DRIFT:
        raise AssertionError(f"100k bh energy drift {bh['rel_energy_drift']}")
    log(f"[9c] bh N={TREE_N}: {_profile_line(bh)}")
    bh3 = bh_rollout.main(["--engine", "bh3", "--n-bodies", str(TREE_1M), "--block", "128",
                           "--rc", "48", "--n-sub", "48", "--steps", "16", "--chunk-steps",
                           "8", "--no-energy-audit", "--device", "cuda", "--profile"])
    log(f"[9c] bh_rollout bh3 N={TREE_1M} x 16 steps (chunks of 8, refresh 8): "
        f"{bh3['ms_per_step']:.4f} ms/step, {bh3['wall_s']:.4f} s wall; sampled force error "
        f"over {bh3['error_sample']} receivers: median {bh3['end_rel_err_median']:.4e} "
        f"(bar {BH3_MEDIAN}), p99 {bh3['end_rel_err_p99']:.4e}")
    if not bh3["end_rel_err_median"] < BH3_MEDIAN:
        raise AssertionError(f"1M bh3 median force error {bh3['end_rel_err_median']}")
    log(f"[9c] bh3 N={TREE_1M}: {_profile_line(bh3)}")


def _profile_line(row) -> str:
    steps = row["profile_steps"]
    return (f"one more {steps}-step segment {1e3 * row['profile_wall_s'] / steps:.4f} ms/step "
            f"wall, {1e3 * row['busy_seconds'] / steps:.4f} ms/step device, idle share "
            f"{row['idle_share']:.4f}, top device rows (ms/step) "
            f"{_rows([(n, t / steps) for n, t in row['top_ms']])}")


def phase9_bench():
    from nbody_tpu_torch.experiments import treeforce_bench

    for engine, extra in (("bh", []), ("bh2", ["--block", "128"]), ("bh3", ["--block", "128"])):
        (row,) = treeforce_bench.main(["--n-bodies", str(TREE_N), "--engine", engine,
                                       "--reps", "5", "--device", "cuda", *extra])
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"treeforce_bench {engine}: {row}")
        log(f"[9d] treeforce_bench {engine} N={TREE_N}: exact {row['exact_ms']:.4f} ms, "
            f"fresh {row['bh_fresh_ms']:.4f}, reused {row['bh_reused_ms']:.4f}, partition "
            f"{row['partition_ms']:.4f}; rel err median {row['rel_err_median']:.4e}, p99 "
            f"{row['rel_err_p99']:.4e}")

def _b11_case(label, u, vpad, idx, mask, dtype, tile, half, time_it):
    """B11 against its plain version on one input, twice for the same bits;
    returns (max abs err, ms, plain ms, bound)."""
    import torch

    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    kw = dict(tile=tile, half=half, gather_dtype=dtype)
    got, again = (ek.windowed_tanh_sum(u, vpad, idx, mask, **kw) for _ in range(2))
    torch.cuda.synchronize()
    want = ek.windowed_tanh_sum_torch(u, vpad, idx, mask, **kw)
    same = torch.equal(got, again)
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= B11_TOL + B11_TOL * want.abs()).all())
    n, d = u.shape
    edges = float((mask & ek._window_rows(idx, tile, half)).sum())
    # per executed edge and channel an add and a tanhf; u, vpad, idx, mask
    # read once, out written once
    bnd = bound((1.0 + TANH_FLOPS) * edges * d,
                4.0 * (2 * n * d + vpad.numel() + idx.numel()) + mask.numel())
    ms = plain_ms = float("nan")
    if time_it:
        ms = cuda_time_ms(lambda: ek.windowed_tanh_sum(u, vpad, idx, mask, **kw), reps=10,
                          warmup=1)
        plain_ms = cuda_time_ms(lambda: ek.windowed_tanh_sum_torch(u, vpad, idx, mask, **kw),
                                reps=3, warmup=1)
    log(f"[10a] B11 windowed_tanh_sum {label}: max|d| {err:.3e}, within rtol = atol = "
        f"{B11_TOL} {ok}, same bits twice {same}; {edges:.0f} edges in the window; kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
    if not (ok and same and bool(torch.isfinite(got).all())):
        raise AssertionError(f"B11 disagrees with its plain version ({label})")
    return err, ms, plain_ms, bnd


def phase10_kernel():
    """B11 against its plain version; returns the kernels line's numbers
    (1M rows, k = 8, d = 64, float32 gather)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)

    def case(n, k, d, spread, tile, half):
        u = torch.randn(n, d, generator=gen).to(dev)
        vpad = torch.nn.functional.pad(torch.randn(n, d, generator=gen), (0, 0, half, half))
        off = torch.randint(-spread, spread + 1, (n, k), generator=gen)
        idx = (torch.arange(n)[:, None] + off).clamp(0, n - 1).to(torch.int32)
        mask = torch.rand(n, k, generator=gen) < 0.9
        return u, vpad.to(dev), idx.to(dev), mask.to(dev)

    small = case(3 * 37, 3, 12, 30, 37, 5)  # odd tile, half and width; edges past the window
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        _b11_case(f"N=111 k=3 d=12 tile=37 half=5 {dtype}", *small, dtype, 37, 5, False)
    n = -(-TREE_1M // WINDOW["tile"]) * WINDOW["tile"]  # 1M rows padded to whole tiles
    big = case(n, 8, 64, 500, **WINDOW)
    for dtype in (torch.float32, torch.bfloat16):
        nums = _b11_case(f"N={n} k=8 d=64 tile=256 half=384 {dtype}", *big, dtype,
                         WINDOW["tile"], WINDOW["half"], True)
        out = out or nums
    del big
    torch.cuda.empty_cache()
    return out


def _hold_1m_kernels(pos, mass, idx, valid):
    """B7, B8 and B1 against their plain versions at the shapes the 1M entry
    points give them: the select and the merge behind the k = 8 graph of
    ``pos`` (which must be the graph ``idx``, ``valid`` that the path built),
    its recall against the exact search on ``SAMPLE_1M`` receivers, and the
    direct sum of those receivers over all sources."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    n, k = idx.shape
    block = 256  # build_graph's default
    order = sp._curve_order(pos, None, 4)
    cand, qg = sp._candidates(pos, order, block)
    ids, d2 = sp.morton_select(cand, k, block, False)
    ids_t, d2_t = sp.morton_select_torch(cand, k, block, False)
    ok7 = torch.equal(ids, ids_t) and torch.allclose(d2, d2_t, rtol=1e-6, atol=0)
    ms7 = cuda_time_ms(lambda: sp.morton_select(cand, k, block, False), reps=5, warmup=1)
    ms7t = cuda_time_ms(lambda: sp.morton_select_torch(cand, k, block, False), reps=1,
                        warmup=0)
    mc, md = sp._to_rows(qg, ids, d2, n)
    m_ids, m_d2 = sp.morton_merge(mc, md, k)
    t_ids, t_d2 = sp.morton_merge_torch(mc, md, k)
    ok8 = torch.equal(m_ids, t_ids) and torch.allclose(m_d2, t_d2, rtol=1e-6, atol=0)
    ms8 = cuda_time_ms(lambda: sp.morton_merge(mc, md, k), reps=5, warmup=1)
    ms8t = cuda_time_ms(lambda: sp.morton_merge_torch(mc, md, k), reps=1, warmup=0)
    # the path's graph is what these two launches give
    found = m_d2 < sp._BAD_D2
    same = torch.equal(valid, found) and torch.equal(
        idx, torch.where(found, m_ids, 0).clamp(0, n - 1).to(torch.int32))
    log(f"[10b] B7 select N={n} k={k}: ids identical {ok7}, max|dd2| "
        f"{float((d2 - d2_t).abs().max()):.3e}; kernel {ms7:.4f} ms  plain {ms7t:.4f} ms")
    log(f"[10b] B8 merge  N={n} k={k}: ids identical {ok8}, max|dd2| "
        f"{float((m_d2 - t_d2).abs().max()):.3e}; kernel {ms8:.4f} ms  plain {ms8t:.4f} ms; "
        f"the path's graph equals these launches' {same}")
    del cand, ids, d2, ids_t, d2_t, mc, md, t_ids, t_d2

    rows = torch.randperm(n, generator=torch.Generator().manual_seed(42))[:SAMPLE_1M]
    rows = rows.to(pos.device)
    hits = 0
    for r in rows.split(128):  # exact differences, (128, N) at a time
        qr = pos[r]
        dd = sum((pos[None, :, a] - qr[:, a, None]) ** 2 for a in range(3))
        dd[torch.arange(r.shape[0], device=r.device), r] = float("inf")
        exact = torch.topk(dd, k, dim=1, largest=False).indices
        got = torch.where(valid[r], idx[r].long(), -1)
        hits += int((got[:, :, None] == exact[:, None, :]).any(1).sum())
    recall = hits / (rows.shape[0] * k)

    q = pos[rows].contiguous()

    def plain(dtype):  # the plain version, 128 receivers at a time
        p, m = pos.to(dtype), mass.to(dtype)
        return torch.cat([pw.partial_accelerations_torch(p[r], p, m, G, EPS)
                          for r in rows.split(128)])

    # B1_TOL is the bar at BIG_N sources; a lane's float32 sum runs over its
    # sources in order, so its rounding grows as the root of their number
    bar1 = B1_TOL * math.sqrt(n / BIG_N)
    acc = pw.partial_accelerations(q, pos, mass, G, EPS)
    acc_t, acc_d = plain(torch.float32), plain(torch.float64)
    top = float(acc_d.abs().max())
    rel1, rel1_d, relt_d = (float((a - b).abs().max()) / top for a, b in
                            ((acc, acc_t), (acc, acc_d), (acc_t, acc_d)))
    ms1 = cuda_time_ms(lambda: pw.partial_accelerations(q, pos, mass, G, EPS), reps=5,
                       warmup=1)
    log(f"[10b] knn_morton(kernel) N={n} k={k}: recall vs exact on {rows.shape[0]} receivers "
        f"{recall:.5f} (bar {RECALL})")
    log(f"[10b] B1 force {q.shape[0]} x {n}: max|da|/max|a| against the plain version "
        f"{rel1:.3e}, against its float64 run {rel1_d:.3e} (bar {bar1:.3e} each; the plain "
        f"version against float64 {relt_d:.3e}); kernel {ms1:.4f} ms")
    if not (ok7 and ok8 and same and recall >= RECALL and max(rel1, rel1_d) <= bar1):
        raise AssertionError(f"a kernel of the 1M path disagrees with its plain version at "
                             f"N={n}: B7 {ok7}, B8 {ok8}, graph {same}, recall {recall}, "
                             f"B1 {rel1}")


def phase10_path_data() -> int:
    """``edge_message_sum`` on the crossover path's own data at 1M bodies;
    returns B11's launches."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.models.common import select_input_features
    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.ops.spatial import morton_keys
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    n = TREE_1M
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), n, device=dev)
    order = torch.sort(morton_keys(pos), stable=True).indices
    pos, vel, mass = pos[order], vel[order], mass[order]
    model = GraphModel(**GNN_1M, fused_edgeconv=True)
    model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
    model.to(dev).eval()
    with torch.no_grad():
        idx, valid = build_graph(model.graph_spec, pos[None])
        h = select_input_features(torch.cat([pos, vel, mass[:, None]], -1)[None], 4)
        u, v = (t[0].contiguous() for t in model.convs[0].split_terms(h))
    idx, valid = idx[0].contiguous(), valid[0].contiguous()
    _hold_1m_kernels(pos, mass, idx, valid)

    def gather_sum():  # the fused layer's own k-sized step
        t = torch.tanh(u[:, None, :] + v[idx.long()])
        return torch.where(valid[:, :, None], t, 0.0).sum(dim=1)

    want = gather_sum()
    plan = ek.plan_windowed_gather(idx, valid, **WINDOW)
    torch.cuda.synchronize()
    share = float(plan.in_mask.sum()) / float(valid.sum())
    overflow, fallback = int(plan.overflow), int(plan.fb_valid.sum())
    ek.windowed_tanh_sum.launches = 0
    got = ek.edge_message_sum(u, v, idx, plan, **WINDOW)
    again = ek.edge_message_sum(u, v, idx, plan, **WINDOW)
    torch.cuda.synchronize()
    launches = ek.windowed_tanh_sum.launches
    rel = float((got - want).abs().max()) / float(want.abs().max())
    same = torch.equal(got, again)
    # B11 alone: the rows padded to the plan's whole tiles, as edge_message_sum pads them
    half, extra = WINDOW["half"], plan.in_mask.shape[0] - n
    up, idxp = (torch.nn.functional.pad(t, (0, 0, 0, extra)) for t in (u, idx))
    vpad = torch.nn.functional.pad(v, (0, 0, half, half + extra))
    ms_plan = cuda_time_ms(lambda: ek.plan_windowed_gather(idx, valid, **WINDOW), reps=3,
                           warmup=1)
    ms_gather = cuda_time_ms(gather_sum, reps=5, warmup=1)
    ms_b11 = cuda_time_ms(lambda: ek.windowed_tanh_sum(up, vpad, idxp, plan.in_mask, **WINDOW),
                          reps=10, warmup=1)
    ms_all = cuda_time_ms(lambda: ek.edge_message_sum(u, v, idx, plan, **WINDOW), reps=5,
                          warmup=1)
    log(f"[10b] EdgeConv_0 of the 1M model on Morton-sorted spiral bodies, N={n} k=8 d=64: "
        f"in-window share {share:.4f} of {int(valid.sum())} valid edges, fallback list "
        f"{fallback} of {plan.fb_valid.numel()} slots, overflow {overflow}; "
        f"edge_message_sum vs the layer's masked tanh sum max|d|/max {rel:.3e} (bar 1e-5), "
        f"same bits twice {same}; B11 launches {launches}")
    log(f"[10b] ms per message sum: torch gather + tanh + sum {ms_gather:.4f}, B11 alone "
        f"{ms_b11:.4f}, B11 + fallback {ms_all:.4f}; the plan (once per graph build) "
        f"{ms_plan:.4f}")
    if not (overflow == 0 and fallback > 0 and rel <= 1e-5 and same and launches == 2):
        raise AssertionError("edge_message_sum disagrees with the fused layer's sum, "
                             "dropped edges, or never launched B11")
    torch.cuda.empty_cache()
    return launches


def phase10_fused_forward():
    """Fused against unfused ``GraphModel`` forward at 100k, same graph."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), LARGE_N, device=dev)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    outs, peaks, times = [], [], []
    idx = valid = None
    for fused in (False, True):
        model = GraphModel(**GNN_1M, fused_edgeconv=fused)
        model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
        model.to(dev).eval()
        with torch.no_grad():
            if idx is None:
                idx, valid = build_graph(model.graph_spec, pos[None])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs.append(model(x, idx, valid))
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 20)
            times.append(cuda_time_ms(lambda: model(x, idx, valid), reps=10, warmup=1))
    ref = outs[0]
    scale = float(ref.abs().max())
    d_max = float((outs[1] - ref).abs().max())
    log(f"[10c] GraphModel forward N={LARGE_N} k=8, fused vs unfused on one graph: max|da| "
        f"{d_max:.3e}, max|a| {scale:.3e}; unfused {times[0]:.4f} ms, peak {peaks[0]:.1f} MiB "
        f"above the inputs; fused {times[1]:.4f} ms, peak {peaks[1]:.1f} MiB")
    if not torch.allclose(outs[1], ref, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
        raise AssertionError("the fused EdgeConv forward disagrees with the unfused one")


def phase10_crossover(tmp: str) -> dict:
    """``crossover`` through its ``main``; returns the launches of those two
    calls alone (the profiled rollout after them builds its own model)."""
    from nbody_tpu_torch.experiments import crossover

    common = ["--neighbors", "8", "--graph-refresh", "1", "8", "--steps", "10",
              "--load-params", PARAMS_1M, "--device", "cuda"]
    out = os.path.join(tmp, "crossover.json")
    zero_counts()
    rows = crossover.main(["--n-bodies", str(LARGE_N), "--bh", "--bh2", "--bh3", "--out", out,
                           *common])
    rows += crossover.main(["--n-bodies", str(TREE_1M), "--only", "direct", "bh3", "surrogate",
                            "--n-sub", str(BH3_1M["n_sub"]), "--out", out, *common])
    ran = entry_point_counts("crossover at 100k and 1M", ("b1", "b7", "b8", "b9", "b10", "b1n"))
    with open(out) as f:
        art = json.load(f)
    if (len(rows) != 6 + 4 or len(art["rows"]) != len(rows) or art["device"] != "gpu"
            or art["steps"] != 10):
        raise AssertionError(f"crossover: {len(rows)} rows, artifact {art}")
    for r in rows:
        if not (set(r) >= {"n", "mode", "ms_per_step", "psteps_per_s"}
                and math.isfinite(r["ms_per_step"]) and r["psteps_per_s"] > 0
                and (("params" in r) == r["mode"].startswith("surrogate"))):
            raise AssertionError(f"crossover row {r}")
        log(f"[10d] crossover N={r['n']} {r['mode']}: {r['ms_per_step']:.4f} ms/step")
    _profile_1m_rollout()
    return ran


def _profile_1m_rollout(steps: int = 10, refresh: int = 8):
    """Wall and device time of one more 1M surrogate rollout as crossover
    runs it (trained weights, fused EdgeConv, Morton kernels)."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import autoregressive_rollout
    from nbody_tpu_torch.utils.timing import device_time, profile_ms

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), TREE_1M, device=dev)
    model = GraphModel(**GNN_1M, fused_edgeconv=True)
    model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
    model.to(dev).eval()

    def run():
        autoregressive_rollout(model, pos, vel, mass, steps + 1, DT, graph_refresh=refresh)

    run()
    _, wall = device_time(run, dev)
    busy_ms, top = profile_ms(run, dev)
    log(f"[10d] 1M surrogate rollout (refresh {refresh}), one more {steps}-step run: "
        f"{1e3 * wall / steps:.4f} ms/step wall, {busy_ms / steps:.4f} ms/step device, idle "
        f"share {1.0 - busy_ms / 1e3 / wall:.4f}, top device rows (ms/step) "
        f"{_rows([(n, t / steps) for n, t in top])}")


def _train_large(argv, label, steps_per_epoch, need):
    """One ``train_large.main`` call with the launch counts at 0 before it;
    logs ms per optimiser step of its last epoch and the call's peak memory,
    returns the result and the call's launches (``need`` above 0)."""
    import torch

    from nbody_tpu_torch.experiments import train_large

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = train_large.main([*argv, "--device", "cuda"])
    wall = time.perf_counter() - t0
    ran = entry_point_counts(f"train_large {label}", need)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"stepwise_scaled_rmse", "predict_zero_baseline_scaled_rmse", "rollout_horizon",
            "rollout_seconds", "rollout_pos_rmse", "final_acc_median_rel_err_vs_exact",
            "final_acc_rmse_vs_exact", "final_acc_rel_rmse_vs_exact"}
    ev = res["eval"]
    if not (set(res) >= {"n_bodies", "model", "device", "dataset", "training", "eval"}
            and set(ev) >= want and res["device"] == "gpu" and ev["rollout_pos_rmse"]
            and all(math.isfinite(ev[k]) for k in want - {"rollout_pos_rmse"})
            and all(math.isfinite(r["pos_rmse"]) for r in ev["rollout_pos_rmse"])):
        raise AssertionError(f"train_large {label}: result {res}")
    per_epoch = res["training"]["seconds_per_epoch"]
    step_ms = 1e3 * per_epoch[-1] / steps_per_epoch if per_epoch else float("nan")
    log(f"[10e] train_large {label}: {wall:.2f} s wall, datagen "
        f"{res['dataset']['datagen_seconds']} s, last epoch {step_ms:.4f} ms per optimiser "
        f"step, losses first {res['training']['first_scaled_rmse']} final "
        f"{res['training']['final_scaled_rmse']}; stepwise {ev['stepwise_scaled_rmse']:.6g} "
        f"(zero baseline {ev['predict_zero_baseline_scaled_rmse']:.6g}), final acc rel RMSE "
        f"vs exact {ev['final_acc_rel_rmse_vs_exact']:.4g}; peak memory {peak:.3f} GiB")
    return res, ran


def _large_step_numbers(argv, data_dir, label, steps):
    """A warm and a profiled epoch of ``train_large``'s own model and trainer on
    its dataset: ms per optimiser step, idle share, top rows and
    the peak memory of those epochs."""
    import torch

    from nbody_tpu_torch.experiments import train_large
    from nbody_tpu_torch.train import PlateauScheduler, Trainer

    dev = torch.device("cuda")
    args = train_large.build_parser().parse_args(argv)
    trainer = Trainer(train_large.build_model(args, dev).to(dev), learning_rate=args.lr, dt=DT,
                      scheduler=PlateauScheduler(lr=args.lr, factor=0.25, patience=5))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms, idle, top = _epoch_numbers(trainer, data_dir, args.batch_size, steps,
                                   batch_mode="bucketed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[10e] train step {label}: {ms:.4f} ms per optimiser step, idle share {idle:.4f}, "
        f"peak memory {peak:.3f} GiB, top device rows {_rows(top)}")
    del trainer
    torch.cuda.empty_cache()


def phase10_train_large(tmp: str) -> dict:
    """``train_large`` through its ``main``: the 1M GNN with remat, resume
    and an eval-only rerun; the 100k ContConv chunked and unchunked. Returns
    the launches of those ``main`` calls alone (the step profiles between
    them build their own trainer)."""
    import pandas as pd

    graph = ("b1", "b7", "b8")  # the exact-force check and every Morton graph build
    datagen = ("b9", "b1n")     # the bh ground truth
    total = dict.fromkeys(kernel_wrappers(), 0)

    def run(argv, label, need):
        res, ran = _train_large(argv, label, snaps, need)
        for name, c in ran.items():
            total[name] += c
        return res, ran

    data = os.path.join(tmp, "data")
    out = os.path.join(tmp, "train_1m.json")
    snaps = 2  # steps 0 and 4 of an 8-step scene
    gnn = ["--n-bodies", str(TREE_1M), "--neighbors", "8", "--remat", "--batch-size", "1",
           "--graph-refresh", "8", "--train-scenes", "1", "--steps", "8", "--stride", "4",
           "--save-every", "1", "--data-dir", data, "--out", out]
    first, _ = run([*gnn, "--epochs", "2"], "GNN N=1M k=8 remat, 2 epochs", graph + datagen)
    again, _ = run([*gnn, "--epochs", "1", "--skip-datagen"], "GNN N=1M resumed, 1 more epoch",
                   graph)
    loss = pd.read_csv(out[:-5] + "_epoch_loss.csv")
    ckpts = sorted(os.listdir(out[:-5] + "_ckpt"))
    if (list(loss["epoch"]) != [1, 2, 3] or ckpts != ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
            or not all(math.isfinite(v) for v in loss["loss"])
            or len(first["training"]["seconds_per_epoch"]) != 2
            or len(again["training"]["seconds_per_epoch"]) != 1):
        raise AssertionError(f"1M resume: epochs {list(loss['epoch'])}, checkpoints {ckpts}")
    ev, _ = run([*gnn, "--skip-datagen", "--load-params", out[:-5] + "_params.pt"],
                "GNN N=1M eval only from the saved weights", graph)
    if (ev["eval"].get("params_loaded_from") != out[:-5] + "_params.pt"
            or ev["training"] != again["training"]
            or not math.isclose(ev["eval"]["stepwise_scaled_rmse"],
                                again["eval"]["stepwise_scaled_rmse"], rel_tol=1e-6)):
        raise AssertionError("the eval-only rerun does not repeat the resumed run's eval")
    _large_step_numbers(gnn, os.path.join(data + "1000k", "train"),
                        "GNN N=1M k=8 fused, remat, batch 1", snaps)

    conv = ["--model", "contconv", "--n-bodies", str(LARGE_N), "--batch-size", "1",
            "--train-scenes", "1", "--steps", "8", "--stride", "4", "--epochs", "2",
            "--data-dir", data]
    layers, epochs = 2, 2
    for chunks, extra, need in ((CHUNKS, [], datagen), (1, ["--skip-datagen"], ())):
        res, ran = run([*conv, *extra, "--conv-node-chunks", str(chunks), "--out",
                        os.path.join(tmp, f"train_100k_c{chunks}.json")],
                       f"ContConv N=100k, {chunks} node chunk(s)",
                       graph + ("b3", "b4", "b5") + need)
        counts = [ran[name] for name in ("b3", "b4", "b5", "b6")]
        train = chunks * layers * snaps * epochs
        # each chunk's forward runs again in the backward when it is
        # checkpointed; the eval's forwards: 2 stepwise, horizon + 1 rollout
        fwd = (2 if chunks > 1 else 1) * train + \
            (snaps + res["eval"]["rollout_horizon"] + 1) * layers * chunks
        log(f"[10e] ContConv N=100k, {chunks} chunk(s): launches B3 {counts[0]} (expected "
            f"{fwd}), B4 {counts[1]}, B5 {counts[2]} (expected {train} each), B6 {counts[3]}")
        if counts != [fwd, train, train, 0]:
            raise AssertionError(f"ContConv launches {counts} with {chunks} chunk(s)")
        _large_step_numbers([*conv, "--conv-node-chunks", str(chunks)],
                            os.path.join(data + "100k", "train"),
                            f"ContConv N=100k, batch 1, {chunks} node chunk(s)", snaps)
    return total


def phase10_knn_recall():
    from nbody_tpu_torch.experiments import knn_recall

    rows = knn_recall.main(["--n-bodies", str(LARGE_N), "--windows", "64", "--kernel-blocks",
                            "256", "--device", "cuda"])
    for r in rows:
        log(f"[10f] knn_recall {r['profile']} N={r['n']} k={r['k']} {r['method']}: "
            f"{1e3 * r['seconds']:.4f} ms, recall {r['recall']:.5f}")
    kernel = [r for r in rows if r["method"].startswith("morton-kernel")]
    if len(rows) != 6 or len(kernel) != 2 or min(r["recall"] for r in kernel) < RECALL:
        raise AssertionError(f"knn_recall: {rows}")


def main() -> int:
    card = phase0_device()
    import torch

    from nbody_tpu_torch.ops import pairwise as pw

    big = phase1_kernels()
    slice2 = phase5_large_n_kernels()
    slice3 = phase7_backward_kernels()
    slice4 = phase9_kernels()
    phase9_engines()
    slice5 = phase10_kernel()

    # the position-gradient path: B6's launches are counted here
    zero_counts()
    launches = {"b6": phase7_model_gradients()}

    # the datagen and GNN-eval path: every launch counter starts at 0 here
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_dir = os.path.join(tmp, "test")
        os.makedirs(data_dir)
        phase2_datagen(data_dir)
        traj = phase3_real_size()
        exact_20k_ms = phase4_surrogate(data_dir, traj)
    launches.update(b1=pw.partial_accelerations.launches, b2=pw.pair_potential.launches)
    torch.cuda.synchronize()

    # the large-N surrogate path: counters at 0 again
    zero_counts()
    phase6_large_n_path(exact_20k_ms)
    torch.cuda.synchronize()
    large = read_counts()
    log(f"[6] launches on the large-N path: {large}")
    launches.update({k: large[k] for k in ("b3", "b7", "b8")})
    if large["b1"] == 0:
        raise AssertionError(f"the large-N path never launched B1: {large}")

    # the training path: counters at 0 again
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        phase8_training(tmp)
    torch.cuda.synchronize()
    train = read_counts()
    log(f"[8] launches on the training path: {train}")
    launches.update({k: train[k] for k in ("b4", "b5")})
    if min(train[k] for k in ("b1", "b3", "b4", "b5", "b7", "b8")) == 0 or train["b6"] != 0:
        raise AssertionError(f"training path launches {train}: B6 must stay at 0, the "
                             f"others above it")

    # the treecode path: counters at 0 again
    zero_counts()
    phase9_rollouts()
    torch.cuda.synchronize()
    tree = read_counts()
    log(f"[9c] launches on the treecode path: {tree}")
    launches.update({k: tree[k] for k in ("b9", "b10", "b1n")})
    if min(tree[k] for k in ("b1", "b2", "b9", "b10", "b1n")) == 0:
        raise AssertionError(f"the treecode path never launched a kernel of its own: {tree}")
    phase9_bench()

    # B11 on the crossover path's own data: its launches are counted here
    zero_counts()
    launches["b11"] = phase10_path_data()
    phase10_fused_forward()

    # the large-N entry points' path: each main starts with the counters at
    # 0 and is read, and held to its kernels, right after it returns
    with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as tmp:
        large_n = phase10_crossover(tmp)
        for name, c in phase10_train_large(tmp).items():
            large_n[name] += c
    torch.cuda.synchronize()
    log(f"[10] launches of the large-N entry points' mains together: {large_n}")
    phase10_knn_recall()
    if min(launches.values()) == 0 or len(launches) != len(kernel_wrappers()):
        raise AssertionError(f"a kernel of a path never launched: {launches}")
    if any(m.split(".")[0] in ("jax", "flax", "nbody_tpu") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    def entry(name, source, replaces, key, numbers):
        # no one PyTorch call computes any of these functions: library_ms null
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": numbers[0], "ms": numbers[1],
                "plain_ms": numbers[2], "bound_ms": numbers[3][0],
                "bound_by": numbers[3][1], "library_ms": None}

    pair_src = "nbody_tpu_torch/csrc/pairwise.cu"
    spatial_src = "nbody_tpu_torch/csrc/spatial.cu"
    conv_src = "nbody_tpu_torch/csrc/contconv.cu"
    conv_py = "nbody_tpu/ops/contconv_kernel.py"
    tree_src = "nbody_tpu_torch/csrc/treeforce.cu"
    kernels = [
        entry("B1 force (nbody_force)", pair_src, "nbody_tpu/ops/pairwise.py:50", "b1",
              big["b1"]),
        entry("B2 energy (nbody_energy)", pair_src, "nbody_tpu/ops/pairwise.py:113", "b2",
              big["b2"]),
        entry("B3 collect (contconv_collect)", conv_src, f"{conv_py}:105", "b3",
              slice2["b3"]),
        entry("B4 filter grad (contconv_bwd_filters)", conv_src, f"{conv_py}:129", "b4",
              slice3["b4"]),
        entry("B5 feature grad (contconv_bwd_feat)", conv_src, f"{conv_py}:162", "b5",
              slice3["b5"]),
        entry("B6 geometry grad (contconv_bwd_geom)", conv_src, f"{conv_py}:196", "b6",
              slice3["b6"]),
        entry("B7 select (morton_select)", spatial_src, "nbody_tpu/ops/spatial.py:272",
              "b7", slice2["b7"]),
        entry("B8 merge (morton_merge)", spatial_src, "nbody_tpu/ops/spatial.py:311",
              "b8", slice2["b8"]),
        entry("B9 far field (multipole_acc)", tree_src, "nbody_tpu/ops/treeforce.py:259",
              "b9", slice4["b9"]),
        entry("B10 grouped multipoles (grouped_multipole_acc)", tree_src,
              "nbody_tpu/ops/treeforce.py:566", "b10", slice4["b10"]),
        entry("B1 near list (nbody_near_force)", pair_src, "nbody_tpu/ops/pairwise.py:50",
              "b1n", slice4["b1n"]),
        entry("B11 windowed EdgeConv sum (edgeconv_windowed_tanh_sum)",
              "nbody_tpu_torch/csrc/edgeconv.cu", "attic/edgeconv_kernel.py:88", "b11",
              slice5),
    ]
    assert all(math.isfinite(k[f]) for k in kernels
               for f in ("max_abs_err", "ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
