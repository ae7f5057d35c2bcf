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
   a 50-step rollout at 20,000 bodies.

Every phase raises on failure, so the exit code is non-zero and no result
line is printed. Informative lines come first. The last three lines are a
JSON object with one entry per kernel (launches counted over phases 2-4,
errors and times from phase 1 at 20,000 bodies), the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``. Without CUDA,
or without the package beside this script, it exits non-zero.
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
RECIPE_STEPS = 1000
BIG_N, BIG_STEPS, SURR_STEPS = 20_000, 200, 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_drift(u, k) -> float:
    import numpy as np

    e = np.asarray(u, np.float64) + np.asarray(k, np.float64)
    return float(np.abs(e - e[0]).max() / abs(e[0]))


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA required (torch.cuda.is_available() "
                         "is False); the port has no CPU fallback for this run")
    sys.path.insert(0, HERE)
    from nbody_tpu_torch.ops import build, pairwise  # fails when run alone

    card = card_line()
    log(f"[0] card: {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on"
    t0 = time.perf_counter()
    pairwise.load_kernels()
    info = build.BUILD_INFO["pairwise"]
    log(f"[0] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s)")
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
        results[n] = dict(b1=(d_acc, ms_k, ms_t), b2=(d_u, ms_uk, ms_ut))

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


def main() -> int:
    card = phase0_device()
    import torch

    from nbody_tpu_torch.ops import pairwise as pw

    big = phase1_kernels()

    # the main path: every launch counter starts at 0 here
    pw.partial_accelerations.launches = 0
    pw.pair_potential.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_dir = os.path.join(tmp, "test")
        os.makedirs(data_dir)
        phase2_datagen(data_dir)
        traj = phase3_real_size()
        phase4_surrogate(data_dir, traj)
    launches = {"b1": pw.partial_accelerations.launches,
                "b2": pw.pair_potential.launches}
    torch.cuda.synchronize()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if any(m.split(".")[0] in ("jax", "flax", "nbody_tpu") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    src = "nbody_tpu_torch/csrc/pairwise.cu"
    kernels = [
        {"name": "B1 force (nbody_force)", "route": "cuda", "source": src,
         "replaces": "nbody_tpu/ops/pairwise.py:50", "launches": launches["b1"],
         "max_abs_err": big["b1"][0], "ms": big["b1"][1], "plain_ms": big["b1"][2]},
        {"name": "B2 energy (nbody_energy)", "route": "cuda", "source": src,
         "replaces": "nbody_tpu/ops/pairwise.py:113", "launches": launches["b2"],
         "max_abs_err": big["b2"][0], "ms": big["b2"][1], "plain_ms": big["b2"][2]},
    ]
    assert all(math.isfinite(k[f]) for k in kernels
               for f in ("max_abs_err", "ms", "plain_ms"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
