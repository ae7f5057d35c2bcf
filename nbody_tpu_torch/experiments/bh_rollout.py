"""Long-horizon treecode rollout with an exact energy audit — the port of
``nbody_tpu/experiments/bh_rollout.py`` (``results/large_scale/bh_rollout*.json``).

A spiral galaxy rolled out with the leapfrog integrator on a treecode force
engine (``--engine bh|bh2|bh3``), audited at its two ends by the exact
pairwise potential (B2 on the card) or, with ``--no-energy-audit``, by a
sampled force audit: ``--error-sample`` receivers against all sources
through B1.

Usage::

    python -m nbody_tpu_torch.experiments.bh_rollout --n-bodies 100000 \\
        --steps 1000 --out results/bh_rollout.json
    python -m nbody_tpu_torch.experiments.bh_rollout --engine bh3 \\
        --n-bodies 1000000 --block 128 --rc 48 --n-sub 48 --steps 16 \\
        --chunk-steps 8 --no-energy-audit

The JAX script's flags, plus ``--device`` (default cuda; the CPU only as
``--device cpu``) and ``--profile``. Prints one JSON line with the JAX
script's keys, unrounded, plus ``device_kind`` (the card's name). Wall time
is a synchronised host timer around the rollout, after a one-step warm-up.
``--profile`` runs one more segment (``--chunk-steps`` steps, else
``--steps``) twice, timed and under ``torch.profiler``, and adds its busy
seconds (kernel rows only on the card), idle share ``1 - busy / wall`` and
largest rows, as ``large_scale.py --profile`` does.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nbody_tpu_torch.core.forces import kinetic_energy
from nbody_tpu_torch.core.simulate import SimulationConfig, simulate, treecode_fns
from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import pairwise
from nbody_tpu_torch.utils.timing import device_time, profile_ms

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-bodies", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--bh-near", type=int, default=32)
    p.add_argument("--block", type=int, default=256,
                   help="fine Morton block size (128 is the 1M bh2/bh3 recipe)")
    p.add_argument("--bh-refresh", type=int, default=8)
    p.add_argument("--engine", default="bh", choices=["bh", "bh2", "bh3"],
                   help="bh2 = two-level coarse far field; bh3 = bh2 with the "
                        "sub-refined near pass")
    p.add_argument("--coarse", type=int, default=16)
    p.add_argument("--rc", type=int, default=32)
    p.add_argument("--sub-block", type=int, default=32,
                   help="bh3: rows per near-pass sub-block")
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: sub-blocks evaluated exactly per receiver block")
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="run the rollout as ceil(steps/chunk) sequential segments "
                        "carrying only the end state (the stacked (steps, N, 3) "
                        "trajectory of 1M bodies x 1000 steps would be 36 GB)")
    p.add_argument("--no-energy-audit", action="store_true",
                   help="skip the exact O(N^2) endpoint energy audit; report a "
                        "sampled endpoint force error instead")
    p.add_argument("--chunked-energy-audit", type=int, default=0, metavar="ROWS",
                   help="compute the exact endpoint PE in ~ROWS-row block-triangle "
                        "chunks (ops.pairwise.chunked_potential_energy)")
    p.add_argument("--error-sample", type=int, default=4096,
                   help="receivers of the sampled endpoint force audit "
                        "(--no-energy-audit)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--profile", action="store_true",
                   help="time and profile one more segment and add its busy "
                        "seconds, idle share and largest rows to the line")
    p.add_argument("--out", default=None)
    return p


def profile_segment(pos, vel, mass, steps: int, cfg, dev) -> dict:
    """Busy seconds, idle share and largest rows of one ``steps``-step
    segment: timed once, then run again under the profiler."""
    def run():
        simulate(pos, vel, mass, steps, cfg)

    _, wall = device_time(run, dev)
    busy_ms, top = profile_ms(run, dev)
    return {"profile_steps": steps, "profile_wall_s": wall, "busy_seconds": busy_ms / 1e3,
            "idle_share": 1.0 - busy_ms / 1e3 / wall, "top_ms": [[k, ms] for k, ms in top]}


def engine_config(args) -> SimulationConfig:
    return SimulationConfig(
        g_const=G, softening=EPS, dt=DT, integrator="leapfrog", calc_energy=False,
        force_backend=args.engine, bh_near=args.bh_near, bh_block=args.block,
        bh_refresh=args.bh_refresh, bh_coarse=args.coarse, bh_rc=args.rc,
        bh_sub_block=args.sub_block, bh_n_sub=args.n_sub)


def sampled_force_error(pos, mass, cfg: SimulationConfig, sample: int) -> dict:
    """Median and p99 relative force error of the engine (fresh partition)
    over ``sample`` receivers, against the exact sum over all sources (B1;
    a self-pair adds an exact zero)."""
    n = pos.shape[0]
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(42))[:sample]
    idx = idx.to(pos.device)
    exact = pairwise.partial_accelerations(pos[idx].contiguous(), pos, mass, G, EPS)
    build, acc = treecode_fns(mass, cfg)
    approx = acc(pos, build(pos))[idx]
    rel = (approx - exact).norm(dim=-1) / (exact.norm(dim=-1) + 1e-30)
    return {"error_sample": int(idx.shape[0]),
            "end_rel_err_median": float(rel.median()),
            "end_rel_err_p99": float(torch.quantile(rel.double(), 0.99))}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), args.n_bodies,
                                     device=dev)
    cfg = engine_config(args)
    if dev.type == "cuda":
        from nbody_tpu_torch.ops.treeforce import load_kernels

        load_kernels()

    def exact_energy(p_, v_):
        if args.no_energy_audit:
            return 0.0, 0.0
        if args.chunked_energy_audit:
            u = pairwise.chunked_potential_energy(p_, mass, G, EPS,
                                                  chunk=args.chunked_energy_audit)
        else:
            u = float(pairwise.potential_energy(p_, mass, G, EPS))
        return u, float(kinetic_energy(v_, mass))

    u0, k0 = exact_energy(pos, vel)
    simulate(pos, vel, mass, 1, cfg)  # warm-up: allocator, library handles
    if args.chunk_steps:
        n_chunks = -(-args.steps // args.chunk_steps)

        def rollout():
            p_, v_ = pos, vel
            for _ in range(n_chunks):
                t = simulate(p_, v_, mass, args.chunk_steps, cfg)
                p_, v_ = t.positions[-1].clone(), t.velocities[-1].clone()
                del t
            return p_, v_

        (p_end, v_end), elapsed = device_time(rollout, dev)
        args.steps = n_chunks * args.chunk_steps
    else:
        traj, elapsed = device_time(lambda: simulate(pos, vel, mass, args.steps, cfg), dev)
        p_end, v_end = traj.positions[-1].clone(), traj.velocities[-1].clone()
        del traj
    u1, k1 = exact_energy(p_end, v_end)
    e0, e1 = u0 + k0, u1 + k1
    audit = (sampled_force_error(p_end, mass, cfg, args.error_sample)
             if args.no_energy_audit else
             {"E0": e0, "E1": e1, "rel_energy_drift": abs(e1 - e0) / abs(e0)})
    if args.profile:
        audit.update(profile_segment(p_end, v_end, mass, args.chunk_steps or args.steps,
                                     cfg, dev))
    row = {
        "n": args.n_bodies, "steps": args.steps, "dt": DT, "engine": args.engine,
        "bh_near": args.bh_near, "block": args.block, "bh_refresh": args.bh_refresh,
        **({"coarse": args.coarse, "rc": args.rc}
           if args.engine in ("bh2", "bh3") else {}),
        **({"sub_block": args.sub_block, "n_sub": args.n_sub}
           if args.engine == "bh3" else {}),
        **({"chunked_energy_audit": args.chunked_energy_audit}
           if args.chunked_energy_audit else {}),
        **({"chunk_steps": args.chunk_steps} if args.chunk_steps else {}),
        "wall_s": elapsed,
        "ms_per_step": elapsed / args.steps * 1e3,
        "psteps_per_s": args.n_bodies * args.steps / elapsed,
        **audit,
        "device": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"wrote {args.out}")
    return row


if __name__ == "__main__":
    main()
