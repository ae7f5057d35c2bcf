"""Trajectory datagen CLI — the port of ``nbody_tpu/cli/datagen.py``, with
the same flags (list-valued flags fan out via cartesian product).

    python -m nbody_tpu_torch.cli.datagen --integrator leapfrog \
        --n-bodies 3 25 50 100 250 500 --output out.csv \
        --steps 1000 --sim-type spiral --n-arms 2 --seed 42

``--device`` picks where the rollouts run: by default the CUDA device, and
without one the CLI raises unless ``--device cpu`` asks for the CPU.
``--force-backend auto`` runs the hand-written kernels on a CUDA device and
the dense torch path on the CPU; ``bh`` is the one-level treecode (B9, B10
and B1's near-list form on the card), as the JAX CLI offers it.
"""

from __future__ import annotations

import argparse
import math

from nbody_tpu_torch.data.generate import generate_dataset, scenario_product
from nbody_tpu_torch.experiments.common import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Galaxy N-body trajectory dataset generation")
    p.add_argument("--n-bodies", type=int, nargs="+", required=True)
    p.add_argument("--integrator", type=str, default="leapfrog",
                   choices=["leapfrog", "euler"])
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--sim-type", type=str, nargs="+",
                   choices=["disk", "spiral"], default=["disk"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dt", type=float, default=0.0001)
    p.add_argument("--softening", type=float, default=0.05)
    p.add_argument("--g", type=float, default=4.5e-6)
    p.add_argument("--total-mass", type=float, default=1.0)
    p.add_argument("--radial-scale", type=float, default=3.0)
    p.add_argument("--height-scale", type=float, default=0.3)
    p.add_argument("--black-hole-mass", type=float, default=0.01)
    p.add_argument("--n-arms", type=int, default=2)
    p.add_argument("--pitch-angle", type=float, default=-math.pi / 6)
    p.add_argument("--arm-strength", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the rollouts (default: cuda; the CPU "
                        "only as --device cpu)")
    p.add_argument("--force-backend", type=str, default="auto",
                   choices=["auto", "dense", "kernel", "bh"])
    p.add_argument("--no-npz", action="store_true",
                   help="skip the fast-reload .npz twin")
    p.add_argument("--npz-only", action="store_true",
                   help="skip the long-format CSV")
    p.add_argument("--snapshot-stride", type=int, default=1,
                   help="record every this-many-th step (incl. step 0; the "
                        "step column keeps original indices)")
    p.add_argument("--time-chunks", type=int, default=1,
                   help=">1: record per-chunk wall times in the step_time "
                        "column instead of the uniform rollout mean")
    p.add_argument("--no-energy", action="store_true",
                   help="skip the exact O(N^2) per-snapshot energy columns "
                        "(u, k become NaN)")
    p.add_argument("--check", action="store_true",
                   help="raise on a non-finite trajectory")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler chrome trace of the "
                        "generation into DIR")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    scenarios = scenario_product(
        n_bodies=args.n_bodies,
        integrator=args.integrator,
        sim_type=args.sim_type,
        steps=args.steps,
        dt=args.dt,
        softening=args.softening,
        g=args.g,
        total_mass=args.total_mass,
        radial_scale=args.radial_scale,
        height_scale=args.height_scale,
        black_hole_mass=args.black_hole_mass,
        n_arms=args.n_arms,
        pitch_angle=args.pitch_angle,
        arm_strength=args.arm_strength,
        seed=args.seed,
        force_backend=args.force_backend,
        calc_energy=not args.no_energy,
    )
    print(f"Generating {len(scenarios)} scenarios on {device} -> {args.output}")

    def run():
        generate_dataset(
            scenarios, args.output, write_npz=not args.no_npz,
            time_chunks=args.time_chunks, check=args.check,
            snapshot_stride=args.snapshot_stride,
            write_csv_file=not args.npz_only, device=device)

    if args.profile:
        from nbody_tpu_torch.utils.profiling import trace_profile

        with trace_profile(args.profile):
            run()
        print(f"profiler trace written to {args.profile}")
    else:
        run()
    print("done")


if __name__ == "__main__":
    main()
