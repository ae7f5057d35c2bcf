"""What the predict-zero baseline and the stepwise error of the 1M
``train_large`` eval owe to the realisation of the initial conditions and
to the ``bh`` treecode's targets.

Both readings are RMS values over every body, so a few bodies with large
accelerations, or with large errors in their targets, move them. Both
packages draw their ICs from ``jax.random``'s keyed streams (the port
through ``utils.prng``), so a seed gives both the same galaxy; ``--jax``
carries the JAX package's own arrays across, which differ from the port's
by float32 rounding. This script reads, at step 0 of each scene, with the
exact direct sum (B1 on the card) as the targets:

- ``baseline``: 1e6 x the RMS of the exact accelerations (the predict-zero
  baseline of ``train_large``'s eval, on one snapshot);
- ``top_share``: the share of the sum of squared accelerations held by the
  0.1 % of bodies with the largest;
- ``stepwise``: 1e6 x the RMS error of a ``train_large``-shaped GNN with
  the given weights (default the committed JAX 1M weights) against them;
- ``bh_rms``: 1e6 x the RMS error of the ``bh`` treecode at
  ``train_large``'s knobs (M = 48, B = 256), which made the training
  targets, against the exact sum, its median relative error, and the three
  bodies it misses most (id, 1e6 x error, 1e6 x exact |a|);
- ``jax_bh_*``: the same of JAX's own ``bh`` (``--jax-bh``, computed on
  the CPU with JAX), and 1e6 x the RMS of its difference from the port's.

Two steps. On a CPU with JAX, write JAX's realisations::

    JAX_PLATFORMS=cpu python scripts/ic_realizations.py --dump-jax ICS.npz \\
        --n-bodies 1000000 --seeds 42 43 1042 [--jax-bh]

then on the card (no JAX needed)::

    python scripts/ic_realizations.py --jax ICS.npz --n-bodies 1000000 \\
        --seeds 42 43 1042 1043 1044 1045 --out rows.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
G, EPS = 4.5e-6, 0.05


def dump_jax(path: str, n: int, seeds, bh: bool = False) -> None:
    """JAX's spiral ICs of ``train_large``'s scenes (positions and masses)
    and, with ``bh``, JAX's own ``bh`` accelerations of them at
    ``train_large``'s knobs (``near_impl="xla"``, the CPU's path)."""
    from nbody_tpu.data.generate import ScenarioConfig, make_initial_conditions
    from nbody_tpu.ops.treeforce import bh_accelerations

    out = {}
    for s in seeds:
        pos, _, mass = make_initial_conditions(ScenarioConfig(
            n_bodies=n, sim_type="spiral", seed=s, softening=EPS, g=G))
        out[f"pos_{s}"] = np.asarray(pos, np.float32)
        out[f"mass_{s}"] = np.asarray(mass, np.float32)
        if bh:
            out[f"bh_{s}"] = np.asarray(bh_accelerations(
                pos, mass, G, EPS, n_near=48, block=256, near_impl="xla"), np.float32)
    np.savez(path, **out)
    print(f"wrote {path}: JAX's ICs{' and bh forces' if bh else ''} of seeds "
          f"{list(seeds)} at N={n}")


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, default=1_000_000)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 1042])
    p.add_argument("--dump-jax", metavar="NPZ", default=None)
    p.add_argument("--jax-bh", action="store_true",
                   help="with --dump-jax: JAX's bh accelerations of each scene too")
    p.add_argument("--jax", metavar="NPZ", default=None,
                   help="JAX's realisations written by --dump-jax")
    p.add_argument("--weights", default=os.path.join(
        ROOT, "results", "large_scale", "train_1m_params.pt"))
    p.add_argument("--neighbors", type=int, default=8)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    if args.dump_jax:
        dump_jax(args.dump_jax, args.n_bodies, args.seeds, args.jax_bh)
        return []

    import torch

    from nbody_tpu_torch.data.generate import ScenarioConfig, make_initial_conditions
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.ops.pairwise import accelerations
    from nbody_tpu_torch.ops.treeforce import bh_accelerations
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    impl = "kernel" if dev.type == "cuda" else "dense"
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=args.neighbors, scale_factor=1e6, knn_method="morton",
                       knn_impl=impl, fused_edgeconv=True, output_scale=1e6).to(dev)
    model.load_state_dict(torch.load(args.weights, map_location=dev, weights_only=True))
    model.eval()

    def rms(a):
        return float(1e6 * torch.sqrt((a.double() ** 2).mean()))

    def bh_error(r, key, bh, a):
        err = (bh - a).norm(dim=1)
        r[f"{key}_rms"] = rms(bh - a)
        r[f"{key}_median_rel_err"] = float((err / a.norm(dim=1).clamp_min(1e-30)).median())
        # the bodies whose bh force is farthest off, and their exact field
        worst = torch.topk(err, 3).indices
        r[f"{key}_worst"] = [[int(i), 1e6 * float(err[i]), 1e6 * float(a[i].norm())]
                             for i in worst]

    def row(source, seed, pos, mass, vel=None, jax_bh=None):
        pos = pos.to(dev, torch.float32)
        mass = mass.to(dev, torch.float32)
        a = accelerations(pos, mass, G, EPS)
        sq = (a.double() ** 2).sum(1)
        top = torch.topk(sq, max(1, pos.shape[0] // 1000)).values.sum() / sq.sum()
        # train_large's input features: [pos | vel | mass]; input_dim 4 reads pos and mass
        x = torch.cat([pos, torch.zeros_like(pos) if vel is None else vel.to(dev), mass[:, None]],
                      -1)[None]
        with torch.no_grad():
            idx, valid = build_graph(model.graph_spec, x[..., :3])
            pred = model(x, idx, valid)[0]
        r = {"source": source, "seed": seed, "n": pos.shape[0], "baseline": rms(a),
             "top_share": float(top), "stepwise": rms(pred - a)}
        bh = bh_accelerations(pos, mass, G, EPS, n_near=48, block=256)
        bh_error(r, "bh", bh, a)
        if jax_bh is not None:  # JAX's own bh on these arrays, against the same sum
            jax_bh = jax_bh.to(dev, torch.float32)
            bh_error(r, "jax_bh", jax_bh, a)
            r["jax_bh_vs_port_bh_rms"] = rms(jax_bh - bh)
        print(json.dumps(r), flush=True)
        return r

    rows = []
    for s in args.seeds:
        pos, vel, mass = make_initial_conditions(ScenarioConfig(
            n_bodies=args.n_bodies, sim_type="spiral", seed=s, softening=EPS, g=G), device=dev)
        rows.append(row("port", s, pos, mass, vel))
    if args.jax:
        ics = np.load(args.jax)
        for s in args.seeds:
            if f"pos_{s}" in ics:
                jax_bh = torch.from_numpy(ics[f"bh_{s}"]) if f"bh_{s}" in ics else None
                rows.append(row("jax", s, torch.from_numpy(ics[f"pos_{s}"]),
                                torch.from_numpy(ics[f"mass_{s}"]), jax_bh=jax_bh))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu", "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
