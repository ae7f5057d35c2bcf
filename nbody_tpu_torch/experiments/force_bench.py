"""Times B1 (the direct-sum force, ``ops.pairwise.partial_accelerations``) at
given target x source shapes and holds it to the float64 sum, B2 (the
pairwise potential, ``ops.pairwise.pair_potential``) and the chunked exact
energy, and the recipe datagen's rollout step, which launches B1 once a
step and B2 once a step with energies:

    python -m nbody_tpu_torch.experiments.force_bench --shapes 20000 100000 4096x1000000
    python -m nbody_tpu_torch.experiments.force_bench --shapes 100000 --softening 0.05 1e-10
    python -m nbody_tpu_torch.experiments.force_bench --shapes --datagen 3 25 50 100 250 500
    python -m nbody_tpu_torch.experiments.force_bench --shapes --energy 500 20000 3000x5000 \
        --chunked 1000000:200000

It is the tool for A/B runs of B1 and B2: run it from two checkouts on one
card in one session, in the order A, B, B, A. It uses only the wrappers,
their launch counts, ``data.generate.run_scenario`` and ``utils.timing``,
so a copy of this file and of ``utils/timing.py`` placed in an older
checkout times that one.

A shape ``N`` takes N spiral bodies as targets and sources; ``TxN`` takes T
of N bodies (a seeded random choice) as targets. Per shape and softening it
prints one JSON row: the sizes, the source chunks B1 splits into
(``ops.pairwise.force_chunk``), milliseconds (CUDA events, the mean of
``--reps`` calls after a warm-up), the least time an H100 could take
(``bound_ms``, ``ops.pairwise.force_work`` at ``utils.timing``'s peaks),
the largest |a - a64| / max |a64| on ``--check-rows`` sampled targets
against the plain version run in float64, and whether two calls give the
same bits. A softening whose square is under 1e-18 takes the kernel's
variant that applies the 1e-18 distance floor; 0.05 (the recipe's) leaves
it out. Per ``--datagen`` size it prints the rollout's ms/step (the recipe
scene: spiral, seed 42, energies on, ``--steps`` steps, file writes left
out) and B1's and B2's launches a step. Per ``--energy`` shape (``N``: the
masked potential of N spiral bodies; ``AxB``: the cross potential of the
first A and the next B) it prints the milliseconds a call (CUDA events, the
host's share included), the device milliseconds and CUDA kernels a call
(``torch.profiler``), B2's launches a call, the relative error against the
plain version (up to 20,000 bodies), whether five calls give one value, and
the bound (~13 operations a pair). Per ``--chunked N:CHUNK`` it prints the
host-timed seconds of ``chunked_potential_energy`` (one synchronised
float per launch) and its value. On the CPU (``--device cpu``) the plain
versions run, timed on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.ops import pairwise
from nbody_tpu_torch.utils import timing

G, EPS = 4.5e-6, 0.05


def parse_shape(text: str):
    """``"N"`` -> (N, N); ``"TxN"`` -> (T, N)."""
    t, _, n = text.partition("x")
    return (int(t), int(n or t))


def bench(ni: int, nj: int, eps: float, dev: torch.device, reps: int,
          check_rows: int) -> dict:
    """One row for ``ni`` targets among ``nj`` spiral bodies at softening
    ``eps``."""
    pos, _, mass = generate_spiral(torch.Generator().manual_seed(nj), nj, device=dev)
    gen = torch.Generator().manual_seed(ni)
    tgt = pos if ni == nj else pos[torch.randperm(nj, generator=gen)[:ni].to(dev)]
    cuda = dev.type == "cuda"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if cuda else 132

    def call():
        return pairwise.partial_accelerations(tgt, pos, mass, G, eps)

    acc = call()
    same = torch.equal(acc, call())
    rows = torch.randperm(ni, generator=gen)[:check_rows].to(dev)
    p64, m64, q64 = pos.double(), mass.double(), tgt[rows].double()
    want = torch.cat([pairwise.partial_accelerations_torch(q, p64, m64, G, eps)
                      for q in q64.split(128)])
    err = float((acc[rows].double() - want).abs().max()) / float(want.abs().max())
    if cuda:
        ms = timing.cuda_time_ms(call, reps=reps, warmup=1)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        ms = 1e3 * (time.perf_counter() - t0) / reps
    chunk = pairwise.force_chunk(ni, nj, sms)
    bnd = timing.bound_ms(*pairwise.force_work(ni, nj))
    return {"targets": ni, "sources": nj, "softening": eps, "device": str(dev),
            "chunks": -(-nj // chunk), "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "rel_err_vs_float64": err, "check_rows": int(rows.numel()),
            "same_bits_twice": same}


def datagen_step(n: int, steps: int, dev: torch.device) -> dict:
    """The recipe datagen's rollout of one ``n``-body scene: ms/step and B1's
    and B2's launches a step."""
    from nbody_tpu_torch.data.generate import run_scenario, scenario_product

    (cfg,) = scenario_product(n_bodies=n, sim_type="spiral", steps=steps, seed=42,
                              force_backend="kernel" if dev.type == "cuda" else "dense")
    b1, b2 = pairwise.partial_accelerations.launches, pairwise.pair_potential.launches
    _, _, step_time = run_scenario(cfg, device=dev)
    return {"datagen_n": n, "steps": steps, "device": str(dev), "ms_per_step": 1e3 * step_time,
            "b1_launches_per_step": (pairwise.partial_accelerations.launches - b1) / steps,
            "b2_launches_per_step": (pairwise.pair_potential.launches - b2) / steps}


def energy_row(text: str, dev: torch.device, reps: int) -> dict:
    """B2 on ``N`` spiral bodies (masked) or the first A and next B of A + B
    (cross, ``AxB``)."""
    a, _, b = text.partition("x")
    ni, nj = int(a), int(b or 0)
    pos, _, mass = generate_spiral(torch.Generator().manual_seed(ni + nj), ni + nj, device=dev)
    masked = nj == 0
    if masked:
        args = (pos, mass, pos, mass)
        pairs, nbytes = ni * (ni - 1) / 2, 16.0 * ni + 4
    else:
        args = (pos[:ni].contiguous(), mass[:ni].contiguous(), pos[ni:].contiguous(),
                mass[ni:].contiguous())
        pairs, nbytes = float(ni) * nj, 16.0 * (ni + nj) + 4

    def call():
        return pairwise.pair_potential(*args, G, EPS, masked)

    before = pairwise.pair_potential.launches
    u = call()
    launches = pairwise.pair_potential.launches - before
    values = {float(call()) for _ in range(5)}
    row = {"energy_targets": ni, "energy_sources": nj or ni, "masked": masked,
           "device": str(dev), "u": float(u), "b2_launches_per_call": launches,
           "one_value_in_5_calls": len(values) == 1}
    if ni + nj <= 20_000:
        want = float(pairwise.pair_potential_torch(*args, G, EPS, masked))
        row["rel_err_vs_plain"] = abs(float(u) - want) / abs(want)
    bnd = timing.bound_ms(13.0 * pairs, nbytes)
    row.update(bound_ms=bnd[0], bound_by=bnd[1])
    if dev.type == "cuda":
        row["ms"] = timing.cuda_time_ms(call, reps=reps, warmup=1)
        events = timing.kernel_events(call, reps=reps)
        # a call's device ms: the mean event times the whole kernels a call
        per_call = max(1, round(len(events) / reps))
        row["device_ms"] = per_call * sum(ms for _, ms in events) / max(len(events), 1)
        row["kernels_per_call"] = len(events) / reps
        row["kernel_names"] = sorted({name for name, _ in events})
    return row


def chunked_row(text: str, dev: torch.device) -> dict:
    """``chunked_potential_energy`` of N spiral bodies in CHUNK-row pieces,
    host-timed (it reads one float a launch)."""
    n, chunk = (int(v) for v in text.split(":"))
    pos, _, mass = generate_spiral(torch.Generator().manual_seed(n), n, device=dev)
    pairwise.chunked_potential_energy(pos[:2 * chunk], mass[:2 * chunk], G, EPS, chunk)
    before = pairwise.pair_potential.launches
    u, sec = timing.device_time(
        lambda: pairwise.chunked_potential_energy(pos, mass, G, EPS, chunk), dev)
    return {"chunked_n": n, "chunk": chunk, "device": str(dev), "u": u, "seconds": sec,
            "b2_launches": pairwise.pair_potential.launches - before}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", nargs="*", default=["20000", "100000", "4096x1000000"],
                   help="N (N targets and sources) or TxN (T of N bodies as targets)")
    p.add_argument("--softening", type=float, nargs="+", default=[EPS],
                   help="each shape runs at each of these, in this order")
    p.add_argument("--datagen", type=int, nargs="*", default=[],
                   help="body counts of recipe datagen scenes to time")
    p.add_argument("--steps", type=int, default=1000, help="steps of a datagen scene")
    p.add_argument("--energy", nargs="*", default=[],
                   help="B2 shapes: N (masked, one set) or AxB (cross, two sets)")
    p.add_argument("--chunked", nargs="*", default=[], metavar="N:CHUNK",
                   help="time chunked_potential_energy of N bodies in CHUNK-row pieces")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--check-rows", type=int, default=512)
    p.add_argument("--device", default=None, help="default cuda; cpu only when given")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for text in args.shapes:
        ni, nj = parse_shape(text)
        for eps in args.softening:
            rows.append(bench(ni, nj, eps, dev, args.reps, args.check_rows))
            print(json.dumps(rows[-1]), flush=True)
    for text in args.energy:
        rows.append(energy_row(text, dev, args.reps))
        print(json.dumps(rows[-1]), flush=True)
    for text in args.chunked:
        rows.append(chunked_row(text, dev))
        print(json.dumps(rows[-1]), flush=True)
    for n in args.datagen:
        rows.append(datagen_step(n, args.steps, dev))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
